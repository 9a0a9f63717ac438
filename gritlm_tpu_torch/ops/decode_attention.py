"""K3: flash decode, hand-written for Hopper.

Replaces the Pallas kernel `_kernel` of `gritlm_tpu/ops/decode_attention.py`
(reached through `_decode_call` and `flash_decode`). Same function:
few-query attention (every decode step, and prefills shorter than 128
tokens) against layer `layer` of the full `[L, B, Smax, Kv*Dh]` cache, read
in place; slot validity from the `[B, Smax]` mask (padding and interior
holes); causality against the write `offset`; a sliding-window lower bound
(applied whenever given, as in the JAX kernel); GQA with the group's shared
K/V read once; a bf16 cache, or an int8 cache with bf16 slot-minor scales
`[L, B, Kv, Smax]` dequantized inside the kernel (K on the scores, V
through the probabilities, as in the JAX kernel).

Kernel: `csrc/decode_attention.cu`, CUDA C++ for sm_90a, bound with ctypes.
What bounds it: the bytes of the valid K/V slots; a decode step does about
one multiply-add per cache byte read. The TPU kernel ran one grid cell per
batch row; at B <= 4 that would leave most of the H100's SMs idle, so the
kernel splits the slots across warps (flash-decoding) and a second kernel
combines the partial (max, sum, output) of the splits. The split count is
worked out from the batch, head and SM counts. Per 32-slot tile a warp reads
the mask first and skips tiles with no valid slot, and copies only the valid
slots' rows (cp.async), so the bytes read follow the valid cache length, not
Smax; the causal bound and the window cut the slot range the same way.
Scores and P.V run on the CUDA cores in fp32 (the product is small at
Sq = 1). The int8 cache is the same kernel instantiated for int8 rows: it
halves the bytes a step reads.

Serving rows reach this kernel through the transformer's per-row path
(`forward(row_offsets=...)`): the step is S = 1, each row writes its K/V at
its own slot before attention, and the kernel runs mask-bounded (causal
False, offset 0, no window), since a row's mask covers exactly the slots it
has written. The split-KV pieces are shared with K8 (`csrc/split_decode.cuh`).

Differences from the TPU kernel: the `offset` is one Python int for all
rows; the per-row-offset variant for Sq > 1 (the speculative verify chunk)
is queued with the speculative slice. Dh must be 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops.flash_attention import HEAD_DIM, attend_plain, keep_mask

ROWS_PER_WARP = 4  # RW in csrc/decode_attention.cu
TILE = 32  # TK in csrc/decode_attention.cu
WARPS_PER_SM = 8  # split target: enough warps in flight to cover memory latency


def dequantize_layer(x, scale, layer, hkv, dtype) -> torch.Tensor:
    """Layer `layer` of an int8 cache [L, B, Smax, Kv*Dh] with slot-minor
    scales [L, B, Kv, Smax] -> [B, Smax, Kv, Dh] in `dtype`."""
    _, B, Smax, KD = x.shape
    xl = x[layer].reshape(B, Smax, hkv, KD // hkv).float()
    return (xl * scale[layer].transpose(1, 2)[..., None].float()).to(dtype)


def flash_decode_plain(q, k, v, padding_mask, *, causal, sliding_window=None, offset=0,
                       layer=0, num_kv_heads=None, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """The plain PyTorch version of K3 (same arguments as flash_decode)."""
    B, Sq, H, Dh = q.shape
    _, _, Smax, KD = k.shape
    hkv = num_kv_heads or KD // Dh
    if k_scale is not None:
        lk = dequantize_layer(k, k_scale, layer, hkv, torch.float32)
        lv = dequantize_layer(v, v_scale, layer, hkv, torch.float32)
    else:
        lk = k[layer].reshape(B, Smax, hkv, Dh)
        lv = v[layer].reshape(B, Smax, hkv, Dh)
    keep = keep_mask(padding_mask, Sq, Smax, causal=causal,
                     sliding_window=sliding_window, offset=offset, device=q.device)
    return attend_plain(q, lk, lv, keep)


def _fn():
    fn = _build.load("decode_attention").gritlm_flash_decode
    if fn.argtypes is None:
        P, I32, F32 = _build.P, _build.I32, _build.F32
        fn.argtypes = [P] * 9 + [I32] * 11 + [F32, P]
        fn.restype = I32
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, Sq: int, H: int, Hkv: int, Smax: int, sms: int):
    """(n_split, split_len, rows): enough warps to give each of `sms` SMs
    WARPS_PER_SM, each split a whole number of 32-slot tiles; rows = query
    rows per kv head, padded to whole warps."""
    rows = _cdiv(Sq * (H // Hkv), ROWS_PER_WARP) * ROWS_PER_WARP
    warps = B * Hkv * rows // ROWS_PER_WARP
    n_split = min(_cdiv(Smax, TILE), _cdiv(WARPS_PER_SM * sms, warps))
    split_len = _cdiv(_cdiv(Smax, n_split), TILE) * TILE
    return _cdiv(Smax, split_len), split_len, rows


def flash_decode(
    q: torch.Tensor,  # [B, Sq, H, Dh], Sq small
    k: torch.Tensor,  # [L, B, Smax, Hkv*Dh], the full cache
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],  # [B, Smax] slot validity; None = all
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: int = 0,
    layer: int = 0,
    num_kv_heads: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q against cache layer `layer`; with k_scale/v_scale
    [L, B, Kv, Smax] the cache is int8. CPU tensors run the plain version;
    CUDA tensors run the kernel or raise. Returns [B, Sq, H, Dh]."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("flash_decode: give both k_scale and v_scale, or neither")
    if _build.plain_path(q, k, v, padding_mask, k_scale, v_scale):
        return flash_decode_plain(q, k, v, padding_mask, causal=causal,
                                  sliding_window=sliding_window, offset=offset,
                                  layer=layer, num_kv_heads=num_kv_heads,
                                  k_scale=k_scale, v_scale=v_scale)
    fn = _fn()
    B, Sq, H, Dh = q.shape
    L, Bk, Smax, KD = k.shape
    hkv = num_kv_heads or KD // Dh
    cache_dtype = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != cache_dtype or v.dtype != cache_dtype:
        raise TypeError(f"flash_decode: q must be bfloat16 and the cache {cache_dtype}")
    if quant and not all(
            t.dtype == torch.bfloat16 and t.is_contiguous()
            and tuple(t.shape) == (L, B, hkv, Smax) for t in (k_scale, v_scale)):
        raise ValueError(f"flash_decode: scales must be contiguous bfloat16 {(L, B, hkv, Smax)}")
    if Dh != HEAD_DIM or hkv * Dh != KD or H % hkv:
        raise NotImplementedError(f"flash_decode: q {tuple(q.shape)} over cache {tuple(k.shape)}")
    if k.shape != v.shape or Bk != B:
        raise ValueError(f"flash_decode: cache k {tuple(k.shape)} v {tuple(v.shape)}, batch {B}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode: q and the cache must be contiguous")
    if not isinstance(offset, int) or not isinstance(layer, int) or not 0 <= layer < L:
        raise ValueError("flash_decode: offset and layer must be Python ints, 0 <= layer < L")
    if padding_mask is None:
        mask = torch.ones((B, Smax), dtype=torch.int32, device=q.device)
    else:
        if tuple(padding_mask.shape) != (B, Smax):
            raise ValueError(f"flash_decode: mask {tuple(padding_mask.shape)} != {(B, Smax)}")
        mask = padding_mask.to(torch.int32).contiguous()
    n_split, split_len, rows = split_plan(B, Sq, H, hkv, Smax, _build.sm_count(q.device))
    part_ml = torch.empty((n_split, B, hkv, rows, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((n_split, B, hkv, rows, Dh), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            mask.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), B, Sq, H, hkv, Smax, layer, n_split,
            split_len, int(causal), int(sliding_window or 0), offset, Dh ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
