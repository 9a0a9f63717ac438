"""K1: flash attention forward, hand-written for Hopper.

Replaces the Pallas kernels `_fwd_kernel` / `_fwd_kernel_single` of
`gritlm_tpu/ops/flash_attention.py` (reached through `_flash_fwd` and
`flash_attention`). Same function: online-softmax attention with fp32
accumulation; `causal` switches embed (bidirectional) and generate; a
`[B, Sk]` key mask; an absolute query `offset` for prefill on top of a cache;
a sliding window (a property of the causal mask, as in the JAX kernel); GQA
maps query head h to kv head h // group and K/V are never repeated; rows
whose every key is masked come out 0.

Kernel: `csrc/flash_attention.cu`, CUDA C++ for sm_90a, bound with ctypes.
What bounds it: at the encode and prefill shapes (S >= 64) its operations,
4*B*H*Sq*Sk*Dh of them in bf16 matrix products; K/V are read once per
(q-tile, head), well under the bytes bound. The design therefore puts both
products on the tensor cores (bf16 wmma with fp32 accumulation), keeps the
scores, probabilities and output rows in shared memory instead of device
memory, reads q/k/v through their strides (a cache layer `k_all[l]` is a
view, not a copy), skips causal tiles above the diagonal, tiles below the
sliding window and tiles holding no valid key, and copies K/V with cp.async.
It does not use wgmma/TMA yet.

Differences from the TPU kernel: any Sq runs the kernel (the TPU version
needed Sq >= 128 and sent shorter queries to an einsum); Dh must be 128
(64/96 raise NotImplementedError instead of being padded); bf16 only; the
backward pass (training) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from gritlm_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIM = 128


def keep_mask(
    padding_mask: Optional[torch.Tensor],  # [B, Sk]
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    sliding_window: Optional[int],
    offset: int,
    device,
) -> torch.Tensor:
    """Boolean [B or 1, Sq, Sk]: which (query, key) pairs attend. The window
    applies whenever it is given (callers drop it where it must not)."""
    keep = torch.ones((1, q_len, kv_len), dtype=torch.bool, device=device)
    if causal or sliding_window is not None:
        q_pos = offset + torch.arange(q_len, device=device)[:, None]
        k_pos = torch.arange(kv_len, device=device)[None, :]
        if causal:
            keep = keep & (k_pos <= q_pos)
        if sliding_window is not None:
            keep = keep & (k_pos > q_pos - sliding_window)
    if padding_mask is not None:
        keep = keep & (padding_mask != 0)[:, None, :]
    return keep


def attend_plain(q, k, v, keep) -> torch.Tensor:
    """fp32 masked softmax attention with zero output for rows that attend to
    nothing. q [B,Sq,H,Dh], k/v [B,Sk,Hkv,Dh], keep [B or 1, Sq, Sk]."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * Dh ** -0.5
    keep = keep[:, None, None]
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * keep
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def flash_attention_plain(q, k, v, padding_mask, *, causal, sliding_window=None,
                          offset=0) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments as flash_attention)."""
    if not causal:
        sliding_window = None
    keep = keep_mask(padding_mask, q.shape[1], k.shape[1], causal=causal,
                     sliding_window=sliding_window, offset=offset, device=q.device)
    return attend_plain(q, k, v, keep)


def _fn():
    fn = _build.load("flash_attention").gritlm_flash_fwd
    if fn.argtypes is None:
        P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
        fn.argtypes = [P] * 5 + [I32] * 5 + [I64] * 7 + [I32] * 3 + [F32, P]
        fn.restype = I32
    return fn


def _check_bshd(t: torch.Tensor, name: str) -> None:
    """[B, S, heads, 128] bf16 whose head and dim axes are dense (any batch
    and sequence strides, 16-byte aligned), as the kernel reads it."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[3] != HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention: {name} must be [B, S, heads, {HEAD_DIM}], got {tuple(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != HEAD_DIM or t.stride(0) % 8 or t.stride(1) % 8 \
            or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} strides {t.stride()} not supported")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],  # [B, Sk]; None = all valid
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: int = 0,
) -> torch.Tensor:
    """Attention forward. CPU tensors run the plain version; CUDA tensors run
    the kernel or raise. Returns [B, Sq, H, Dh] in q's dtype."""
    if _build.plain_path(q, k, v, padding_mask):
        return flash_attention_plain(q, k, v, padding_mask, causal=causal,
                                     sliding_window=sliding_window, offset=offset)
    fn = _fn()
    B, Sq, H, _ = q.shape
    _, Sk, Hkv, _ = k.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_bshd(t, name)
    if k.shape != v.shape or k.shape[0] != B or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not isinstance(offset, int):
        raise TypeError("flash_attention: offset must be a Python int (one offset for all rows)")
    if padding_mask is None:
        mask = torch.ones((B, Sk), dtype=torch.int32, device=q.device)
    else:
        if tuple(padding_mask.shape) != (B, Sk):
            raise ValueError(f"flash_attention: mask {tuple(padding_mask.shape)} != {(B, Sk)}")
        mask = padding_mask.to(torch.int32).contiguous()
    # the window is part of the causal mask (bidirectional calls ignore it)
    window = sliding_window if (causal and sliding_window) else 0
    out = torch.empty((B, Sq, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), mask.stride(0), int(causal), int(window), offset,
            HEAD_DIM ** -0.5, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
