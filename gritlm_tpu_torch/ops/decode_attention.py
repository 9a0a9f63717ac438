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

Kernel: `csrc/decode_attention.cu` with its body in `csrc/decode_mma.cuh`
(shared with K8, which addresses the same tiles through a page table),
CUDA C++ for sm_90a, bound with ctypes. What bounds it: the bytes of the
valid K/V slots (about one multiply-add per cache byte at Sq 1), and at the
serving and generate shapes, where a call reads a few MB, latency: the time
to find the valid slots, the first bytes' round trip and the merge of the
splits. The TPU kernel ran one grid cell per batch row; here a call is one
launch over (batch row, kv head, 8 query rows) units times `n_split` blocks
of 4 warps:
  - each block scans its row's mask over the slots its rows can see (the
    causal bound `offset + Sq`, the window) into tile bits, and cuts the
    unit's range from the first to the last valid slot into as many of the
    `n_split` parts as give each warp MIN_TILES_PER_WARP tiles
    (`used_splits`; the blocks of the other parts exit at once), so a
    serving row of 300 valid slots in a 4096-slot pool is split by its 300
    slots and no part covers slots past the causal bound; the wrapper
    needs no host sync for it;
  - each warp streams its run of 16-slot tiles through a private cp.async
    ring of 3 stages, copying only valid slots' rows and skipping tiles
    with none;
  - scores S^T = K Q^T and O^T += V^T P^T on tensor cores (mma.m16n8k16):
    the slots on the MMA's 16-row side, the GQA group's query rows on its
    8-wide side (4 rows at Sq 1 and group 4); Q stays in registers; the
    int8 cache becomes bf16 in registers, exactly;
  - the block merges its warps in shared memory; one split writes the
    output, otherwise the block that finishes a unit last merges the
    splits' partials in split order (bit-equal reruns).
`decode_plan` picks n_split from the unit count, the SM count and the
host-known slot range; `split_tiles` is the kernel's cut of a unit's tiles.
K8 (`paged_attention.py`) plans with the same functions.

Serving rows reach this kernel through the transformer's per-row path
(`forward(row_offsets=...)`). At S = 1 each row writes its K/V at its own
slot before attention, and the kernel runs mask-bounded (causal False,
offset 0, no window), since a row's mask covers exactly the slots it has
written. At S > 1 (the speculative verify chunk) `offset` is a [B] tensor:
query j of row b sees slots <= offset[b] + j (and the window below it), the
kernel reads `offsets[b]` itself, and the host plans over Smax, since it
cannot bound the rows' causal ranges without reading them; each block
trims its splits by the valid slots it finds, as K8 does.

Head dims: the kernel body is compiled for Dh 64, 96 and 128 (one instance
each; any other Dh raises NotImplementedError on CUDA tensors). S^T takes
Dh / 16 k-steps and O^T Dh / 16 M-tiles; a K/V row is Dh / 8 (bf16) or
Dh / 16 (int8) 16-byte copies, in shared-memory rows padded by 16 bytes so
the rows an ldmatrix reads fall in different banks; at Dh 96 the Q^T and K
fragments take two 64-dim groups' layout for the first 64 dims and an
8-dim-a-lane layout for the last 32. The split partials, the launch plan's
blocks an SM (`blocks_per_sm`: the rings shrink with Dh) and the counters
follow the call's Dh.

Differences from the TPU kernel: any Kv (the JAX kernel needs
(Kv*Dh) % 128 == 0, its lane alignment; the port's rows need only 16-byte
copies). (The JAX kernel too takes `offset` as an int or a [B] array.)
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops.flash_attention import attend_plain, keep_mask

# K3 and K8 (csrc/decode_mma.cuh)
HEAD_DIMS = (64, 96, 128)  # the kernel body's instances
SLOT_TILE = 16  # TK: slots a tile
ROW_GROUP = 8  # ROWS: query rows a unit (a warp's MMA columns)
DECODE_WARPS = 4  # warps a block, each on its own run of the block's tiles
RING_STAGES = 3  # STAGES: a warp's ring of tiles
MIN_TILES_PER_WARP = 4  # MIN_TILES: a split's least tiles a warp
MAX_SPLITS = 32
SMEM_PER_SM = 232448  # bytes of shared memory an SM gives its blocks (H100)
MAX_BLOCKS_PER_SM = 4  # 128 registers a thread: 4 blocks of 128 threads fill an SM


def ring_bytes(head_dim: int, quant: bool) -> int:
    """A block's rings in shared memory: 4 warps x 3 stages x (K and V) x
    16 slot rows of Dh elements padded by 16 bytes (Tile<T, DH>::RING)."""
    row = head_dim * (1 if quant else 2) + 16
    return DECODE_WARPS * RING_STAGES * 2 * SLOT_TILE * row


def blocks_per_sm(quant: bool, head_dim: int = 128) -> int:
    """Blocks of K3/K8 an SM holds at once: as many as its shared memory
    takes rings, at most MAX_BLOCKS_PER_SM."""
    return min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // ring_bytes(head_dim, quant))


# Dh 128: bf16 / int8 cache, 104 KB / 55 KB of rings a block
BLOCKS_PER_SM = {quant: blocks_per_sm(quant) for quant in (False, True)}


def dequantize_layer(x, scale, layer, hkv, dtype) -> torch.Tensor:
    """Layer `layer` of an int8 cache [L, B, Smax, Kv*Dh] with slot-minor
    scales [L, B, Kv, Smax] -> [B, Smax, Kv, Dh] in `dtype`."""
    _, B, Smax, KD = x.shape
    xl = x[layer].reshape(B, Smax, hkv, KD // hkv).float()
    return (xl * scale[layer].transpose(1, 2)[..., None].float()).to(dtype)


def flash_decode_plain(q, k, v, padding_mask, *, causal, sliding_window=None, offset=0,
                       layer=0, num_kv_heads=None, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """The plain PyTorch version of K3 (same arguments as flash_decode; a
    [B] `offset` makes the kept set [B, Sq, Smax])."""
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
        fn.argtypes = [P] * 11 + [I32] * 12 + [F32, P]
        fn.restype = I32
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slot_range(first_sq: int, last_sq: int, Smax: int, *, causal: bool, offset: int,
               window: Optional[int]):
    """[lo, hi): the slots that query positions first_sq .. last_sq can see
    before the mask: below the causal bound and inside the window (the
    kernel's bound for one unit's rows; the whole call's with 0, Sq - 1)."""
    hi = min(Smax, offset + last_sq + 1) if causal else Smax
    lo = max(0, offset + first_sq - window + 1) if window else 0
    return lo, hi


def split_tiles(n: int, s: int, parts: int):
    """[begin, end) of part s when n tiles are cut into `parts` (the
    kernel's part_begin: a unit's tiles into splits, a split's into warps)."""
    return n * s // parts, n * (s + 1) // parts


def used_splits(n_tiles: int, n_split: int) -> int:
    """The splits the kernel uses for a unit with n_tiles valid tiles, of
    the n_split it was launched with: at least MIN_TILES_PER_WARP tiles a
    warp each (the kernel's used_splits; the other blocks exit at once)."""
    return max(1, min(n_split, n_tiles // (DECODE_WARPS * MIN_TILES_PER_WARP)))


def decode_plan(B: int, Sq: int, H: int, Hkv: int, Smax: int, sms: int, *, causal: bool,
                offset: int = 0, window: Optional[int] = None, quant: bool = False,
                head_dim: int = 128):
    """(n_split, n_rg) of a K3 or K8 launch: n_rg groups of ROW_GROUP query rows a
    (batch row, kv head), and as many splits as fill `blocks_per_sm` blocks an
    SM in one wave, but no more than give each warp MIN_TILES_PER_WARP of
    the tiles the host can bound (the causal bound, the window; Smax for a
    mask-bounded call, whose valid range only the kernel sees), and at most
    MAX_SPLITS. The kernel uses `used_splits` of them a unit, by the valid
    tiles it finds."""
    n_rg = _cdiv(Sq * (H // Hkv), ROW_GROUP)
    units = B * Hkv * n_rg
    lo, hi = slot_range(0, Sq - 1, Smax, causal=causal, offset=offset, window=window)
    tiles = _cdiv(hi, SLOT_TILE) - lo // SLOT_TILE if hi > lo else 0
    n_split = min(blocks_per_sm(quant, head_dim) * sms // units,
                  _cdiv(tiles, DECODE_WARPS * MIN_TILES_PER_WARP), MAX_SPLITS)
    return max(1, n_split), n_rg


def partials(n_split: int, units: int, device, head_dim: int = 128):
    """The split partials a launch writes when n_split > 1: (max, sum)
    [n_split, units, ROW_GROUP, 2] and the unnormalised output rows
    [n_split, units, ROW_GROUP, head_dim], fp32; None, None for one split."""
    if n_split == 1:
        return None, None
    return (torch.empty((n_split, units, ROW_GROUP, 2), dtype=torch.float32, device=device),
            torch.empty((n_split, units, ROW_GROUP, head_dim), dtype=torch.float32,
                        device=device))


def flash_decode(
    q: torch.Tensor,  # [B, Sq, H, Dh], Sq small
    k: torch.Tensor,  # [L, B, Smax, Hkv*Dh], the full cache
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],  # [B, Smax] slot validity; None = all
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: Union[int, torch.Tensor] = 0,  # position of query row 0: one int, or [B]
    layer: int = 0,
    num_kv_heads: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q against cache layer `layer`; with k_scale/v_scale
    [L, B, Kv, Smax] the cache is int8; `offset` one int for every row or a
    [B] int tensor of per-row offsets. CPU tensors run the plain version;
    CUDA tensors run the kernel or raise. Returns [B, Sq, H, Dh]."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("flash_decode: give both k_scale and v_scale, or neither")
    off_t = offset if isinstance(offset, torch.Tensor) else None
    if _build.plain_path(q, k, v, padding_mask, k_scale, v_scale, off_t):
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
    if Dh not in HEAD_DIMS or hkv * Dh != KD or H % hkv:
        raise NotImplementedError(f"flash_decode: q {tuple(q.shape)} over cache {tuple(k.shape)}")
    if k.shape != v.shape or Bk != B:
        raise ValueError(f"flash_decode: cache k {tuple(k.shape)} v {tuple(v.shape)}, batch {B}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode: q and the cache must be contiguous")
    if not isinstance(layer, int) or not 0 <= layer < L:
        raise ValueError("flash_decode: layer must be a Python int, 0 <= layer < L")
    if off_t is None and not isinstance(offset, int):
        raise ValueError("flash_decode: offset must be a Python int or a [B] tensor")
    if off_t is not None and tuple(off_t.shape) != (B,):
        raise ValueError(f"flash_decode: offsets {tuple(off_t.shape)} != {(B,)}")
    if padding_mask is None:
        mask = None  # the kernel takes every slot as valid
    else:
        if tuple(padding_mask.shape) != (B, Smax):
            raise ValueError(f"flash_decode: mask {tuple(padding_mask.shape)} != {(B, Smax)}")
        mask = padding_mask.to(torch.int32).contiguous()
    offsets = None if off_t is None else off_t.to(torch.int32).contiguous()
    # per-row offsets: the host cannot bound the rows' ranges, so it plans
    # over Smax (the kernel trims each unit's splits by its valid slots)
    host = off_t is None
    n_split, n_rg = decode_plan(B, Sq, H, hkv, Smax, _build.sm_count(q.device),
                                causal=causal and host, offset=offset if host else 0,
                                window=sliding_window if host else None, quant=quant,
                                head_dim=Dh)
    units = B * hkv * n_rg
    part_ml, part_o = partials(n_split, units, q.device, Dh)
    counters = _build.counters(q.device, units) if n_split > 1 else None
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale), ptr(mask),
            ptr(offsets), ptr(part_ml), ptr(part_o), ptr(counters), out.data_ptr(), B, Sq, H,
            hkv, Dh, Smax, layer, n_split, n_rg, int(causal), int(sliding_window or 0),
            offset if host else 0, Dh ** -0.5, _build.stream_of(q))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    if not host:
        flash_decode.row_offset_launches += 1
    return out


flash_decode.launches = 0
flash_decode.row_offset_launches = 0  # of them, launches with per-row offsets (verify chunks)
