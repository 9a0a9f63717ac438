"""K8: paged decode attention, hand-written for Hopper.

Replaces the Pallas kernel `_kernel` of `gritlm_tpu/ops/paged_attention.py`
(reached through `_paged_call` and `paged_decode`). Same function: few-query
attention of q [B, Sq, H, Dh] against layer `layer` of a shared page pool
[L, P, page, Kv*Dh], read in place. Row b's logical slot s lives in page
page_table[b, s // page] at s % page; slot validity comes from the logical
mask [B, max_pages*page] (holes are skipped exactly); each row reads only up
to its own last valid page; with `causal` and a per-row `offset` [B], query j
of row b sees logical slots <= offset[b] + j (the speculative verify chunk);
GQA reads the group's shared K/V once; int8 pages carry bf16 scales
[L, P, Kv, page], applied to the scores for K and through the probabilities
for V. Rows with an empty mask give 0.

Kernel: `csrc/paged_attention.cu`, CUDA C++ for sm_90a, bound with ctypes:
K3's kernel body (`csrc/decode_mma.cuh`) with paged addressing. What bounds
it: the bytes of each row's valid K/V slots (and their scales for int8); a
step does about one multiply-add per byte it reads, and at the serving
shape a call reads a few MB, so latency counts as much: finding the valid
slots, the first bytes' round trip, the merge of the splits. The TPU kernel
ran one grid cell per row and streamed whole pages. Here a call is one
launch (the earlier design ran three: a row-bound pass, split-KV warps
planned from the logical width, a combine pass):
  - each block scans its row's logical mask over the slots its rows can see
    (with `causal`, up to offset[b] + the last query position) into tile
    bits, and cuts the row's valid tiles into as many of the launch's
    splits as give each warp MIN_TILES_PER_WARP tiles (`used_splits`), so
    the bytes read and the splits used follow each row's own length, not
    the pool's max_len, with no host sync;
  - each warp streams its run of 16-slot tiles through a private cp.async
    ring, copying only valid rows; a tile never straddles a page (page %
    32 == 0), so one page-table read gives its rows and its int8 scales;
  - S^T = K Q^T and O^T += V^T P^T on tensor cores (mma.m16n8k16), Q in
    registers, int8 pages converted to bf16 exactly in registers;
  - the block merges its warps in shared memory, and the block that
    finishes a unit last merges the splits' partials in split order.
The plan is K3's (`decode_plan`, `partials`, `_build.counters`): the host
bound applies when `offset` is one int; per-row offsets are the kernel's
to apply. On the same logical cache K8 and K3 run the same folds in the
same order.

Head dims 64, 96 and 128, as K3 (the same kernel body's instances; any
other Dh raises NotImplementedError on CUDA tensors).

fp32 q runs K3's fp32 form with paged addressing
(`gritlm_paged_decode_f32`, counted in `paged_decode.f32_launches`) over
fp32 pages, or int8 pages with bf16 scales, planned by `paged_plan` with
`f32=True`; on the same logical cache it runs the same folds in the same
order as K3's fp32 form. Any other dtype raises TypeError.

Differences from the TPU kernel: `page` any multiple of 32 and any Kv (the
JAX kernel takes pages of 128, 256 and 512 and (Kv*Dh) % 128 == 0, and
sends other geometries to a gather; here a CUDA tensor launches the kernel
or raises).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops.decode_attention import HEAD_DIMS, decode_plan, partials
from gritlm_tpu_torch.ops.flash_attention import attend_plain

PAGE_MULTIPLE = 32  # pages the kernel takes: a multiple of this many slots


def _row_offsets(offset, B: int, device) -> torch.Tensor:
    if isinstance(offset, torch.Tensor):
        return offset.to(device=device, dtype=torch.int32).reshape(-1).expand(B)
    return torch.full((B,), int(offset), dtype=torch.int32, device=device)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor, layer: int) -> torch.Tensor:
    """Layer `layer` of a page pool [L, P, page, KD] read through the page
    table [B, maxp] as the rows' dense logical caches [B, maxp*page, KD]."""
    B, maxp = page_table.shape
    pt = page_table.long().clamp(0, pages.shape[1] - 1)
    return pages[layer][pt.reshape(-1)].reshape(B, maxp * pages.shape[2], -1)


def gather_scales(scale: torch.Tensor, page_table: torch.Tensor, layer: int) -> torch.Tensor:
    """Scales [L, P, Kv, page] through the page table -> [B, maxp*page, Kv]."""
    B, maxp = page_table.shape
    pt = page_table.long().clamp(0, scale.shape[1] - 1)
    s = scale[layer][pt.reshape(-1)]  # [B*maxp, Kv, page]
    return s.reshape(B, maxp, s.shape[1], s.shape[2]).transpose(2, 3).reshape(
        B, maxp * s.shape[2], s.shape[1])


def paged_decode_plain(q, k_pages, v_pages, page_table, mask, *, layer=0, num_kv_heads=None,
                       k_scale=None, v_scale=None, causal=False, offset=0) -> torch.Tensor:
    """The plain PyTorch version of K8 (same arguments as paged_decode): the
    rows' pages gathered into dense logical caches, then masked attention."""
    B, Sq, H, Dh = q.shape
    hkv = num_kv_heads or k_pages.shape[3] // Dh
    lk = gather_pages(k_pages, page_table, layer).reshape(B, -1, hkv, Dh)
    lv = gather_pages(v_pages, page_table, layer).reshape(B, -1, hkv, Dh)
    if k_scale is not None:
        lk = lk.float() * gather_scales(k_scale, page_table, layer).float()[..., None]
        lv = lv.float() * gather_scales(v_scale, page_table, layer).float()[..., None]
    Smax = lk.shape[1]
    keep = (mask != 0)[:, None, :].expand(B, Sq, Smax)
    if causal:
        q_pos = _row_offsets(offset, B, q.device)[:, None] + torch.arange(Sq, device=q.device)
        keep = keep & (torch.arange(Smax, device=q.device)[None, None, :] <= q_pos[..., None])
    return attend_plain(q, lk, lv, keep)


def paged_plan(B: int, Sq: int, H: int, Hkv: int, Smax: int, sms: int, *, causal: bool,
               offset, quant: bool, head_dim: int = 128, f32: bool = False):
    """(n_split, n_rg) of a K8 launch over a logical width of Smax slots:
    K3's `decode_plan`, bounded by the causal bound only when `offset` is
    one int for every row (a tensor of per-row offsets is the kernel's to
    apply; the host plans over Smax and the kernel trims its splits)."""
    host = causal and not isinstance(offset, torch.Tensor)
    return decode_plan(B, Sq, H, Hkv, Smax, sms, causal=host, offset=int(offset) if host else 0,
                       quant=quant, head_dim=head_dim, f32=f32)


def _fn(name: str = "gritlm_paged_decode"):
    fn = getattr(_build.load("paged_attention"), name)
    if fn.argtypes is None:
        P, I32, F32 = _build.P, _build.I32, _build.F32
        fn.argtypes = [P] * 12 + [I32] * 13 + [F32, P]
        fn.restype = I32
    return fn


def paged_decode(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k_pages: torch.Tensor,  # [L, P, page, Kv*Dh]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp] int32
    mask: torch.Tensor,  # [B, maxp*page] logical slot validity
    *,
    layer: int = 0,
    num_kv_heads: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 pool: [L, P, Kv, page]
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = False,
    offset: Union[int, torch.Tensor] = 0,  # [B] or scalar logical slot of q row 0
) -> torch.Tensor:
    """Decode attention over a paged pool, mask-bounded (the serving
    contract); `causal=True` adds the per-row bound slot <= offset[b] + j.
    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise. Returns [B, Sq, H, Dh]."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("paged_decode: give both k_scale and v_scale, or neither")
    off_t = offset if isinstance(offset, torch.Tensor) else None
    if _build.plain_path(q, k_pages, v_pages, page_table, mask, k_scale, v_scale, off_t):
        return paged_decode_plain(q, k_pages, v_pages, page_table, mask, layer=layer,
                                  num_kv_heads=num_kv_heads, k_scale=k_scale,
                                  v_scale=v_scale, causal=causal, offset=offset)
    # the library before any check of the tensors
    fn = _fn("gritlm_paged_decode_f32" if q.dtype == torch.float32 else "gritlm_paged_decode")
    f32 = _build.kernel_form(q, what="paged_decode") == "f32"
    B, Sq, H, Dh = q.shape
    L, P, page, KD = k_pages.shape
    hkv = num_kv_heads or KD // Dh
    maxp = page_table.shape[1]
    cache_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != cache_dtype or v_pages.dtype != cache_dtype:
        raise TypeError(f"paged_decode: under {q.dtype} q the pages must be {cache_dtype}")
    if quant and not all(t.dtype == torch.bfloat16 and t.is_contiguous()
                         and tuple(t.shape) == (L, P, hkv, page) for t in (k_scale, v_scale)):
        raise ValueError(f"paged_decode: scales must be contiguous bfloat16 {(L, P, hkv, page)}")
    if Dh not in HEAD_DIMS or hkv * Dh != KD or H % hkv:
        raise NotImplementedError(f"paged_decode: q {tuple(q.shape)} over pages "
                                  f"{tuple(k_pages.shape)}")
    if page % PAGE_MULTIPLE:
        raise NotImplementedError(
            f"paged_decode: page {page} is not a multiple of {PAGE_MULTIPLE}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode: k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()) \
            or q.data_ptr() % 16:
        raise ValueError("paged_decode: q and the pages must be contiguous, q 16-byte aligned")
    if tuple(page_table.shape) != (B, maxp) or tuple(mask.shape) != (B, maxp * page):
        raise ValueError(f"paged_decode: page table {tuple(page_table.shape)} and mask "
                         f"{tuple(mask.shape)} for B {B}, page {page}")
    if not isinstance(layer, int) or not 0 <= layer < L:
        raise ValueError("paged_decode: layer must be a Python int, 0 <= layer < L")
    table = page_table.to(torch.int32).contiguous()
    mask = mask.to(torch.int32).contiguous()
    offsets = None if off_t is None else _row_offsets(off_t, B, q.device).contiguous()
    n_split, n_rg = paged_plan(B, Sq, H, hkv, maxp * page, _build.sm_count(q.device),
                               causal=causal, offset=offset, quant=quant, head_dim=Dh,
                               f32=f32)
    units = B * hkv * n_rg
    part_ml, part_o = partials(n_split, units, q.device, Dh)
    counters = _build.counters(q.device, units) if n_split > 1 else None
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale), ptr(v_scale),
            table.data_ptr(), mask.data_ptr(), ptr(offsets), ptr(part_ml), ptr(part_o),
            ptr(counters), out.data_ptr(), B, Sq, H, hkv, Dh, P, page, maxp, layer, n_split, n_rg,
            int(causal), 0 if off_t is not None else int(offset), Dh ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "paged_decode")
    if f32:
        paged_decode.f32_launches += 1
    else:
        paged_decode.launches += 1
    return out


paged_decode.launches = 0
paged_decode.f32_launches = 0  # launches of the fp32 form
