"""K2: fused final RMSNorm + masked (weighted) mean pool + L2 normalize,
hand-written for Hopper.

Replaces the Pallas kernel `_kernel` of `gritlm_tpu/ops/fused_pool.py`
(reached through `_fused_call` and `fused_norm_mean_pool`): the encode
epilogue. Same function: RMSNorm of the pre-norm hidden `[B, S, D]` with
gamma, in fp32, then the masked mean or weighted mean (weight = running
count of mask tokens), then an optional L2 normalize; `[B, D]` fp32 out; an
empty mask row gives a finite result.

Kernel: `csrc/fused_pool.cu`, CUDA C++ for sm_90a (not Triton: its merge
runs through thread-block clusters and an arrival counter), bound with
ctypes. What bounds it: bytes, one read of the masked-in hidden rows. The
TPU kernel carried its sums across a sequential grid; here one launch does
the whole call. `pool_plan` sizes the grid: K clusters of CL blocks, about
two blocks an SM in one wave; the kernel gives each row its clusters in
proportion to its masked-in rows. Each
block reads the mask first, takes an equal share of its row's masked-in
rows by rank (masked-out rows are never read), streams them into shared
memory by 1-D bulk copies and sums them column-wise in registers; a
cluster merges its blocks' partials through distributed shared memory
(and finishes the row there when it has the row alone), and the row's last
block to arrive (`_build.counters`) merges the row's cluster partials in a
fixed order, applies gamma and the denominator, and normalizes.

fp32 hidden and gamma run K2's fp32 form (`gritlm_fused_pool_f32` in the
same source, counted in `fused_norm_mean_pool.f32_launches`): the bf16
ring's stage count and vector width assume 2-byte elements, so it is a
simpler kernel of the same function, bound by the same bytes (twice as
many). One launch of B x n_split blocks (`f32_pool_plan`): a block sums
the masked-in rows of its equal share of a row's positions (each row's
sum of squares a block sum in a fixed order) into fp32 partials, and the
row's last block merges them in split order, applies gamma and the
denominator and normalizes; no float atomics, so reruns are bit-equal.
Any other dtype (float16, or a mix) raises TypeError.
"""

from __future__ import annotations

import ctypes

import torch

from gritlm_tpu_torch.ops import _build

MAX_DIM = 8192  # CONSUMERS * VEC * MAX_SLOTS in csrc/fused_pool.cu
MAX_SEQ = 1 << 19  # a row's mask bits and prefix counts fit a block's shared memory
MAX_LIST = 1024  # masked-in rows one block takes (csrc/fused_pool.cu)
BLOCKS_PER_SM = 2
MIN_ROWS = 8  # positions a block at least: short rows get fewer blocks and partials
CLUSTERS = (8, 4, 2, 1)  # cluster sizes, largest first
BALANCE_MAX = 8192  # positions of the whole mask that every block reads to apportion
# the fp32 form (csrc/fused_pool.cu, namespace f32)
F32_THREADS = 256
F32_MAX_DIM = 8192  # F32_THREADS * 4 * MAX_VECS: a thread's float4 columns in registers
F32_BLOCKS_PER_SM = 4
F32_MIN_ROWS = 8  # positions a block at least


def f32_pool_plan(B: int, S: int, sms: int) -> int:
    """n_split of the fp32 form: blocks a batch row, as many as fill about
    F32_BLOCKS_PER_SM blocks an SM over the B rows, with at least
    F32_MIN_ROWS positions a block."""
    return max(1, min(-(-S // F32_MIN_ROWS), F32_BLOCKS_PER_SM * sms // max(B, 1)))


def f32_split(S: int, split: int, n_split: int):
    """[begin, end): the positions block `split` of a row takes (the
    kernel's cut, S split / n_split)."""
    return S * split // n_split, S * (split + 1) // n_split


def pool_plan(B: int, S: int, sms: int, fit=None):
    """(K, CL, need, balanced): K clusters of CL blocks over the B rows.
    CL is as large as a row's share of about BLOCKS_PER_SM blocks an SM
    allows (at least MIN_ROWS positions a block) while the device holds a
    cluster for every row at once; every row gets `need`
    clusters, enough that no block takes more than MAX_LIST rows, and the
    other K - B * need go to the rows on the device, in proportion to their
    masked-in rows when `balanced` (every block reads the whole mask, so
    only while it has at most BALANCE_MAX positions), else in equal shares.
    `fit(CL, balanced)`, where given, is how many clusters of CL blocks the
    device holds at once: K keeps to one such wave when the rows allow it.
    The blocks of a row split its masked-in rows evenly."""
    blocks = -(-S // MIN_ROWS)  # blocks a row at most
    want = max(1, min(BLOCKS_PER_SM * sms // max(B, 1), blocks))
    balanced = 1 < B and B * S <= BALANCE_MAX
    for cl in CLUSTERS:  # the largest that the row's share allows and the rows fit
        need = -(-S // (cl * MAX_LIST))
        if cl <= max(want, -(-S // MAX_LIST)) and (fit is None or fit(cl, balanced) >= B * need
                                                   or cl == CLUSTERS[-1]):
            break
    total = max(1, min(BLOCKS_PER_SM * sms, B * blocks) // cl)
    if fit is not None:
        total = min(total, fit(cl, balanced))
    K = max(B * need, total)
    return K, cl, need, balanced and K > B * need


_fits = {}


def _fit(device: torch.device, B: int, S: int, D: int, cl: int, balanced: bool) -> int:
    """Clusters of cl blocks the device holds at once for a call at
    (B, S, D) (cudaOccupancyMaxActiveClusters through the library), cached."""
    key = (device.index, B if balanced else 0, S, D, cl, balanced)
    if key not in _fits:
        fn = _build.load("fused_pool").gritlm_fused_pool_fit
        fn.argtypes = [_build.I32] * 5 + [_build.P]
        fn.restype = _build.I32
        n = ctypes.c_int(0)
        _build.check(fn(B, S, D, cl, int(balanced), ctypes.byref(n)),
                     "fused_norm_mean_pool (occupancy)")
        _fits[key] = n.value
    return _fits[key]


def fused_norm_mean_pool_plain(hidden, gamma, pool_mask, *, eps, method="mean",
                               normalized=True) -> torch.Tensor:
    """The plain PyTorch version of K2 (same arguments as
    fused_norm_mean_pool)."""
    x = hidden.float()
    xn = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gamma.float()
    m = pool_mask.float()
    w = m * m.cumsum(1) if method == "weightedmean" else m
    s = torch.einsum("bs,bsd->bd", w, xn)
    denom = w.sum(1, keepdim=True)
    emb = s / torch.where(denom > 0, denom, torch.ones_like(denom))
    if normalized:
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return emb


def _fn(name: str = "gritlm_fused_pool"):
    fn = getattr(_build.load("fused_pool"), name)
    if fn.argtypes is None:
        P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
        if name == "gritlm_fused_pool":
            fn.argtypes = [P] * 6 + [I32] * 7 + [I64] * 3 + [I32] * 2 + [F32, P]
        else:  # gritlm_fused_pool_f32
            fn.argtypes = [P] * 6 + [I32] * 4 + [I64] * 3 + [I32] * 2 + [F32, P]
        fn.restype = I32
    return fn


def fused_norm_mean_pool(
    hidden: torch.Tensor,  # [B, S, D] pre-final-norm residual stream
    gamma: torch.Tensor,  # [D] final RMSNorm scale
    pool_mask: torch.Tensor,  # [B, S] 1 = pool over
    *,
    eps: float,
    method: str = "mean",  # mean | weightedmean
    normalized: bool = True,
) -> torch.Tensor:
    """pool(rms_norm(hidden, gamma), pool_mask, method) (+ L2 normalize) in
    one pass over hidden. CPU tensors run the plain version; CUDA tensors
    run the kernel of their dtype (both bf16, or both fp32) or raise.
    Returns [B, D] float32."""
    if method not in ("mean", "weightedmean"):
        raise ValueError(f"fused_norm_mean_pool: method {method!r}")
    if _build.plain_path(hidden, gamma, pool_mask):
        return fused_norm_mean_pool_plain(hidden, gamma, pool_mask, eps=eps, method=method,
                                          normalized=normalized)
    # the library before any check of the tensors
    fn = _fn("gritlm_fused_pool_f32" if hidden.dtype == torch.float32 else "gritlm_fused_pool")
    if _build.kernel_form(hidden, gamma, what="fused_norm_mean_pool") == "f32":
        return _pool_f32(fn, hidden, gamma, pool_mask, eps=eps, method=method,
                         normalized=normalized)
    B, S, D = hidden.shape
    if (D % 8 or D > MAX_DIM or S > MAX_SEQ or tuple(gamma.shape) != (D,)
            or tuple(pool_mask.shape) != (B, S)):
        raise NotImplementedError(
            f"fused_norm_mean_pool: hidden {tuple(hidden.shape)}, gamma "
            f"{tuple(gamma.shape)}, mask {tuple(pool_mask.shape)} (D % 8 == 0, D <= {MAX_DIM}, "
            f"S <= {MAX_SEQ})")
    if hidden.stride(2) != 1 or hidden.stride(0) % 8 or hidden.stride(1) % 8 \
            or hidden.data_ptr() % 16:
        raise ValueError(f"fused_norm_mean_pool: hidden strides {hidden.stride()}")
    gamma = gamma.contiguous()
    mask = pool_mask.to(torch.int32).contiguous()
    dev = hidden.device
    K, CL, need, balanced = pool_plan(B, S, _build.sm_count(dev),
                                      fit=lambda cl, bal: _fit(dev, B, S, D, cl, bal))
    part = torch.empty((K, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    rc = fn(hidden.data_ptr(), gamma.data_ptr(), mask.data_ptr(), part.data_ptr(),
            _build.counters(dev, B).data_ptr(), out.data_ptr(), B, S, D, K, CL, need,
            int(balanced), hidden.stride(0), hidden.stride(1), mask.stride(0),
            int(method == "weightedmean"), int(normalized), eps, _build.stream_of(hidden))
    _build.check(rc, "fused_norm_mean_pool")
    fused_norm_mean_pool.launches += 1
    return out


fused_norm_mean_pool.launches = 0
fused_norm_mean_pool.f32_launches = 0  # launches of the fp32 form


def _pool_f32(fn, hidden, gamma, pool_mask, *, eps, method, normalized) -> torch.Tensor:
    """K2's fp32 form (entry `fn`) on CUDA tensors (fp32 hidden and gamma)."""
    B, S, D = hidden.shape
    if (D % 4 or D > F32_MAX_DIM or S >= 2**31 or tuple(gamma.shape) != (D,)
            or tuple(pool_mask.shape) != (B, S)):
        raise NotImplementedError(
            f"fused_norm_mean_pool: hidden {tuple(hidden.shape)}, gamma "
            f"{tuple(gamma.shape)}, mask {tuple(pool_mask.shape)} (fp32: D % 4 == 0, "
            f"D <= {F32_MAX_DIM})")
    if hidden.stride(2) != 1 or hidden.stride(0) % 4 or hidden.stride(1) % 4 \
            or hidden.data_ptr() % 16:
        raise ValueError(f"fused_norm_mean_pool: hidden strides {hidden.stride()}")
    gamma = gamma.contiguous()
    if gamma.data_ptr() % 16:
        raise ValueError("fused_norm_mean_pool: gamma must be 16-byte aligned")
    mask = pool_mask.to(torch.int32).contiguous()
    dev = hidden.device
    n_split = f32_pool_plan(B, S, _build.sm_count(dev))
    part = torch.empty((B * n_split, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    rc = fn(hidden.data_ptr(), gamma.data_ptr(), mask.data_ptr(), part.data_ptr(),
            _build.counters(dev, B).data_ptr(), out.data_ptr(), B, S, D, n_split,
            hidden.stride(0), hidden.stride(1), mask.stride(0), int(method == "weightedmean"),
            int(normalized), eps, _build.stream_of(hidden))
    _build.check(rc, "fused_norm_mean_pool")
    fused_norm_mean_pool.f32_launches += 1
    return out
