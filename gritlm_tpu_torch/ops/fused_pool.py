"""K2: fused final RMSNorm + masked (weighted) mean pool + L2 normalize,
hand-written for Hopper.

Replaces the Pallas kernel `_kernel` of `gritlm_tpu/ops/fused_pool.py`
(reached through `_fused_call` and `fused_norm_mean_pool`): the encode
epilogue. Same function: RMSNorm of the pre-norm hidden `[B, S, D]` with
gamma, in fp32, then the masked mean or weighted mean (weight = running
count of mask tokens), then an optional L2 normalize; `[B, D]` fp32 out; an
empty mask row gives a finite result.

Kernel: `csrc/fused_pool.cu`, CUDA C++ for sm_90a (not Triton), bound with
ctypes. What bounds it: bytes, one read of the hidden state (a few
operations per element). The design reads each masked-in hidden row once,
16 bytes a thread, never writes the normed `[B, S, D]`, and skips rows whose
pooling mask is 0 (instruction and padding tokens are not read). The TPU
kernel carried sums across a sequential grid; here blocks run in parallel,
so the sequence is cut into chunks, one block per (chunk, batch row), sized
from the SM count so that a small batch still fills the card; a second
kernel sums the chunk partials, applies gamma and the denominator, and
normalizes.
"""

from __future__ import annotations

import torch

from gritlm_tpu_torch.ops import _build

MAX_DIM = 8192  # THREADS * VEC * MAX_SLOTS in csrc/fused_pool.cu
BLOCKS_PER_SM = 2


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


def _fn():
    fn = _build.load("fused_pool").gritlm_fused_pool
    if fn.argtypes is None:
        P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
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
    run the kernel or raise. Returns [B, D] float32."""
    if method not in ("mean", "weightedmean"):
        raise ValueError(f"fused_norm_mean_pool: method {method!r}")
    if _build.plain_path(hidden, gamma, pool_mask):
        return fused_norm_mean_pool_plain(hidden, gamma, pool_mask, eps=eps, method=method,
                                          normalized=normalized)
    fn = _fn()
    B, S, D = hidden.shape
    if hidden.dtype != torch.bfloat16 or gamma.dtype != torch.bfloat16:
        raise TypeError("fused_norm_mean_pool: hidden and gamma must be bfloat16")
    if D % 8 or D > MAX_DIM or tuple(gamma.shape) != (D,) or tuple(pool_mask.shape) != (B, S):
        raise NotImplementedError(
            f"fused_norm_mean_pool: hidden {tuple(hidden.shape)}, gamma "
            f"{tuple(gamma.shape)}, mask {tuple(pool_mask.shape)} (D % 8 == 0, D <= {MAX_DIM})")
    if hidden.stride(2) != 1 or hidden.stride(0) % 8 or hidden.stride(1) % 8 \
            or hidden.data_ptr() % 16:
        raise ValueError(f"fused_norm_mean_pool: hidden strides {hidden.stride()}")
    gamma = gamma.contiguous()
    mask = pool_mask.to(torch.int32).contiguous()
    per_row = -(-BLOCKS_PER_SM * _build.sm_count(hidden.device) // B)
    chunk = -(-S // per_row)
    n_chunks = -(-S // chunk)
    dev = hidden.device
    part = torch.empty((n_chunks, B, D), dtype=torch.float32, device=dev)
    part_w = torch.empty((n_chunks, B), dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    rc = fn(hidden.data_ptr(), gamma.data_ptr(), mask.data_ptr(), part.data_ptr(),
            part_w.data_ptr(), out.data_ptr(), B, S, D, chunk, hidden.stride(0),
            hidden.stride(1), mask.stride(0), int(method == "weightedmean"),
            int(normalized), eps, _build.stream_of(hidden))
    _build.check(rc, "fused_norm_mean_pool")
    fused_norm_mean_pool.launches += 1
    return out


fused_norm_mean_pool.launches = 0
