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
What bounds it: at the encode and training shapes (S >= 64) its operations,
4*B*H*Sq*Sk*Dh of them in bf16 matrix products over the visited pairs,
beside one exponential a pair; K/V are read once per (q-tile, head), well
under the bytes bound. The design (K4's, turned to the forward): one block
per 128 query rows and head, two consumer warpgroups of 64 rows and a
producer warp; Q stays in shared memory, K/V stream through a 3-stage TMA
ring of 128-key tiles (mbarriers) in the visit order, skipping causal tiles
above the diagonal, tiles below the sliding window and tiles holding no
valid key; S = Q K^T and O += P V are wgmma, with the online softmax on the
score accumulators in registers, P handed to the second product as register
fragments and O in registers until the epilogue; the next tile's S is in
flight while this tile's softmax runs. The TMA tensor maps read q/k/v
through their batch and sequence strides, so a cache layer `k_all[l]` is a
view, not a copy (`csrc/sm90.cuh` holds the PTX building blocks).

K4 and K5, the backward (`csrc/flash_attention_bwd.cu`), replace the
Pallas `_bwd_dq_kernel` and `_bwd_dkv_kernel` (reached through `_flash_bwd`
and `_core_bwd`). The forward saves each row's log-sum-exp (K1 with an
`lse` output, fp32 [B, H, Sq]); the backward rebuilds P = exp(S*scale - lse)
under the same keep mask, with delta = rowsum(dO * O) computed by torch
ops, dQ = dS K in K4 (one block per q-tile and query head) and dK = dS^T Q,
dV = P^T dO in K5 (one block per k-tile and kv head, looping over the GQA
group's query heads, so the group's sum stays inside the block; the JAX
kernel writes per query head and sums outside). What bounds them: their
operations (K4 3 and K5 4 products of 2*Sq*Sk*Dh per head over the visible
tiles) at training shapes. So every product is a wgmma: each block keeps
its own 128 rows (K4: Q and dO; K5: K and V) in shared memory and streams
the other side through a 3-stage TMA ring with mbarriers (K4: a producer
warp; K5: its consumers refill it), and two consumer warpgroups form P and
dS in registers from the score accumulators and feed them back to wgmma as
register operands; the dQ (K4) or dK/dV (K5) accumulators stay in
registers until the epilogue (`csrc/sm90.cuh` holds the PTX building
blocks). The TMA tensor maps read q/k/v/do through their batch and
sequence strides, so `_check_bshd`'s rule (16-byte aligned base, strides
multiples of 8 elements) is exactly what TMA needs. `FlashAttentionFn`
wires K1 with LSE, K4 and K5 into autograd; on CUDA tensors its backward
launches K4 and K5 or raises.

Head dims. K1, K4 and K5 each have two compiled instances, Dh 128 and
Dh 64 (Llama-3.2-1B, Qwen2-0.5B), on the Dh-128 schedule: at 64 every
resident and ring tile is one 64-column half, the products reduced over
the head dim (S = Q K^T, dP = dO V^T) take 4 k-steps, and the products
whose output columns are the head dim (O += P V, dQ += dS K, dK += dS^T
Q, dV += P^T dO) are m64n64k16 wgmmas. Any other Dh below 128 that is a
multiple of 8 (96: Phi-3-mini; 80: Phi-2) is zero-padded to 128 here, as
the JAX wrapper pads to its 128-lane multiple: the kernels run at 128 with
the true softmax scale Dh^-0.5 passed in (the JAX wrapper folds
sqrt(128/Dh) into q instead). `flash_attention` copies q, k and v into
[.., 128] tensors (for a cache view, the whole layer's visible slots) and
copies the output's first Dh columns out: three input copies and one
output copy of the padded size a call. Under autograd `FlashAttentionFn`
saves the unpadded q, k, v and output, so a padded head dim keeps no more
activation memory than a native one, and `flash_attention_bwd` pads again:
q, k, v and dO are copied into [.., 128] tensors, K4 and K5 run at 128 with
the same Dh^-0.5, and dq, dk and dv are their first Dh columns (delta =
rowsum(dO * O) is taken at Dh: zero columns add nothing to it). Dh above
128 raises NotImplementedError, in training too.

Differences from the TPU kernel: any Sq runs the kernel (the TPU version
needed Sq >= 128 and sent shorter queries to an einsum); the padded head
dims take the true scale, not a scaled q; bf16 only.
"""

from __future__ import annotations

from typing import Optional

import torch

from gritlm_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIM = 128  # the width the kernels pad other head dims to
# K1's, K4's and K5's compiled instances (csrc/flash_attention.cu,
# csrc/flash_attention_bwd.cu)
KERNEL_HEAD_DIMS = (64, 128)


def keep_mask(
    padding_mask: Optional[torch.Tensor],  # [B, Sk]
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    sliding_window: Optional[int],
    offset,  # int, or a [B] tensor
    device,
) -> torch.Tensor:
    """Boolean [B or 1, Sq, Sk]: which (query, key) pairs attend. The window
    applies whenever it is given (callers drop it where it must not). A [B]
    tensor `offset` gives each row its own position of query row 0."""
    keep = torch.ones((1, q_len, kv_len), dtype=torch.bool, device=device)
    if causal or sliding_window is not None:
        if isinstance(offset, torch.Tensor):
            offset = offset.to(device)[:, None, None]
        q_pos = offset + torch.arange(q_len, device=device)[:, None]
        k_pos = torch.arange(kv_len, device=device)[None, :]
        if causal:
            keep = keep & (k_pos <= q_pos)
        if sliding_window is not None:
            keep = keep & (k_pos > q_pos - sliding_window)
    if padding_mask is not None:
        keep = keep & (padding_mask != 0)[:, None, :]
    return keep


def _scores_plain(q, k, keep, scale: float) -> torch.Tensor:
    """Scaled fp32 scores [B, Hkv, G, Sq, Sk], NEG_INF where not kept."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    return s.masked_fill(~keep[:, None, None], NEG_INF)


def attend_plain(q, k, v, keep, return_lse: bool = False):
    """fp32 masked softmax attention with zero output for rows that attend to
    nothing. q [B,Sq,H,Dh], k/v [B,Sk,Hkv,Dh], keep [B or 1, Sq, Sk]. With
    return_lse also the rows' log-sum-exp [B, H, Sq] (NEG_INF for a row with
    no kept key), as K1 writes it."""
    B, Sq, H, Dh = q.shape
    s = _scores_plain(q, k, keep, Dh ** -0.5)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * keep[:, None, None]
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, H, Dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, torch.ones_like(l))),
                      torch.full_like(l, NEG_INF))
    return out, lse.reshape(B, H, Sq).detach()


def flash_attention_plain(q, k, v, padding_mask, *, causal, sliding_window=None,
                          offset=0, return_lse: bool = False):
    """The plain PyTorch version of K1 (same arguments as flash_attention)."""
    if not causal:
        sliding_window = None
    keep = keep_mask(padding_mask, q.shape[1], k.shape[1], causal=causal,
                     sliding_window=sliding_window, offset=offset, device=q.device)
    return attend_plain(q, k, v, keep, return_lse=return_lse)


def _bwd_plain_parts(q, k, v, padding_mask, do, lse, delta, *, causal, sliding_window,
                     offset, scale=None):
    """P and dS [B, Hkv, G, Sq, Sk] fp32, rebuilt from the saved LSE under
    the forward's keep mask (selected, never multiplied, to 0 elsewhere),
    at the forward's softmax scale (default Dh^-0.5)."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    if not causal:
        sliding_window = None
    keep = keep_mask(padding_mask, Sq, k.shape[1], causal=causal,
                     sliding_window=sliding_window, offset=offset, device=q.device)
    keep = keep[:, None, None]
    rows = (B, Hkv, H // Hkv, Sq, 1)
    s = _scores_plain(q, k, keep[:, 0, 0], scale)
    p = torch.where(keep, torch.exp(s - lse.float().reshape(rows)), 0.0)
    dog = do.float().reshape(B, Sq, Hkv, H // Hkv, Dh)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = torch.where(keep, p * (dp - delta.float().reshape(rows)) * scale, 0.0)
    return p, ds, dog


def flash_attention_bwd_dq_plain(q, k, v, padding_mask, do, lse, delta, *, causal,
                                 sliding_window=None, offset=0, scale=None) -> torch.Tensor:
    """The plain PyTorch version of K4: dQ = dS K, [B, Sq, H, Dh] in q's dtype."""
    _, ds, _ = _bwd_plain_parts(q, k, v, padding_mask, do, lse, delta, causal=causal,
                                sliding_window=sliding_window, offset=offset, scale=scale)
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, padding_mask, do, lse, delta, *, causal,
                                  sliding_window=None, offset=0, scale=None):
    """The plain PyTorch version of K5: (dK = dS^T Q, dV = P^T dO), each
    [B, Sk, Hkv, Dh] in k's dtype, summed over each GQA group."""
    p, ds, dog = _bwd_plain_parts(q, k, v, padding_mask, do, lse, delta, causal=causal,
                                  sliding_window=sliding_window, offset=offset, scale=scale)
    qg = q.float().reshape(dog.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, Sq] (the layout of the LSE)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, padding_mask, out, lse, do, *, causal,
                              sliding_window=None, offset=0):
    """The plain backward from the saved LSE: (dq, dk, dv) in the inputs'
    dtypes, dk/dv summed over each GQA group."""
    kw = dict(causal=causal, sliding_window=sliding_window, offset=offset)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, padding_mask, do, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, padding_mask, do, lse, delta, **kw))


def _fn(name: str = "gritlm_flash_fwd", lib: str = "flash_attention"):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
        if name == "gritlm_flash_fwd":
            fn.argtypes = [P] * 6 + [I32] * 6 + [I64] * 7 + [I32] * 3 + [F32, P]
        elif name == "gritlm_flash_bwd_dq":
            fn.argtypes = [P] * 8 + [I32] * 6 + [I64] * 9 + [I32] * 3 + [F32, P]
        else:  # gritlm_flash_bwd_dkv
            fn.argtypes = [P] * 9 + [I32] * 6 + [I64] * 9 + [I32] * 3 + [F32, P]
        fn.restype = I32
    return fn


def _check_bshd(t: torch.Tensor, name: str) -> None:
    """[B, S, heads, Dh] bf16, Dh one of KERNEL_HEAD_DIMS, whose head and
    dim axes are dense (any batch and sequence strides, 16-byte aligned), as
    the kernels read it."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[3] not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: {name} must be [B, S, heads, Dh in "
                                  f"{KERNEL_HEAD_DIMS}], got {tuple(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != t.shape[3] or t.stride(0) % 8 or t.stride(1) % 8 \
            or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} strides {t.stride()} not supported")


def kernel_head_dim(Dh: int) -> int:
    """The head dim K1, K4 and K5 run a call of head dim Dh at: Dh itself
    for a compiled instance, else 128 (zero-padded; Dh < 128 and Dh % 8 ==
    0). Raises NotImplementedError for any other Dh."""
    if Dh in KERNEL_HEAD_DIMS:
        return Dh
    if Dh < HEAD_DIM and Dh % 8 == 0:
        return HEAD_DIM
    raise NotImplementedError(
        f"flash_attention: head dim {Dh} (the kernels run 64 and 128, and pad multiples of 8 "
        f"below 128 to 128)")


def _pad_heads(t: torch.Tensor, width: int) -> torch.Tensor:
    """t [B, S, heads, Dh] zero-padded to [B, S, heads, width] (a copy)."""
    return torch.nn.functional.pad(t, (0, width - t.shape[3]))


def _kernel_mask(padding_mask, B: int, Sk: int, device) -> torch.Tensor:
    if padding_mask is None:
        return torch.ones((B, Sk), dtype=torch.int32, device=device)
    if tuple(padding_mask.shape) != (B, Sk):
        raise ValueError(f"flash_attention: mask {tuple(padding_mask.shape)} != {(B, Sk)}")
    return padding_mask.to(torch.int32).contiguous()


def _check_qkv(q, k, v, offset) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_bshd(t, name)
    if k.shape != v.shape or k.shape[0] != q.shape[0] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not isinstance(offset, int):
        raise TypeError("flash_attention: offset must be a Python int (one offset for all rows)")


def _check_rows(t: torch.Tensor, shape: tuple, name: str) -> None:
    """An fp32 contiguous [B, H, Sq] row statistic (the LSE or delta)."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"flash_attention backward: {name} must be contiguous float32 "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],  # [B, Sk]; None = all valid
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: int = 0,
    return_lse: bool = False,
):
    """Attention forward. CPU tensors run the plain version; CUDA tensors run
    the kernel or raise. Returns [B, Sq, H, Dh] in q's dtype, and with
    return_lse also the rows' fp32 log-sum-exp [B, H, Sq]."""
    if _build.plain_path(q, k, v, padding_mask):
        return flash_attention_plain(q, k, v, padding_mask, causal=causal,
                                     sliding_window=sliding_window, offset=offset,
                                     return_lse=return_lse)
    fn = _fn()
    B, Sq, H, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    Dk = kernel_head_dim(Dh)
    if Dk != Dh:  # zero-padded heads: the same scores, the same first Dh output columns
        if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
            raise TypeError("flash_attention: q, k and v must be bfloat16")
        q, k, v = (_pad_heads(t, Dk) for t in (q, k, v))
    _check_qkv(q, k, v, offset)
    mask = _kernel_mask(padding_mask, B, Sk, q.device)
    # the window is part of the causal mask (bidirectional calls ignore it)
    window = sliding_window if (causal and sliding_window) else 0
    out = torch.empty((B, Sq, H, Dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            B, Sq, Sk, H, Hkv, Dk, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), mask.stride(0), int(causal), int(window), offset,
            Dh ** -0.5, _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    if Dk != Dh:
        out = out[..., :Dh].contiguous()
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _bwd_args(q, k, v, padding_mask, do, lse, delta, causal, sliding_window, offset, scale):
    """Checks and the shared leading arguments of K4 and K5, and the int32
    mask whose pointer they hold (the caller keeps it alive through the
    launch). `scale` is the forward's softmax scale (None: Dh^-0.5)."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    _check_qkv(q, k, v, offset)
    _check_bshd(do, "do")
    if do.shape != q.shape:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} != q {tuple(q.shape)}")
    _check_rows(lse, (B, H, Sq), "lse")
    _check_rows(delta, (B, H, Sq), "delta")
    mask = _kernel_mask(padding_mask, B, Sk, q.device)
    window = sliding_window if (causal and sliding_window) else 0
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (B, Sq, Sk, H, k.shape[2], Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), mask.stride(0), do.stride(0), do.stride(1),
            int(causal), int(window), offset, Dh ** -0.5 if scale is None else scale,
            _build.stream_of(q))
    return head, tail, mask


def flash_attention_bwd_dq(q, k, v, padding_mask, do, lse, delta, *, causal,
                           sliding_window=None, offset=0, scale=None) -> torch.Tensor:
    """K4: dQ [B, Sq, H, Dh] from the saved LSE and delta [B, H, Sq], at the
    forward's softmax scale (None: Dh^-0.5). CPU tensors run the plain
    version; CUDA tensors run the kernel (Dh 64 or 128) or raise."""
    if _build.plain_path(q, k, v, padding_mask, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, padding_mask, do, lse, delta,
                                            causal=causal, sliding_window=sliding_window,
                                            offset=offset, scale=scale)
    fn = _fn("gritlm_flash_bwd_dq", "flash_attention_bwd")
    head, tail, _mask = _bwd_args(q, k, v, padding_mask, do, lse, delta, causal,
                                  sliding_window, offset, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check(fn(*head, dq.data_ptr(), *tail), "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, padding_mask, do, lse, delta, *, causal,
                            sliding_window=None, offset=0, scale=None):
    """K5: (dK, dV), each [B, Sk, Hkv, Dh], summed over each GQA group, at
    the forward's softmax scale (None: Dh^-0.5). CPU tensors run the plain
    version; CUDA tensors run the kernel (Dh 64 or 128) or raise."""
    if _build.plain_path(q, k, v, padding_mask, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, padding_mask, do, lse, delta,
                                             causal=causal, sliding_window=sliding_window,
                                             offset=offset, scale=scale)
    fn = _fn("gritlm_flash_bwd_dkv", "flash_attention_bwd")
    head, tail, _mask = _bwd_args(q, k, v, padding_mask, do, lse, delta, causal,
                                  sliding_window, offset, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _build.check(fn(*head, dk.data_ptr(), dv.data_ptr(), *tail), "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, padding_mask, out, lse, do, *, causal,
                        sliding_window=None, offset=0):
    """The backward from the forward's saved output and LSE: delta by torch
    ops, then K4 and K5 (their plain versions on CPU tensors). On CUDA
    tensors of a head dim without an instance, q, k, v and dO are
    zero-padded to the kernels' width and the gradients sliced back, with
    the scale of the true head dim. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    Dh = q.shape[3]
    kw = dict(causal=causal, sliding_window=sliding_window, offset=offset, scale=Dh ** -0.5)
    do = do.contiguous()
    delta = attention_delta(out, do)
    Dk = Dh if _build.plain_path(q, k, v, padding_mask, do) else kernel_head_dim(Dh)
    if Dk != Dh:
        q, k, v, do = (_pad_heads(t, Dk) for t in (q, k, v, do))
    dq = flash_attention_bwd_dq(q, k, v, padding_mask, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, padding_mask, do, lse, delta, **kw)
    if Dk != Dh:
        dq, dk, dv = (g[..., :Dh] for g in (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash backward: the forward runs K1 with its LSE
    output and saves q, k, v, the mask, the output and the LSE (unpadded);
    the backward runs K4 and K5 (on CPU tensors, the plain versions of all
    three). Head dims 64 and 128 run their own instances, other multiples
    of 8 below 128 the 128 ones through the zero pad (forward and backward
    each pad their own copies); a head dim above 128 raises
    NotImplementedError."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, causal: bool, sliding_window, offset: int):
        out, lse = flash_attention(q, k, v, padding_mask, causal=causal,
                                   sliding_window=sliding_window, offset=offset,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, padding_mask, out, lse)
        ctx.kw = dict(causal=causal, sliding_window=sliding_window, offset=offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, padding_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, padding_mask, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None
