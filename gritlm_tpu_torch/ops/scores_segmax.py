"""K9: fused scores + segment maxima of the flat index search, hand-written
for Hopper.

Replaces the Pallas kernel `kernel` of `FlatIndex._pallas_scores_segmax`
in `gritlm_tpu/index/flat.py`. Same function: one sweep over the corpus
`emb [N, D]` against a query block `q [Q, D]` (both bf16, or both fp32 as
the retrieval eval's index is) computes the
scores `q . emb^T` with fp32 accumulation, sets every column >= `n_docs` to
-inf (not the attention kernels' finite -1e30: a masked column must lose to
every real score), and emits the fp32 scores `[Q, N]` together with the
per-128-column segment maxima, transposed to `[ceil(N/128), Q]` as the JAX
kernel lays them out. A partial last segment takes its maximum over its
real columns. The segment maxima feed the segment-pruned exact top-k of
`FlatIndex.search`.

Kernel: `csrc/scores_segmax.cu`, CUDA C++ for sm_90a (not Triton: a
tensor-core product with an epilogue), bound with ctypes. What bounds it:
at the search's timing shape (Q = 256, N = 2^20, D = 4096) the bytes, one
read of the 8.6 GB corpus plus the 1.07 GB fp32 score write (2.9 ms at
3.35 TB/s), just above the 2.2 ms its 2.2 TFLOP take at the bf16 peak. The
design: a block holds the whole query block (up to 256 rows) against one
128-column corpus tile, so the corpus is read from device memory once per
query block; two consumer warpgroups own 128 query rows each as wgmma
accumulators in registers, a producer warp streams 64-deep slices of the
query block and of the corpus tile through a 4-stage TMA ring, and the grid
is persistent (one block an SM walking the tiles). The epilogue masks,
writes the scores and reduces each row's segment maximum straight from the
accumulators, so the scores are never read back. Q > 256 makes several
query blocks; tiles wholly past n_docs load nothing.

fp32 operands go to a second kernel in the same source
(`gritlm_scores_segmax_f32`): exact fp32 FMAs with fp32 sums, as the
Pallas kernel computes on an fp32 corpus (single-pass TF32 tensor cores
would round each operand to a 10-bit mantissa). It is bound by the fp32
FMA rate (about 67 TFLOP/s on an H100 SXM at 1.98 GHz): a block owns 64
query rows x one 128-column segment, each thread an 8 x 4 tile of sums fed
from shared memory, 32-deep slices of both operands staged by cp.async
through two buffers, and the same masked epilogue with the segment maxima
reduced by warp shuffles. Its launches count in `f32_launches`, the bf16
kernel's in `launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gritlm_tpu_torch.ops import _build

SEGMENT = 128  # columns per segment maximum (the JAX kernel's PALLAS_SEGMENT)
PLAIN_CHUNK_ROWS = 65536  # corpus rows per fp32 product in the plain version


def scores_segmax_plain(q: torch.Tensor, emb: torch.Tensor, n_docs: int):
    """The plain PyTorch version of K9 (same arguments and results as
    scores_segmax) for both kernels: it computes in fp32, so fp32 inputs
    are taken as they are (exact fp32 products and sums, as the fp32
    kernel's). It walks the corpus in row chunks, so its fp32 copy of the
    corpus stays bounded."""
    Q, N = q.shape[0], emb.shape[0]
    qf = q.float()
    scores = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    for a in range(0, N, PLAIN_CHUNK_ROWS):
        scores[:, a:a + PLAIN_CHUNK_ROWS] = qf @ emb[a:a + PLAIN_CHUNK_ROWS].float().T
    scores[:, max(0, min(int(n_docs), N)):] = float("-inf")
    ns = -(-N // SEGMENT)
    padded = F.pad(scores, (0, ns * SEGMENT - N), value=float("-inf"))
    segmax = padded.view(Q, ns, SEGMENT).amax(dim=-1).T.contiguous()
    return scores, segmax


# dtype of both operands -> (C entry, the D multiple of its 16-byte rows)
_ENTRIES = {torch.bfloat16: ("gritlm_scores_segmax", 8),
            torch.float32: ("gritlm_scores_segmax_f32", 4)}


def _bound(fn):
    """fn with its ctypes argument types set (both entries take the same)."""
    if fn.argtypes is None:
        P, I32 = _build.P, _build.I32
        fn.argtypes = [P] * 4 + [I32] * 4 + [P]
        fn.restype = I32
    return fn


def scores_segmax(q: torch.Tensor, emb: torch.Tensor, n_docs: int):
    """(scores [Q, N] fp32, segmax [ceil(N/128), Q] fp32) of the query block
    q [Q, D] against the corpus emb [N, D]; columns >= n_docs score -inf.
    CPU tensors run the plain version; CUDA tensors run the kernel of their
    dtype (both bf16, or both fp32) or raise."""
    if _build.plain_path(q, emb):
        return scores_segmax_plain(q, emb, n_docs)
    lib = _build.load("scores_segmax")
    if q.dtype != emb.dtype or q.dtype not in _ENTRIES:
        raise TypeError(f"scores_segmax: q {q.dtype} and emb {emb.dtype} must be both "
                        "bfloat16 or both float32")
    entry, d_mult = _ENTRIES[q.dtype]
    fn = _bound(getattr(lib, entry))
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1] or q.shape[1] % d_mult:
        raise NotImplementedError(
            f"scores_segmax: q {tuple(q.shape)}, emb {tuple(emb.shape)} (same D, "
            f"D % {d_mult} == 0 for {q.dtype})")
    if not (q.is_contiguous() and emb.is_contiguous()) or q.data_ptr() % 16 \
            or emb.data_ptr() % 16:
        raise ValueError("scores_segmax: q and emb must be contiguous and 16-byte aligned")
    (Q, D), N = q.shape, emb.shape[0]
    if N >= 2**31:
        raise NotImplementedError(f"scores_segmax: {N} corpus rows (the kernel takes < 2^31)")
    scores = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    segmax = torch.empty((-(-N // SEGMENT), Q), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), emb.data_ptr(), scores.data_ptr(), segmax.data_ptr(), Q, N, D,
            max(0, min(int(n_docs), N)), _build.stream_of(q))
    _build.check(rc, "scores_segmax")
    if q.dtype == torch.float32:
        scores_segmax.f32_launches += 1
    else:
        scores_segmax.launches += 1
    return scores, segmax


scores_segmax.launches = 0
scores_segmax.f32_launches = 0
