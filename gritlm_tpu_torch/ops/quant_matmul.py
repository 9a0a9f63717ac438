"""K6 and K7: matrix products against quantized weights (w8a16, w4a16),
hand-written for Hopper.

K6 `w8a16_matmul` replaces the Pallas kernel `_kernel8` of
`gritlm_tpu/ops/quant_matmul.py` (reached through `_w8_call` and
`w8a16_matmul`): y = (x @ q8) * scale, x bf16 [..., K], q8 int8 [K, N],
scale fp32 [1, N] per output channel; fp32 sums, the scale applied once at
the end, bf16 out. K7 `w4a16_matmul` replaces `_kernel` (through `_w4_call`
and `w4a16_matmul`): y = x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi) for the
half-split packed uint8 [K/2, N] and fp32 group scales [K/g, N], where
deq = (nibble - 8) * scale in fp32, rounded to bf16 per weight (the
reference's rounding), fp32 sums, bf16 out. Layouts: training/quant.py.

Kernels: `csrc/quant_matmul.cu`, CUDA C++ for sm_90a (not Triton: tensor-core
products with the dequantization fused into the operand), bound with
ctypes. What bounds them at decode rows (M <= 16): the bytes, one read of
the weight (1 byte a weight for K6; 0.5 plus 0.125 of scales for K7); and,
since each weight is turned into a bf16 operand in registers, the
instructions spent on each weight (K7 measured bound by instruction issue).
So a kernel keeps the weight stream flowing on every SM with no block
barrier in its main loop, and spends a few ALU instructions a weight.

At decode rows both run a rows kernel (`w4_rows_kernel`, `w8_rows_kernel`):
y^T = W^T x^T with `mma.sync.m16n8k16`, so the weight is the A operand
(output columns on the MMA's 16-row side) and decode rows fill its 8-wide
side with no padding (a block takes 8 rows up to M 8, else 16, and more
rows take more blocks). Each lane turns whole 16-byte runs of weight rows
into A fragments in registers, with no bf16 tile in shared memory: each of
a block's 4 warps streams its own run of the contracting axis through a
private cp.async ring of 4 raw-byte stages (32 contracting rows each), and
the block that owns 128 columns sums its warps' partials in shared memory.
  - K7 reads two packed rows a lane (low nibbles k slots 2t, 2t+1, high
    nibbles 2t+8, 2t+9: contracting rows r and K/2 + r), a byte permute,
    an fp32 add and multiply a weight and one `cvt.rn.bf16x2` a pair, with
    the group's scales loaded once a group.
  - K6 reads int8 rows 2t, 2t+1, 2t+8, 2t+9 of each 16-row k-step: a byte
    permute under the exponent of 2^23 and one fp32 add make each weight an
    exact float (|q| <= 127), a second permute packs two floats' upper
    halves into a bf16x2 (as fast as `cvt.rn.bf16x2.f32`, measured), and
    the per-channel scale multiplies each column once, after the sums.
At decode a projection has few column tiles (wk/wv: 8 of them), so the
contracting axis is also split across blocks (`plan_rows`: each warp two
stages or more, and about two blocks an SM over the column tiles for K7,
one for K6, whose stages carry twice the weight bytes; the best split
counts measured on the card); the block that finishes a tile last adds the
tile's fp32 partial sums in split order, scales (K6) and rounds, so a call
is one launch and reruns are bit-equal.

Above W8_ROWS_MAX rows K6 runs the staged template: blocks of 4 warps own
a 64 x 128 output tile and walk the contracting axis in stages of 128 rows,
the raw int8 bytes copied by cp.async, turned into a bf16 tile in shared
memory and fed to bf16 wmma with fp32 accumulators; split-K as above
(`plan`). It reads and converts the weight once for 64 rows, where the rows
kernel does so for every 16, which is why it wins above W8_ROWS_MAX rows
(measured on the card, PERF.md). K7's rows kernel beat it at 64 and 128
rows, so K7 has no other kernel. The TPU kernels held the layer stack and a
prefetched layer index so that the scan never copied a layer; here each
layer's weights are a view of the stack (`models/transformer._unstack`)
whose pointer goes to the kernel as it is.

Routing, as in the JAX package (`kernel_rows`): up to MAX_KERNEL_ROWS8 (K6)
or MAX_KERNEL_ROWS (K7) rows, a CUDA tensor launches a kernel or raises and
a CPU tensor takes the plain version; more rows dequantize the layer once
to x's dtype and multiply (`torch.matmul`), which is the function the
reference runs at those row counts (`_reference8`, `_reference`).

Activations of either float dtype, as the JAX wrappers take them: the
result is in x's dtype. At the kernel's rows a CUDA call casts fp32 x to
bf16 for the kernel (the JAX wrappers' `x2.astype(bfloat16)`) and its bf16
output to fp32; a CPU call runs the plain version on x as it is, which for
fp32 x is the fp32 product the JAX wrappers compute off the TPU (their
reference). Above those rows fp32 x multiplies an fp32 dequantized weight,
outside any kernel, on either device. float16 x raises TypeError on CUDA.
"""

from __future__ import annotations

import math
import torch

from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.training import quant

MAX_KERNEL_ROWS8 = 512  # K6 row ceiling (the JAX package's MAX_KERNEL_ROWS8)
MAX_KERNEL_ROWS = 128  # K7 row ceiling (its MAX_KERNEL_ROWS)
W8_ROWS_MAX = 256  # K6's rows kernel up to here, its staged template above (PERF.md)
BN = 128  # output columns per block (csrc/quant_matmul.cu)
DK = 128  # contracting rows per stage of the staged template
BM = 64  # rows a block of the staged template
BLOCKS_PER_SM = 2  # shared memory (100 KB a block) allows two a SM
MAX_SPLITS = 32
W4_STAGE = 16  # packed rows a stage of w4_rows_kernel (32 contracting rows)
W8_STAGE = 32  # contracting rows a stage of w8_rows_kernel
ROWS_WARPS = 4  # warps a block of a rows kernel, each on its own run of the block's stages
W4_SPLIT_BLOCKS_PER_SM = 2  # K7's split target, of the three an SM holds (57-64 KB of rings)
W8_SPLIT_BLOCKS_PER_SM = 1  # K6's: a stage carries twice K7's weight bytes (72-80 KB of rings)
ROWS_MIN_STAGES = 2  # a warp's least stages in a split


def plan(M: int, stages: int, N: int, sms: int):
    """(bm, splits, stages per split) of K6's staged template for M rows,
    `stages` contracting stages of DK rows and N columns. Blocks run in
    waves of BLOCKS_PER_SM * sms; a split plan's time goes as (waves) x
    (stages a block walks + about one stage of fixed cost), so the plan
    takes the split count that minimises it, the fewest splits among equals
    (each split adds fp32 partial sums). Every split walks the same number
    of stages."""
    tiles = -(-N // BN) * -(-M // BM)
    slots = BLOCKS_PER_SM * sms
    best = None
    for s in range(1, min(stages, MAX_SPLITS) + 1):
        kper = -(-stages // s)
        splits = -(-stages // kper)
        cost = -(-tiles * splits // slots) * (kper + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, kper)
    return BM, best[1], best[2]


def plan_rows(M: int, stages: int, N: int, sms: int, blocks_per_sm: int):
    """(bm, splits, stages per split) of a rows kernel (K6's, K7's) with M
    rows, `stages` contracting stages of 32 rows and N columns: bm 8
    (M <= 8) or 16 rows a block. Splits give about `blocks_per_sm` blocks an
    SM over the column tiles (the blocks of more rows read the same weight
    tiles, mostly from L2), but each warp ROWS_MIN_STAGES stages or more: a
    split's fix-up costs about what a warp's stage does. Measured on the
    card (PERF.md), this rule picked the fastest split count at every
    projection with two blocks an SM for K7 and one for K6."""
    bm = 8 if M <= 8 else 16
    splits = max(1, min(blocks_per_sm * sms // -(-N // BN),
                        stages // (ROWS_WARPS * ROWS_MIN_STAGES), MAX_SPLITS))
    kper = -(-stages // splits)
    return bm, -(-stages // kper), kper


def plan_w4(M: int, Kp: int, N: int, sms: int):
    """K7's plan for Kp packed rows (a multiple of 16: the group divides
    K/2): `plan_rows` over stages of W4_STAGE packed rows."""
    return plan_rows(M, Kp // W4_STAGE, N, sms, W4_SPLIT_BLOCKS_PER_SM)


def plan_w8(M: int, K: int, N: int, sms: int):
    """K6's plan for M rows: the rows kernel's (`plan_rows` over stages of
    W8_STAGE contracting rows, the last one short when 32 does not divide
    K) up to W8_ROWS_MAX rows, the staged template's (`plan`) above."""
    if M <= W8_ROWS_MAX:
        return plan_rows(M, -(-K // W8_STAGE), N, sms, W8_SPLIT_BLOCKS_PER_SM)
    return plan(M, -(-K // DK), N, sms)


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def kernel_rows(M: int, bits: int) -> bool:
    """Whether a product of M rows takes the kernel's route: K6 (`bits` 8)
    up to MAX_KERNEL_ROWS8 rows, K7 (4) up to MAX_KERNEL_ROWS, the row
    ceilings of the JAX wrappers' `use_kernel`. Above them the layer is
    dequantized to x's dtype and multiplied."""
    return M <= (MAX_KERNEL_ROWS8 if bits == 8 else MAX_KERNEL_ROWS)


def w8a16_matmul_plain(x: torch.Tensor, node: dict) -> torch.Tensor:
    """The plain PyTorch version of K6: the int8 weights exactly in fp32,
    fp32 sums, the per-channel scale at the end, cast to x's dtype."""
    y = x.float() @ node["q8"].float()
    return (y * node["scale"].float()).to(x.dtype)


def w4a16_matmul_plain(x: torch.Tensor, node: dict) -> torch.Tensor:
    """The plain PyTorch version of K7: each weight (nibble - 8) * group
    scale in fp32, cast to x's dtype (rows in unpacked order, so x @ W is
    x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi)), fp32 sums, cast."""
    w = quant.dequantize_kernel_int4(node, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def _fn(name: str):
    fn = getattr(_build.load("quant_matmul"), name)
    if fn.argtypes is None:
        P, I32 = _build.P, _build.I32
        n_ints = 6 if name == "gritlm_w8a16_matmul" else 7  # w4 adds the group
        fn.argtypes = [P] * 6 + [I32] * n_ints + [P]
        fn.restype = I32
    return fn


def _launch(fn, what: str, x2, q, scale, M, K, N, planned, *group):
    """Allocate the output and the split partials of a plan, launch."""
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    bm, splits, kper = planned
    part = counters = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=x2.device)
        counters = _build.counters(x2.device, -(-N // BN) * -(-M // bm))
    rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), M, K, N, *group, bm, splits,
            kper, _build.stream_of(x2))
    _build.check(rc, what)
    return out


def _x_rows(x: torch.Tensor, K: int, what: str) -> torch.Tensor:
    """x as a contiguous, 16-byte aligned [M, K] bf16 matrix (an activation:
    a copy here is cheap, unlike one of the weights); fp32 x is cast to
    bf16, as the JAX wrappers cast it for their kernels."""
    if x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    elif x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: x is {x.dtype}; the kernel takes bfloat16 or float32 "
                        "activations")
    x2 = x.reshape(-1, K).contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2


def _check_weight(t: torch.Tensor, name: str, what: str) -> None:
    """The kernel reads a weight leaf (or a layer's view of a stack) in
    place: it must be contiguous and 16-byte aligned; nothing is copied."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned (a layer "
                         "view of a contiguous stack is; the kernel never copies a weight)")


def w8a16_matmul(x: torch.Tensor, node: dict) -> torch.Tensor:
    """x [..., K] @ dequant(node) -> [..., N] for an int8 leaf {"q8" [K, N],
    "scale" [1, N]}, in x's dtype."""
    q8, scale = node["q8"], node["scale"]
    K, N = q8.shape[-2:]
    if x.shape[-1] != K:
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)} against q8 {tuple(q8.shape)}")
    M = _rows(x)
    if not kernel_rows(M, 8):
        return x @ quant.dequantize_kernel(node, x.dtype)
    if _build.plain_path(x, q8, scale):
        return w8a16_matmul_plain(x, node)
    fn = _fn("gritlm_w8a16_matmul")
    if q8.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"w8a16_matmul: q8 {q8.dtype} / scale {scale.dtype} must be int8 / float32")
    if q8.dim() != 2 or tuple(scale.shape) != (1, N) or K % 16 or N % 16:
        raise NotImplementedError(
            f"w8a16_matmul: q8 {tuple(q8.shape)}, scale {tuple(scale.shape)} (2-D, K and N "
            "multiples of 16)")
    _check_weight(q8, "q8", "w8a16_matmul")
    _check_weight(scale, "scale", "w8a16_matmul")
    x2 = _x_rows(x, K, "w8a16_matmul")
    if M == 0:
        return torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    out = _launch(fn, "w8a16_matmul", x2, q8, scale, M, K, N,
                  plan_w8(M, K, N, _build.sm_count(x.device)))
    w8a16_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N).to(x.dtype)


def w4a16_matmul(x: torch.Tensor, node: dict) -> torch.Tensor:
    """x [..., K] @ dequant(node) -> [..., N] for an int4 leaf {"q4" [K/2, N],
    "scale" [K/g, N]}, in x's dtype."""
    q4, scale = node["q4"], node["scale"]
    Kp, N = q4.shape[-2:]
    K = 2 * Kp
    if x.shape[-1] != K:
        raise ValueError(f"w4a16_matmul: x {tuple(x.shape)} against q4 {tuple(q4.shape)}")
    M = _rows(x)
    if not kernel_rows(M, 4):
        return x @ quant.dequantize_kernel_int4(node, x.dtype)
    if _build.plain_path(x, q4, scale):
        return w4a16_matmul_plain(x, node)
    fn = _fn("gritlm_w4a16_matmul")
    if q4.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"w4a16_matmul: q4 {q4.dtype} / scale {scale.dtype} must be uint8 / float32")
    G = scale.shape[-2]
    g = K // G if G and K % G == 0 else 0
    if (q4.dim() != 2 or scale.dim() != 2 or scale.shape[1] != N or g % 16 or g == 0
            or (64 % g and g % 64) or Kp % g or N % 16):
        raise NotImplementedError(
            f"w4a16_matmul: q4 {tuple(q4.shape)}, scale {tuple(scale.shape)} (2-D; a group of "
            "16, 32, 64 or a multiple of 64 rows that divides K/2; N a multiple of 16)")
    _check_weight(q4, "q4", "w4a16_matmul")
    _check_weight(scale, "scale", "w4a16_matmul")
    x2 = _x_rows(x, K, "w4a16_matmul")
    if M == 0:
        return torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    out = _launch(fn, "w4a16_matmul", x2, q4, scale, M, K, N,
                  plan_w4(M, Kp, N, _build.sm_count(x.device)), g)
    w4a16_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N).to(x.dtype)


w8a16_matmul.launches = 0
w4a16_matmul.launches = 0
