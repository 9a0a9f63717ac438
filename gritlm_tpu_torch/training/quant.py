"""Weight quantization: int8 (w8a16 serving, the QLoRA frozen base) and
group-wise int4 (w4a16 serving). Port of gritlm_tpu.training.quant.

The layouts are the JAX package's, byte for byte:

  int8:  {"q8": int8 [..., K, N], "scale": f32 [..., 1, N]}
         symmetric absmax over the contracting axis, one scale per output
         channel, q = clip(round(w / scale), -127, 127);
  int4:  {"q4": uint8 [..., K/2, N], "scale": f32 [..., K/g, N]}
         groups of g contracting rows share an absmax/7 scale; values are
         offset-binary (nibble - 8); the LOW nibble of packed row r is
         contracting row r and the HIGH nibble row r + K/2 (half-split), so a
         matmul reads x as the two contiguous halves x[:, :K/2], x[:, K/2:].
         Scale rows are in unpacked-row order (the lo half's groups, then the
         hi half's).

`torch.round` rounds half to even, as `jnp.round` does. A stacked [L, K, N]
kernel is quantized and dequantized one layer at a time, so no fp32 copy of
a whole stack (7.5 GB for Mistral-7B's MLP) ever exists. Serving reads the
quantized leaves through ops/quant_matmul (kernels K6, K7) at decode row
counts; everything else (prefill, encode, the QLoRA training forward)
dequantizes one layer at a time in models/transformer._w.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

# Contracting-dim group of the int4 scale (the JAX package's choice): fp32
# scales add 0.125 bytes a weight to the 0.5 of the nibbles.
INT4_GROUP_SIZE = 32


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and ("q8" in node or "q4" in node) and "scale" in node


def _mats(t: torch.Tensor) -> torch.Tensor:
    """t [..., a, b] as [n, a, b], one matrix per leading index (a view
    for the contiguous tensors this module allocates)."""
    return t.reshape(-1, *t.shape[-2:])


@torch.no_grad()
def quantize_kernel(w: torch.Tensor) -> dict:
    """Symmetric absmax int8 over the contracting (second-to-last) axis: one
    fp32 scale per output channel, broadcastable against the int8 tensor."""
    *lead, K, N = w.shape
    q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, 1, N), dtype=torch.float32, device=w.device)
    for layer, q_out, s_out in zip(_mats(w), _mats(q8), _mats(scale)):
        wf = layer.float()
        s = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127.0
        q_out.copy_(torch.round(wf / s).clamp(-127, 127).to(torch.int8))
        s_out.copy_(s)
    return {"q8": q8, "scale": scale}


@torch.no_grad()
def dequantize_kernel(node: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """q * scale in fp32, cast to `dtype`."""
    if "q4" in node:
        return dequantize_kernel_int4(node, dtype)
    q8, scale = node["q8"], node["scale"]
    out = torch.empty(q8.shape, dtype=dtype, device=q8.device)
    for q, s, o in zip(_mats(q8), _mats(scale), _mats(out)):
        o.copy_(q * s)  # int8 x fp32 promotes to fp32: float(q) * s
    return out


@torch.no_grad()
def quantize_kernel_int4(w: torch.Tensor, group_size=None) -> dict:
    """Group-wise symmetric int4 in the half-split packing (module
    docstring). The default group is gcd(K, 32): 32 at every real width,
    smaller for tiny test widths."""
    *lead, K, N = w.shape
    g = group_size if group_size is not None else math.gcd(K, INT4_GROUP_SIZE)
    if K % g or K % 2 or g % 2:
        raise ValueError(f"contracting dim {K} / group {g} must be even with {g} | {K}")
    q4 = torch.empty((*lead, K // 2, N), dtype=torch.uint8, device=w.device)
    scale = torch.empty((*lead, K // g, N), dtype=torch.float32, device=w.device)
    for layer, q_out, s_out in zip(_mats(w), _mats(q4), _mats(scale)):
        wf = layer.float().reshape(K // g, g, N)
        s = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 7.0
        q = torch.round(wf / s).clamp(-8, 7).to(torch.int32).reshape(K, N) + 8
        q_out.copy_(q[: K // 2] | (q[K // 2:] << 4))
        s_out.copy_(s[:, 0, :])
    return {"q4": q4, "scale": scale}


def unpack_int4(node: dict):
    """{"q4", "scale"} -> (values int32 [..., K, N] in [-8, 7], scale)."""
    packed = node["q4"].to(torch.int32)
    lo = (packed & 0xF) - 8  # contracting rows [0, K/2)
    hi = (packed >> 4) - 8  # contracting rows [K/2, K)
    return torch.cat([lo, hi], dim=-2), node["scale"]


@torch.no_grad()
def dequantize_kernel_int4(node: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """(nibble - 8) * group scale in fp32, cast to `dtype`, in unpacked-row
    order [..., K, N]."""
    q4, scale = node["q4"], node["scale"]
    *lead, Kp, N = q4.shape
    K, G = 2 * Kp, scale.shape[-2]
    out = torch.empty((*lead, K, N), dtype=dtype, device=q4.device)
    for q, s, o in zip(_mats(q4), _mats(scale), _mats(out)):
        vals, _ = unpack_int4({"q4": q, "scale": s})
        o.copy_((vals.float().view(G, K // G, N) * s[:, None, :]).view(K, N))
    return out


def quantize_tree(params: dict, targets: Sequence[str] = DEFAULT_TARGETS, bits: int = 8) -> dict:
    """Every targeted >= 3-D kernel (the stacked-layer layout) becomes a
    quantized leaf; other leaves pass through untouched (the same tensors)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    quantize = quantize_kernel if bits == 8 else quantize_kernel_int4

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path and path[-1] in targets and node.dim() >= 3:
            return quantize(node)
        return node

    return walk(params, ())


def quantize_for_serving(params: dict, targets: Sequence[str] = DEFAULT_TARGETS,
                         quantize_lm_head: bool = True, bits: int = 8) -> dict:
    """w8a16 / w4a16 inference quantization: every stacked layer kernel and
    (by default) the LM head; the embedding stays dense (a lookup table).
    Decode streams every weight once a step, so int8 halves the bytes it
    reads and int4 (with its scales) takes them to 0.625 a weight."""
    out = quantize_tree(params, targets, bits=bits)
    if quantize_lm_head and "lm_head" in out:
        quantize = quantize_kernel if bits == 8 else quantize_kernel_int4
        out = dict(out)
        out["lm_head"] = {"kernel": quantize(out["lm_head"]["kernel"])}
    return out


def dequantize_tree(params: dict, dtype=torch.bfloat16) -> dict:
    """Inverse of quantize_tree (the QLoRA export: merge, then dense HF)."""

    def walk(node):
        if is_quantized_leaf(node):
            return dequantize_kernel(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def quantized_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
