"""Attention entry points (port of gritlm_tpu.ops.attention).

`multi_head_attention` (no cache) goes to the flash attention kernel (K1)
for every query length, and when autograd records (training) to
`flash_attention.FlashAttentionFn`: K1 with its LSE output, then the flash
backward (K4, K5); `cached_attention` goes to the flash decode kernel
(K3) below 128 queries and to K1 on the cache layer's view above. The
serving decode step calls `cached_attention` with S = 1, causal=False,
offset 0 and no window (mask-bounded, per-row write slots), and the
speculative verify chunk with S = k + 1, causal, the window and a [B]
tensor of per-row offsets (always K3); over a paged pool the transformer
calls `paged_attention.paged_decode` (K8) instead, as the JAX package does. On CPU tensors each kernel wrapper runs its plain
version. `mha_reference` is the independent einsum oracle the tests hold
the kernels against.

Head dims: every path takes the call's Dh from q (the cache row is
Kv * Dh). On CUDA tensors K3 and K8 run Dh 64, 96 and 128; K1, and in
training (`FlashAttentionFn`) K1 with K4 and K5, run 64 and 128 and
zero-pad other multiples of 8 below 128 to 128, with the true Dh^-0.5 as
the softmax scale; a head dim above 128 raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gritlm_tpu_torch.ops import decode_attention, flash_attention

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_bias(
    padding_mask: Optional[torch.Tensor],  # [B, Sk] 1 = attend, 0 = pad
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: Union[int, torch.Tensor] = 0,
    dtype=torch.float32,
) -> Optional[torch.Tensor]:
    """Additive attention bias [B or 1, 1, Sq, Sk]; `offset` is the absolute
    position of query row 0, one int or a [B] tensor (each row its own,
    the serving row offsets)."""
    biases = []
    device = padding_mask.device if padding_mask is not None else None
    if causal:
        if isinstance(offset, torch.Tensor):  # [B] per-row offsets -> [B, Sq, 1]
            q_pos = offset.to(device)[:, None, None] + torch.arange(q_len, device=device)[
                None, :, None]
        else:
            q_pos = (offset + torch.arange(q_len, device=device)[:, None])[None]
        k_pos = torch.arange(kv_len, device=device)[None, None, :]
        keep = k_pos <= q_pos
        if sliding_window is not None:
            keep &= k_pos > q_pos - sliding_window
        biases.append(torch.where(keep, 0.0, NEG_INF)[:, None, :, :])
    if padding_mask is not None:
        pad = torch.where(padding_mask.bool(), 0.0, NEG_INF)
        biases.append(pad[:, None, None, :])
    if not biases:
        return None
    out = biases[0]
    for b in biases[1:]:
        out = out + b
    return out.to(dtype)


def mha_reference(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    bias: Optional[torch.Tensor],  # [B or 1, 1 or H, Sq, Sk] additive
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention, fp32 softmax. Returns [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    groups = h // hkv
    qg = q.reshape(b, sq, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if bias is not None:
        if bias.shape[1] == 1:
            scores = scores + bias[:, :, None, :, :]
        else:
            scores = scores + bias.reshape(bias.shape[0], hkv, groups, *bias.shape[2:])
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor],
    *,
    causal: bool,
    sliding_window: Optional[int] = None,
    offset: int = 0,
) -> torch.Tensor:
    """Self-attention without a cache. q [B,Sq,H,D], k/v [B,Sk,Hkv,D]. Under
    autograd (grad enabled and an input that requires grad) it goes through
    FlashAttentionFn; inference keeps the plain K1 call, which writes no
    LSE."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention.FlashAttentionFn.apply(q, k, v, padding_mask, causal,
                                                      sliding_window, offset)
    return flash_attention.flash_attention(
        q, k, v, padding_mask, causal=causal, sliding_window=sliding_window,
        offset=offset,
    )


def cached_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k_all: torch.Tensor,  # [L, B, Smax, Kv*Dh], the full KV cache
    v_all: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # [B, Smax] slot validity
    *,
    layer: int,
    offset: Union[int, torch.Tensor],  # one int, or [B] per-row offsets
    causal: bool,
    sliding_window: Optional[int] = None,
    num_kv_heads: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 cache: [L, B, Kv, Smax]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention against one layer of the full KV cache: the decode kernel
    for few queries (it dequantizes an int8 cache itself) and for per-row
    offsets (the speculative verify chunk; K1 takes one offset), the flash
    kernel on the layer's view otherwise (an int8 layer is dequantized
    first)."""
    B, Sq, H, Dh = q.shape
    L, _, Smax, KD = k_all.shape
    hkv = num_kv_heads if num_kv_heads is not None else KD // Dh
    if Sq < 128 or isinstance(offset, torch.Tensor):
        return decode_attention.flash_decode(
            q, k_all, v_all, kv_mask,
            causal=causal, sliding_window=sliding_window,
            offset=offset, layer=layer, num_kv_heads=hkv,
            k_scale=k_scale, v_scale=v_scale,
        )
    if k_scale is not None:
        lk = decode_attention.dequantize_layer(k_all, k_scale, layer, hkv, q.dtype)
        lv = decode_attention.dequantize_layer(v_all, v_scale, layer, hkv, q.dtype)
    else:
        lk = k_all[layer].view(B, Smax, hkv, Dh)
        lv = v_all[layer].view(B, Smax, hkv, Dh)
    return flash_attention.flash_attention(
        q, lk, lv, kv_mask,
        causal=causal, sliding_window=sliding_window, offset=offset,
    )
