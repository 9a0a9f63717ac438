"""Autoregressive generation with a static-shape KV cache (port of
gritlm_tpu.generate).

Prefill, then a Python loop of one-token decode steps (the JAX package's
`lax.scan`). Generation may start from a pre-filled cache (RAG doc/query
cache reuse): the cache is written slots plus a slot-validity mask.
Positions follow the running per-row count of valid tokens, so right-padded
prompts and caches with pad holes decode correctly. The cache passed in is
written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models.transformer import (
    KVCache,
    forward,
    init_cache,
    logits_from_hidden,
)


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor  # [B, max_new_tokens] generated ids (pad after eos)
    num_valid: torch.Tensor  # [B] count of tokens up to and including eos
    cache: KVCache
    # speculative decoding only: the verify steps taken (acceptance rate =
    # (sum(num_valid) - B) / (B * spec_steps) proposals a step)
    spec_steps: Optional[int] = None


def _prompt_positions(prev_valid: torch.Tensor, step_mask: torch.Tensor) -> torch.Tensor:
    """prev_valid [B] (valid tokens already in cache), step_mask [B, S] ->
    positions [B, S] continuing each row's token count across pad holes."""
    cum = torch.cumsum(step_mask, dim=1) - 1
    return prev_valid[:, None] + cum.clamp_min(0)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        logits = nucleus_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Top-p: mask everything outside the smallest prefix of the sorted
    distribution with cumulative mass >= top_p (the top token always
    survives). fp32 throughout."""
    lf = logits.float()
    sort = torch.sort(lf, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sort, dim=-1), dim=-1)
    cut = (cum < top_p).sum(dim=-1)  # [B]
    kth = torch.gather(sort, -1, cut[..., None])
    return logits.masked_fill(lf < kth, float("-inf"))


@torch.inference_mode()
def generate(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, S] right-padded prompt
    attention_mask: torch.Tensor,  # [B, S]
    cache: KVCache,  # pre-sized (and possibly pre-filled); written in place
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int = 16,
    min_new_tokens: int = 0,  # suppress EOS for the first N tokens
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int = 2,
    pad_id: int = 2,
) -> GenerateResult:
    B, S = input_ids.shape
    dev = input_ids.device

    # ---- prefill
    prev_valid = cache.mask.sum(dim=1)
    positions = _prompt_positions(prev_valid, attention_mask)
    hidden, cache, _ = forward(params, cfg, input_ids, attention_mask=attention_mask,
                               causal=True, positions=positions, cache=cache)
    # logits only at each row's last valid prompt token
    last_idx = torch.argmax(
        torch.where(attention_mask > 0, torch.arange(S, device=dev)[None, :], -1), dim=1)
    last_hidden = hidden[torch.arange(B, device=dev), last_idx]
    logits = logits_from_hidden(params, cfg, last_hidden[:, None, :])[:, 0]
    if min_new_tokens >= 1:
        logits[:, eos_id] = float("-inf")
    tok = _sample(logits, generator, temperature, top_k, top_p)
    done = tok == eos_id
    tokens = [tok]

    for i in range(1, max_new_tokens):
        step_mask = (~done).to(torch.int32)[:, None]
        pos = cache.mask.sum(dim=1)[:, None]
        hidden, cache, _ = forward(params, cfg, tok[:, None], attention_mask=step_mask,
                                   causal=True, positions=pos, cache=cache)
        logits = logits_from_hidden(params, cfg, hidden)[:, 0]
        if i < min_new_tokens:
            logits[:, eos_id] = float("-inf")
        nxt = _sample(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
        tok = nxt
        tokens.append(nxt)

    tokens = torch.stack(tokens, dim=1)
    is_eos = tokens == eos_id
    seen_eos = torch.cumsum(is_eos.to(torch.int32), dim=1)
    valid = (seen_eos == 0) | (is_eos & (seen_eos == 1))
    tokens = torch.where(valid, tokens, torch.full_like(tokens, pad_id))
    return GenerateResult(tokens=tokens, num_valid=valid.sum(dim=1), cache=cache)


def align_cache_len(n: int) -> int:
    """Slot-count alignment: 128 below 1k, else 1024."""
    if n <= 1024:
        return ((n + 127) // 128) * 128
    return ((n + 1023) // 1024) * 1024


def make_cache_for_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                          max_new_tokens: int, extra: int = 0, dtype=None, device=None,
                          quant: bool = False) -> KVCache:
    total = align_cache_len(prompt_len + max_new_tokens + extra)
    return init_cache(cfg, batch, total, dtype=dtype, device=device, quant=quant)


def concat_caches(a: KVCache, b: KVCache, total_len: Optional[int] = None) -> KVCache:
    """Concatenate two caches along the slot axis (the querydoc/docquery RAG
    modes): each cache is cut to its `length`, so the result stays dense in
    slot space; masked-out slots in either part stay masked. `total_len`
    sizes the output directly, with empty masked slots at the tail, so a
    later pad_cache_to is a no-op. Int8 scales are slot-minor
    [L, B, Kv, Smax] and concatenate on their last axis."""
    if a.quantized != b.quantized:
        raise ValueError("concat_caches: cannot concatenate an int8 cache with a bf16 one")
    la, lb = int(a.length), int(b.length)
    total = max(la + lb, total_len or 0)

    def cat(xa: torch.Tensor, xb: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(xa.shape)
        shape[dim] = total
        out = xa.new_zeros(shape)
        out.narrow(dim, 0, la).copy_(xa.narrow(dim, 0, la))
        out.narrow(dim, la, lb).copy_(xb.narrow(dim, 0, lb))
        return out

    scales = {}
    if a.quantized:
        scales = dict(k_scale=cat(a.k_scale, b.k_scale, 3), v_scale=cat(a.v_scale, b.v_scale, 3))
    return KVCache(k=cat(a.k, b.k, 2), v=cat(a.v, b.v, 2), mask=cat(a.mask, b.mask, 1),
                   length=la + lb, **scales)


def pad_cache_to(cache: KVCache, total_len: int) -> KVCache:
    """Grow the slot axis with empty (masked-out) slots up to total_len; a
    cache that is already long enough is returned as it is."""
    pad = total_len - cache.max_len
    if pad <= 0:
        return cache

    def grow(x: torch.Tensor) -> torch.Tensor:  # the slot axis is the last but one
        return torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))], dim=-2)

    def grow_last(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)

    return KVCache(
        k=grow(cache.k), v=grow(cache.v), mask=grow_last(cache.mask), length=cache.length,
        k_scale=grow_last(cache.k_scale) if cache.quantized else None,
        v_scale=grow_last(cache.v_scale) if cache.quantized else None,
    )
