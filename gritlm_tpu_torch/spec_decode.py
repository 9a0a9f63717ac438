"""Prompt-lookup speculative decoding, greedy and draft-model-free (port of
gritlm_tpu.spec_decode).

Propose the next `k` tokens by matching the trailing n-gram of the text so
far against the prompt and what was generated, then verify all k + 1 in one
forward. Decode reads the whole KV cache for one token; a [B, k + 1] chunk
reads the same cache bytes once, so each accepted proposal is a token for
little more than the cost of one step. RAG answers quote their documents,
which is where prompt lookup finds its matches.

Output parity: the tokens of `generate.generate` at temperature 0. A
rejected proposal is replaced by the model's own argmax, so speculation
changes the time, never the text (tests/test_torch_spec_decode.py holds
this against the port's greedy generate and the JAX package).

Cache layout: the verify chunk is written at the scalar slot frontier
`cache.length` (K3 at one offset, Sq = k + 1); rows that accept fewer
proposals than the step's most leave masked-off slots behind (holes), as a
right-padded ragged prefill does. B = 1 decoding leaves no holes. Callers
size the cache with `spec_cache_extra`.

The loop: the JAX package runs a `lax.while_loop` on the device; here it is
a Python loop that reads the host once per verify step (the step's frontier
advance and whether every row is done, one small copy), since the cache's
write pointer `cache.length` is a Python int.
"""

from __future__ import annotations

import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.generate import GenerateResult, _prompt_positions
from gritlm_tpu_torch.models.transformer import KVCache, forward, logits_from_hidden


def spec_cache_extra(max_new_tokens: int, k: int, batch: int) -> int:
    """Slot slack to add when sizing a cache for speculative decoding. B = 1
    needs only the verify chunk's scratch (k slots past the last accepted
    token). B > 1 also pays for holes: each step advances the frontier by
    the fastest row's acceptance while slower rows leave masked slots
    behind; max_new_tokens of slack covers the workloads seen, and when the
    slots run out the loop stops early with valid tokens."""
    return k if batch == 1 else max_new_tokens + k


def _lookup_proposals(history: torch.Tensor, hist_len: torch.Tensor, ngram: int, k: int,
                      pad_id: int) -> torch.Tensor:
    """history [B, H] (prompt + generated, dense), hist_len [B] -> [B, k]:
    for each row the k tokens that followed the most recent earlier
    occurrence of its trailing `ngram` tokens; pad_id where there is no
    match (verification rejects them)."""
    B, H = history.shape
    dev = history.device
    pos = torch.arange(H, device=dev)
    hlen = hist_len.long()
    start = (hlen - ngram).clamp(0, max(H - ngram, 0))
    tail = history.gather(1, start[:, None] + torch.arange(ngram, device=dev)[None, :])
    match = torch.ones((B, H), dtype=torch.bool, device=dev)
    for t in range(ngram):  # windows[p] == history[p : p + ngram], all at once
        match &= torch.roll(history, -t, dims=1) == tail[:, t:t + 1]
    # the window ends before the trailing n-gram itself
    match &= (pos[None, :] + ngram) <= (hlen - ngram)[:, None]
    p = torch.where(match, pos[None, :], torch.full_like(match, -1, dtype=torch.long)).amax(1)
    idx = p[:, None] + ngram + torch.arange(k, device=dev)[None, :]
    found = history.gather(1, idx.clamp(0, H - 1))
    ok = (p >= 0)[:, None] & (idx < hlen[:, None])
    return torch.where(ok, found, torch.full_like(found, pad_id))


def _accept(proposals: torch.Tensor, greedy: torch.Tensor, active: torch.Tensor,
            budget: torch.Tensor, eos_id: int):
    """One verify step's outcome per row, from its k proposals and the
    model's greedy tokens after each prefix of [pending token, proposals]
    ([B, k + 1]): (emit_tok, n_emit, n_slots, hit_eos). emit_tok [B, k + 1]
    is the longest accepted prefix of the proposals, a tokens, then the
    model's bonus token at position a; n_emit counts the emitted
    tokens, cut after the first EOS and at the row's token budget (0 for an
    inactive row); n_slots the chunk's cache slots that stay valid (the
    pending token's and one per emitted proposal); hit_eos whether an EOS
    was emitted."""
    k = proposals.shape[1]
    j = torch.arange(k + 1, device=proposals.device)[None, :]
    a = torch.cumprod((proposals == greedy[:, :k]).long(), dim=1).sum(dim=1)
    emit_tok = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
    emit_tok = torch.where(j == a[:, None], greedy.gather(1, a[:, None]), emit_tok)
    is_eos = (emit_tok == eos_id).long()
    before = torch.cumsum(is_eos, dim=1) - is_eos
    n_emit = torch.minimum(a + 1, (before == 0).long().sum(dim=1))
    n_emit = torch.minimum(n_emit, budget.long())
    n_emit = torch.where(active, n_emit, torch.zeros_like(n_emit))
    n_slots = torch.where(active, 1 + torch.minimum(a, n_emit), torch.zeros_like(a))
    hit_eos = ((is_eos > 0) & (j < n_emit[:, None])).any(dim=1)
    return emit_tok, n_emit, n_slots, hit_eos


@torch.inference_mode()
def generate_speculative(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, S] right-padded prompt
    attention_mask: torch.Tensor,  # [B, S]
    cache: KVCache,  # pre-sized (and possibly pre-filled); written in place
    *,
    max_new_tokens: int = 16,
    ngram: int = 3,
    k: int = 7,
    eos_id: int = 2,
    pad_id: int = 2,
) -> GenerateResult:
    """Greedy decode with prompt-lookup speculation; the contract of
    generate.generate(temperature=0.0), plus `spec_steps`, the verify steps
    taken. The lookup corpus is the prompt plus what was generated (a
    cache's text is not in it: pass documents in the prompt, or accept
    lookup over the visible part)."""
    B, S = input_ids.shape
    dev = input_ids.device
    Smax = cache.max_len
    ar = torch.arange(k + 1, device=dev)[None, :]

    # ---- prefill (as generate.generate)
    prev_valid = cache.mask.sum(dim=1)
    positions = _prompt_positions(prev_valid, attention_mask)
    hidden, cache, _ = forward(params, cfg, input_ids, attention_mask=attention_mask,
                               causal=True, positions=positions, cache=cache)
    last_idx = torch.argmax(
        torch.where(attention_mask > 0, torch.arange(S, device=dev)[None, :], -1), dim=1)
    last_hidden = hidden[torch.arange(B, device=dev), last_idx]
    logits = logits_from_hidden(params, cfg, last_hidden[:, None, :])[:, 0]
    tok0 = torch.argmax(logits, dim=-1)

    # ---- dense history: each row's prompt tokens compacted left (pad holes
    # would break n-gram matching), then the generated tokens
    # (out and history carry one spare column that takes the writes JAX's
    # scatter drops, so no write needs a host sync)
    hbuf = S + max_new_tokens
    order = torch.argsort((attention_mask == 0).to(torch.int32), dim=1, stable=True)
    history = torch.full((B, hbuf + 1), pad_id, dtype=torch.long, device=dev)
    history[:, :S] = input_ids.long().gather(1, order)
    hist_len = attention_mask.sum(dim=1).long()
    rows = torch.arange(B, device=dev)
    history[rows, hist_len] = tok0
    hist_len = hist_len + 1

    out = torch.full((B, max_new_tokens + 1), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = tok0
    out_len = torch.ones((B,), dtype=torch.long, device=dev)
    done = (tok0 == eos_id) | (out_len >= max_new_tokens)
    last_tok = tok0
    steps = 0
    all_done = bool(done.all())
    while not all_done and cache.length + k + 1 <= Smax:
        frontier = cache.length
        active = ~done
        proposals = _lookup_proposals(history[:, :hbuf], hist_len, ngram, k, pad_id)
        chunk = torch.cat([last_tok[:, None], proposals], dim=1)  # [B, k+1]
        chunk_mask = active[:, None].to(torch.int32).expand(B, k + 1)
        pos = cache.mask.sum(dim=1)[:, None] + ar
        hidden, cache, _ = forward(params, cfg, chunk, attention_mask=chunk_mask, causal=True,
                                   positions=pos, cache=cache)
        # greedy[:, i]: the model's token after chunk[:, :i + 1]
        greedy = torch.argmax(logits_from_hidden(params, cfg, hidden), dim=-1)
        emit_tok, n_emit, n_slots, hit_eos = _accept(proposals, greedy, active,
                                                     max_new_tokens - out_len, eos_id)
        cache.mask[:, frontier:frontier + k + 1] = (ar < n_slots[:, None]).to(cache.mask.dtype)

        # emitted tokens into out and history at the rows' own offsets
        valid = ar < n_emit[:, None]
        out.scatter_(1, torch.where(valid, out_len[:, None] + ar, max_new_tokens).clamp_max(
            max_new_tokens), emit_tok)
        history.scatter_(1, torch.where(valid, hist_len[:, None] + ar, hbuf).clamp_max(hbuf),
                         emit_tok)
        out_len = out_len + n_emit
        hist_len = hist_len + n_emit
        last_tok = torch.where(n_emit > 0,
                               emit_tok.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0],
                               last_tok)
        done = done | hit_eos | (out_len >= max_new_tokens)
        steps += 1
        # one host read a step: the frontier's advance and whether all rows are done
        adv, n_done = torch.stack([n_slots.max(), done.sum()]).tolist()
        cache.length = frontier + int(adv)
        all_done = n_done == B
    return GenerateResult(tokens=out[:, :max_new_tokens].to(torch.int32),
                          num_valid=out_len.to(torch.int32), cache=cache, spec_steps=steps)
