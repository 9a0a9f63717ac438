"""Continuous-batching serving engine (port of gritlm_tpu.serving).

A fixed pool of B cache slots, each holding an independent request at an
independent length (`forward(row_offsets=...)`: every decode step appends
each row's K/V at its own write slot); per-request prefill into a free slot
(bucketed prompt lengths); one decode chunk of `chunk_size` steps for the
whole pool; a finished row (EOS or max_new_tokens) frees its slot and the
next queued request is admitted, so the decode batch stays full under
ragged arrival. One pool serves generation and embedding requests
(`EmbedRequest`) side by side.

Design notes:
  - All decode state lives on the device: next-token ids, the KV pool,
    per-row write slots and RoPE positions, active flags and token budgets
    (`_Carry`). The programs below are plain functions on tensors that
    update the carry IN PLACE (the JAX package donates the carry to its
    jitted programs to the same effect).
  - A decode chunk is a Python loop of `steps` forward calls with EOS and
    budget masking on the device: no `.item()`, `.cpu()` or `.tolist()`
    inside it, so the host never waits for the device within a chunk.
  - `overlap=True` (default) dispatches chunk k+1 before reading chunk k:
    each chunk's (tokens, emitted) are copied with non_blocking=True into
    pinned host tensors and a CUDA event is recorded behind the copy; the
    results are read after waiting on that event only (never a
    device-wide synchronize, which would drain the next chunk too). A slot
    freed in chunk k is re-admitted at chunk k+2. `overlap=False` reads each
    chunk before admitting (strict scheduling).
  - Same-bucket admissions prefill as one batch; the prefill's first token
    stays on the device, is folded into the carry by the insert program and
    is read lazily at the next result-processing point (`_resolve_firsts`).
  - `paged=True` swaps the dense B x max_len pool for a shared page pool
    (PagedKVCache + K8): device memory follows the tokens requests reserve
    and admission is bounded by free pages. Prefill still runs on a dense
    row cache, which the insert program copies into the request's pages.
    `register_prefix` pins a precomputed cache (a RAG document) into pool
    pages once; requests with `prefix=key` read those pages through their
    page tables (their private tail starts page-aligned after the prefix,
    so shared pages are never written).

  - `sampling=True` runs the sampling chunk: each request draws with its
    own (temperature, top_k, top_p, seed). The draw for a request's n-th
    generated token is a pure function of (seed, n, vocab index): Gumbel-max
    over uniforms from threefry2x32 keyed by the seed at counter (n, vocab
    index), in torch integer ops on the device (`_sample_rows`). So a
    request's tokens do not depend on its slot, the chunk size, overlap or
    its co-tenants (up to how the matmuls round at another batch size), and
    the chunk stays free of host syncs. The JAX package folds a threefry
    key per token; its bits are not reproduced here.
  - `speculative=True` runs the prompt-lookup verify pool (greedy only):
    each step proposes k tokens a row from the row's own history (its
    prompt, `Request.hist_ids` before it, and what it generated), verifies
    the k + 1 in one `forward(row_offsets=..., S=k+1)` (K3 with per-row
    offsets on a dense pool, K8 on a paged one), and emits the accepted
    prefix and the model's bonus token; a row's write slot advances by its
    own accepted count, so rejected slots are overwritten by its next step.

Not ported, raising NotImplementedError: `adapters=` (per-request LoRA,
with training) and `mesh=` (the parallel slice).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.gritlm import _encode_step
from gritlm_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    forward,
    init_cache,
    init_paged_cache,
    logits_from_hidden,
    resolve_device,
)
from gritlm_tpu_torch.spec_decode import _accept, _lookup_proposals


@dataclass
class Request:
    """One generation request (token-id level; tokenize outside).

    `doc_cache` admits the request as a continuation of a precomputed KV
    cache (the RAG doc-cache flow): `(k, v, w, k_scale, v_scale)` in the
    RAGEngine doc-store entry format (k/v [L, w, Kv*Dh], w the valid token
    count, scales [L, Kv, w] or None). The prompt prefills behind the cached
    document (positions continue at w) and decodes like any other request.

    `prefix` (paged pools only) continues a cache the engine has pinned into
    shared pages with `register_prefix(key, entry)`: N concurrent requests on
    one document read the same physical pages.

    Sampling (`temperature > 0`, the engine built with `sampling=True`):
    the request's n-th generated token is drawn from a counter-based
    generator keyed by `seed` at counter n, so its output is fixed by
    `seed` whatever the scheduling; `top_k`/`top_p` filter per row (the
    nucleus rule, ties kept together by value). temperature == 0 rows stay
    exactly greedy. An `adapter` raises ValueError (this pool serves none),
    as in the JAX package's schema."""

    input_ids: List[int]
    max_new_tokens: int = 16
    request_id: Optional[str] = None
    doc_cache: Optional[tuple] = None
    prefix: Optional[object] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # speculative pools: lookup-corpus tokens before input_ids (a cached
    # document's token ids for doc_cache/prefix rows: their KV comes from the
    # cache, but their text is what extractive answers quote). Ignored by
    # other pools.
    hist_ids: Optional[List[int]] = None
    adapter: Optional[str] = None
    # admission priority: higher admits first; FIFO within a level
    priority: int = 0


@dataclass
class Completion:
    request_id: Optional[str]
    token_ids: List[int]  # generated ids, EOS included when emitted
    finish_reason: str  # "eos" | "length" | "cancelled"
    prompt_len: int = 0


@dataclass
class EmbedRequest:
    """One embedding request in the same pool as generation. `input_ids` is
    the full prompt (instruction + text + embed_eos tokens, unpadded); the
    leading `instr_len` tokens are left out of mean/weightedmean pooling
    (instr_len=0 embeds the instruction too). Embedding batches dispatch
    between decode chunks, one same-bucket group per scheduler step, through
    the port's own `gritlm._encode_step`, so pool embeddings are the offline
    encoder's without a projection head: the engine passes none, as the JAX
    engine passes `has_projection=False`, so a model's head never applies
    here."""

    input_ids: List[int]
    instr_len: int = 0
    request_id: Optional[str] = None
    priority: int = 0
    adapter: Optional[str] = None


@dataclass
class EmbedCompletion:
    request_id: Optional[str]
    embedding: np.ndarray  # [hidden] float32, L2-normalized by default


class _HostCopy:
    """Device tensors on their way to the host: on CUDA a non_blocking copy
    into pinned memory with an event recorded behind it (reading waits on
    that event only); on the CPU the tensors themselves."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            tensors = host
        self.tensors = tensors

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return [t.numpy() for t in self.tensors]


@dataclass
class _Slot:
    request: Request
    generated: List[int] = field(default_factory=list)
    # (host copy of the prefill's first tokens, row): read lazily, so
    # admission never waits for the device
    first_src: Optional[tuple] = None
    # decode steps dispatched for this row so far (drives adaptive chunks)
    dispatched: int = 0


@dataclass
class _Pending:
    """A chunked prefill in flight: the request holds its reserved slot (and
    pages) while its prompt streams in `prefill_chunk`-token chunks between
    decode chunks."""
    request: Request
    slot: int
    cache: KVCache  # [.., 1, bucket, ..] row cache, filled chunk by chunk
    bucket: int
    filled: int = 0
    first: Optional[torch.Tensor] = None  # the last chunk's next token, [1]
    pids: Optional[List[int]] = None  # reserved pages (paged pools)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


@dataclass
class _Samp:
    """Per-row sampling state (greedy rows: temperature 0)."""
    temps: torch.Tensor  # [R] float32
    top_k: torch.Tensor  # [R] int64, 0 = off
    top_p: torch.Tensor  # [R] float32, 1 = off
    keys: torch.Tensor  # [R, 2] int64: the seed's two 32-bit words
    n_gen: torch.Tensor  # [R] int64: the index of the row's next draw


def _samp_init(rows: int, device) -> _Samp:
    """Idle sampling state: greedy everywhere."""
    return _Samp(temps=torch.zeros((rows,), dtype=torch.float32, device=device),
                 top_k=torch.zeros((rows,), dtype=torch.long, device=device),
                 top_p=torch.ones((rows,), dtype=torch.float32, device=device),
                 keys=torch.zeros((rows, 2), dtype=torch.long, device=device),
                 n_gen=torch.zeros((rows,), dtype=torch.long, device=device))


def _seed_key(seed: int) -> tuple:
    """A seed as the two 32-bit words of a threefry key (high, low)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & 0xFFFFFFFF


_M32 = 0xFFFFFFFF
_THREEFRY_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11; the block
    function JAX's default PRNG is built on), in int64 tensors holding
    32-bit words: key (k0, k1), counter (x0, x1), broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(20):
        r = _THREEFRY_ROT[i % 8]
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
        x1 = x1 ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = (x0 + ks[j % 3]) & _M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & _M32
    return x0, x1


def _gumbel(keys: torch.Tensor, n_gen: torch.Tensor, V: int) -> torch.Tensor:
    """[R, V] Gumbel noise: row r's draw number n_gen[r] at vocab index v is
    -log(-log(u)), u from threefry2x32 keyed by the row's seed at counter
    (n_gen[r], v); 24 bits of uniform, centred in their cell, so u is in
    (0, 1)."""
    v = torch.arange(V, device=keys.device)[None, :]
    bits, _ = threefry2x32(keys[:, :1], keys[:, 1:], n_gen[:, None] & _M32, v)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample_rows(logits: torch.Tensor, samp: _Samp) -> torch.Tensor:
    """Per-row sampling over [R, V] logits, each row with its own
    temperature, top_k, top_p, seed and draw index. One descending sort
    serves both filters: top-k keeps values >= the k-th, top-p values >=
    the value at the nucleus cut-off rank (generate.nucleus_filter's rule,
    ties kept together by value). Then Gumbel-max over the kept logits
    divided by the temperature. Rows at temperature 0 take the argmax.
    Returns [R] int32; no host sync."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / samp.temps.clamp_min(1e-6)[:, None]
    svals = torch.sort(lg, dim=-1, descending=True).values
    kk = torch.where(samp.top_k > 0, samp.top_k, V).clamp(1, V)
    k_th = svals.gather(1, (kk - 1)[:, None])
    cum = torch.cumsum(torch.softmax(svals, dim=-1), dim=-1)
    cut = (cum < samp.top_p[:, None]).sum(dim=-1).clamp_max(V - 1)
    p_th = svals.gather(1, cut[:, None])
    filt = torch.where(lg >= torch.maximum(k_th, p_th), lg, float("-inf"))
    sampled = torch.argmax(filt + _gumbel(samp.keys, samp.n_gen, V), dim=-1).to(torch.int32)
    return torch.where(samp.temps > 0, sampled, greedy)


@dataclass
class _Carry:
    """The pool's decode state on the device. row_lens is each row's cache
    WRITE slot, row_pos its RoPE position: they differ for doc-continuation
    rows, whose document occupies slots [0, dbucket) but positions
    [0, doc_len). Speculative pools add each row's token history (the
    prompt-lookup corpus) [B, max_len + 1] (the last column takes the
    writes that fall past the end) and its length."""
    tok: torch.Tensor  # [B] int32 pending token
    cache: Union[KVCache, PagedKVCache]
    row_lens: torch.Tensor  # [B] int64
    row_pos: torch.Tensor  # [B] int64
    active: torch.Tensor  # [B] bool
    remaining: torch.Tensor  # [B] int32 token budget
    samp: _Samp
    history: Optional[torch.Tensor] = None  # [B, max_len + 1] int64
    hist_len: Optional[torch.Tensor] = None  # [B] int64


# ---------------------------------------------------------------------------
# Programs: plain functions that update the carry in place.


def _last_token(params, cfg, hidden: torch.Tensor, mask: torch.Tensor,
                samp: Optional[_Samp] = None) -> torch.Tensor:
    """Next token [rows] int32 off each row's last valid position: greedy,
    or drawn per row by `samp` (draw index 0 for a prefill)."""
    last = (mask.sum(dim=1) - 1).clamp_min(0).long()
    h_last = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    logits = logits_from_hidden(params, cfg, h_last[:, None, :])[:, 0]
    if samp is not None:
        return _sample_rows(logits, samp)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.inference_mode()
def _prefill_program(params, cfg, ids, mask, samp: Optional[_Samp] = None, *, quant: bool):
    """[rows, bucket] right-padded prompts -> (row-batch KVCache, first
    token per row: greedy, or sampled at draw index 0 with `samp`). Row
    caches are slot-dense (position == slot)."""
    cache = init_cache(cfg, ids.shape[0], ids.shape[1], device=ids.device, quant=quant)
    return _prefill_chunk_program(params, cfg, cache, ids, mask, samp)


@torch.inference_mode()
def _prefill_chunk_program(params, cfg, cache: KVCache, ids, mask,
                           samp: Optional[_Samp] = None):
    """One chunk of a chunked prefill: append `chunk` prompt tokens to one
    request's row cache (its write offset is cache.length, so chunks chain)
    and return the next token off the chunk's last valid position (the
    final chunk's is the request's first generated token)."""
    hidden, cache, _ = forward(params, cfg, ids, attention_mask=mask, causal=True, cache=cache)
    return cache, _last_token(params, cfg, hidden, mask, samp)


@torch.inference_mode()
def _prefill_continue_program(params, cfg, doc_k, doc_v, doc_scales, doc_mask, doc_lens,
                              ids, mask, samp: Optional[_Samp] = None):
    """Cache-continuation prefill: the documents' K/V occupy slots
    [0, dbucket) (each row valid to its own doc_len), the prompt prefills at
    slots [dbucket, dbucket + bucket) with RoPE positions continuing at
    doc_len. Returns (row-batch KVCache [.., dbucket + bucket, ..], first
    tokens)."""
    L, rows, dbucket, KD = doc_k.shape
    bucket = ids.shape[1]

    def grow(x, axis):  # zero slots for the prompt on the slot axis
        pad = list(x.shape)
        pad[axis] = bucket
        return torch.cat([x, x.new_zeros(pad)], dim=axis)

    cache = KVCache(
        k=grow(doc_k, 2), v=grow(doc_v, 2), mask=grow(doc_mask, 1), length=dbucket,
        k_scale=None if doc_scales is None else grow(doc_scales[0], 3),
        v_scale=None if doc_scales is None else grow(doc_scales[1], 3),
    )
    positions = doc_lens[:, None] + torch.arange(bucket, device=ids.device)[None, :]
    hidden, cache, _ = forward(params, cfg, ids, attention_mask=mask, causal=True,
                               positions=positions, cache=cache)
    return cache, _last_token(params, cfg, hidden, mask, samp)


def _arm(carry: _Carry, firsts, row_idx: int, slot: int, write_len: int, pos0: int,
         max_new: int, eos_id: int, req_samp: Optional[tuple] = None,
         req_hist: Optional[tuple] = None) -> None:
    """Arm pool row `slot`: pending token = the prefill's first token, write
    slot `write_len`, RoPE position `pos0`, budget max_new - 1 (the first
    token is already spent); a sampling row's parameters `req_samp`
    (temperature, top_k, top_p, seed key) with its draw index at 1 (the
    prefill drew index 0); a speculative row's history `req_hist` (the
    compact prompt [n] int64 on the device, n), then the first token."""
    first = firsts[row_idx]
    rem = max_new - 1
    carry.tok[slot] = first
    carry.row_lens[slot] = write_len
    carry.row_pos[slot] = pos0
    carry.active[slot] = (first != eos_id) & (rem > 0)
    carry.remaining[slot] = rem
    if req_samp is not None:
        temp, top_k, top_p, key = req_samp
        sm = carry.samp
        sm.temps[slot], sm.top_k[slot], sm.top_p[slot] = temp, top_k, top_p
        sm.keys[slot, 0], sm.keys[slot, 1] = key
        sm.n_gen[slot] = 1
    if req_hist is not None:
        row, hlen = req_hist
        carry.history[slot, :hlen] = row
        carry.history[slot, hlen] = first
        carry.hist_len[slot] = hlen + 1


@torch.inference_mode()
def _insert_program(carry: _Carry, rows_cache: KVCache, firsts, row_idx: int, slot: int,
                    write_len: int, pos0: int, max_new: int, req_samp=None, req_hist=None,
                    *, eos_id: int) -> None:
    """Copy prefilled row `row_idx` into pool slot `slot` (K/V and mask,
    zero-extended to the pool width) and arm the slot."""
    cache = carry.cache
    W = min(rows_cache.max_len, cache.max_len)
    cache.k[:, slot, :W] = rows_cache.k[:, row_idx, :W]
    cache.v[:, slot, :W] = rows_cache.v[:, row_idx, :W]
    if cache.quantized:
        cache.k_scale[:, slot, :, :W] = rows_cache.k_scale[:, row_idx, :, :W]
        cache.v_scale[:, slot, :, :W] = rows_cache.v_scale[:, row_idx, :, :W]
    cache.mask[slot] = 0
    cache.mask[slot, :W] = rows_cache.mask[row_idx, :W]
    _arm(carry, firsts, row_idx, slot, write_len, pos0, max_new, eos_id, req_samp, req_hist)


def _pages_of(x: torch.Tensor, row: int, first_page: int, n: int, page: int) -> torch.Tensor:
    """Pages [first_page, first_page + n) of row `row` of a dense row cache
    [L, rows, W, KD] -> [L, n, page, KD]."""
    L, KD = x.shape[0], x.shape[3]
    return x[:, row, first_page * page:(first_page + n) * page].reshape(L, n, page, KD)


def _scale_pages_of(s: torch.Tensor, row: int, first_page: int, n: int,
                    page: int) -> torch.Tensor:
    """Slot-minor scales [L, rows, Kv, W] of row `row` -> [L, n, Kv, page]."""
    L, Kv = s.shape[0], s.shape[2]
    return s[:, row, :, first_page * page:(first_page + n) * page].reshape(
        L, Kv, n, page).transpose(1, 2)


@torch.inference_mode()
def _write_pages(cache: PagedKVCache, pids: torch.Tensor, k, v, ks=None, vs=None) -> None:
    """Write pages [L, n, page, KD] (scales [L, n, Kv, page] for int8 pools)
    into the pool's pages `pids` [n], one index_copy_ per tensor: the paged
    insert's copy, and the pinning of a prefix (JAX `_write_prefix_program`)."""
    cache.k.index_copy_(1, pids, k)
    cache.v.index_copy_(1, pids, v)
    if ks is not None:
        cache.k_scale.index_copy_(1, pids, ks.contiguous())
        cache.v_scale.index_copy_(1, pids, vs.contiguous())


@torch.inference_mode()
def _insert_paged_program(carry: _Carry, rows_cache: KVCache, firsts, row_idx: int, slot: int,
                          table_row: np.ndarray, write_len: int, pos0: int, max_new: int,
                          req_samp=None, req_hist=None, *, copy_from_page: int,
                          eos_id: int) -> None:
    """Paged insert: copy prefilled row `row_idx`'s pages from
    `copy_from_page` on into the pool pages `table_row` names (a prefix
    request's shared document pages are not written), install the row's
    page table and logical mask, and arm the slot."""
    cache = carry.cache
    page = cache.page_size
    dev = cache.k.device
    W = min(rows_cache.max_len, cache.max_len)
    n = W // page - copy_from_page
    if n > 0:
        pids = torch.as_tensor(table_row[copy_from_page:copy_from_page + n], dtype=torch.long,
                               device=dev)
        scales = ()
        if cache.quantized:
            scales = (_scale_pages_of(rows_cache.k_scale, row_idx, copy_from_page, n, page),
                      _scale_pages_of(rows_cache.v_scale, row_idx, copy_from_page, n, page))
        _write_pages(cache, pids, _pages_of(rows_cache.k, row_idx, copy_from_page, n, page),
                     _pages_of(rows_cache.v, row_idx, copy_from_page, n, page), *scales)
    cache.mask[slot] = 0
    cache.mask[slot, :W] = rows_cache.mask[row_idx, :W]
    cache.page_table[slot] = torch.as_tensor(table_row, dtype=torch.int32, device=dev)
    _arm(carry, firsts, row_idx, slot, write_len, pos0, max_new, eos_id, req_samp, req_hist)


@torch.inference_mode()
def _gather_prefix_program(cache: PagedKVCache, pt_rows: torch.Tensor):
    """Gather shared prefix pages [rows, dp] into the dense
    [L, rows, dp*page, ...] doc tensors the continuation prefill takes."""
    L, _, page, KD = cache.k.shape
    rows, dp = pt_rows.shape
    flat = pt_rows.reshape(-1)
    dk = cache.k.index_select(1, flat).reshape(L, rows, dp * page, KD)
    dv = cache.v.index_select(1, flat).reshape(L, rows, dp * page, KD)
    if not cache.quantized:
        return dk, dv, None

    def scales(s):  # [L, rows*dp, Kv, page] -> [L, rows, Kv, dp*page]
        kv = s.shape[2]
        return s.index_select(1, flat).reshape(L, rows, dp, kv, page).permute(
            0, 1, 3, 2, 4).reshape(L, rows, kv, dp * page)

    return dk, dv, (scales(cache.k_scale), scales(cache.v_scale))


@torch.inference_mode()
def _deactivate_program(carry: _Carry, slot: int) -> None:
    """Stop one pool row on the device (cancellation): the next chunk emits
    nothing for it and writes nothing past its frontier."""
    carry.active[slot] = False
    carry.remaining[slot] = 0


@torch.inference_mode()
def _decode_chunk_program(params, cfg, carry: _Carry, *, steps: int, eos_id: int,
                          pad_id: int, sample: bool = False):
    """`steps` pool-wide decode iterations on the device. Each appends every
    row's pending token at its own slot and picks the next, greedily or
    (`sample=True`) by each row's own sampling parameters; a row goes
    inactive the moment it emits EOS or spends its budget. Returns stacked
    (tokens, emitted) [steps, B]. No host sync inside."""
    B = carry.tok.shape[0]
    dev = carry.tok.device
    toks = torch.empty((steps, B), dtype=torch.int32, device=dev)
    emitted = torch.empty((steps, B), dtype=torch.bool, device=dev)
    for i in range(steps):
        active = carry.active
        hidden, _, _ = forward(params, cfg, carry.tok[:, None], causal=True,
                               attention_mask=active[:, None].to(torch.int32),
                               positions=carry.row_pos[:, None], cache=carry.cache,
                               row_offsets=carry.row_lens)
        logits = logits_from_hidden(params, cfg, hidden)[:, 0]
        if sample:
            nxt = _sample_rows(logits, carry.samp)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted[i] = active
        nxt = torch.where(active, nxt, torch.full_like(nxt, pad_id))
        adv = active.to(torch.int32)
        if sample:
            carry.samp.n_gen += adv
        carry.row_lens += adv
        carry.row_pos += adv
        carry.remaining -= adv
        carry.active = active & (nxt != eos_id) & (carry.remaining > 0)
        carry.tok = nxt
        toks[i] = nxt
    return toks, emitted


@torch.inference_mode()
def _spec_chunk_program(params, cfg, carry: _Carry, *, steps: int, ngram: int, k: int,
                        eos_id: int, pad_id: int):
    """`steps` speculative pool iterations on the device: each proposes k
    tokens a row by prompt lookup over the row's own history, verifies all
    k + 1 in one per-row-offset forward, and emits the accepted prefix and
    the model's bonus token (spec_decode.py, at per-row frontiers: a row's
    write slot advances by its own accepted count only, so its rejected
    slots are overwritten by its next step: no holes, no slack beyond k a
    request). Returns stacked (tokens [steps, B, k + 1], n_emit [steps, B]).
    No host sync inside."""
    B = carry.tok.shape[0]
    dev = carry.tok.device
    W = carry.history.shape[1] - 1  # the last column takes writes past the end
    j = torch.arange(k + 1, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    toks = torch.empty((steps, B, k + 1), dtype=torch.int32, device=dev)
    n_emits = torch.empty((steps, B), dtype=torch.int32, device=dev)
    cache = carry.cache
    for i in range(steps):
        tok, active = carry.tok.long(), carry.active
        proposals = _lookup_proposals(carry.history[:, :W], carry.hist_len, ngram, k, pad_id)
        chunk = torch.cat([tok[:, None], proposals], dim=1)
        hidden, _, _ = forward(params, cfg, chunk, causal=True,
                               attention_mask=active[:, None].to(torch.int32).expand(B, k + 1),
                               positions=carry.row_pos[:, None] + j, cache=cache,
                               row_offsets=carry.row_lens)
        greedy = torch.argmax(logits_from_hidden(params, cfg, hidden), dim=-1)  # [B, k+1]
        emit_tok, n_emit, n_slots, hit_eos = _accept(proposals, greedy, active,
                                                     carry.remaining, eos_id)
        # the rejected slots' bits are cleared (their K/V is overwritten by
        # the row's next step)
        win = (carry.row_lens[:, None] + j).clamp_max(cache.max_len - 1)
        cache.mask[rows, win] = (j < n_slots[:, None]).to(cache.mask.dtype)

        valid = j < n_emit[:, None]
        carry.history.scatter_(1, torch.where(valid, carry.hist_len[:, None] + j, W).clamp_max(W),
                               emit_tok)
        carry.hist_len += n_emit
        carry.tok = torch.where(n_emit > 0,
                                emit_tok.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0],
                                tok).to(torch.int32)
        carry.row_lens += n_slots
        carry.row_pos += n_slots
        carry.remaining -= n_emit.to(carry.remaining.dtype)
        carry.active = active & ~hit_eos & (carry.remaining > 0)
        toks[i] = torch.where(valid, emit_tok, pad_id)
        n_emits[i] = n_emit
    return toks, n_emits


class ServingEngine:
    """Continuous-batching decode over a fixed slot pool.

    >>> eng = ServingEngine(cfg, params, max_batch=8, max_len=4096)
    >>> done = eng.run([Request(ids, max_new_tokens=64), ...])

    Greedy decoding by default. `sampling=True` runs the sampling chunk:
    each request decodes with its own (temperature, top_k, top_p, seed),
    schedule-invariant (see Request); greedy requests in a sampling pool
    stay exactly greedy. `speculative=True` runs the greedy prompt-lookup
    verify pool (`spec_ngram`, `spec_k`). Completions include the EOS token
    when one was emitted, as generate()'s num_valid counts it. Runs on CUDA
    unless `device` says otherwise; the params must live on that device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        max_batch: int = 8,
        max_len: int = 4096,
        kv_quant: bool = False,
        eos_id: int = 2,
        pad_id: int = 0,
        chunk_size: int = 16,
        adaptive_chunk: bool = False,
        prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        overlap: bool = True,
        mesh=None,
        paged: bool = False,
        page_size: int = 256,
        pool_pages: Optional[int] = None,
        sampling: bool = False,
        speculative: bool = False,
        spec_ngram: int = 3,
        spec_k: int = 7,
        prefill_chunk: Optional[int] = None,
        adapters=None,
        on_token=None,  # streaming callback: on_token(request_id, token)
        # EmbedRequest: the embedding forward's config, as GritLM(mode=
        # "unified"): bidirectional attention, mean pooling, L2-normalized
        pooling_method: str = "mean",
        embed_causal: bool = False,
        normalized: bool = True,
        embed_batch: Optional[int] = None,  # rows per embed dispatch
        on_embedding=None,  # streaming callback: on_embedding(id, vec)
        device=None,
    ):
        for name, value, slice_ in (
                ("adapters", adapters, "per-request LoRA comes with the training slice"),
                ("mesh", mesh, "multi-device serving comes with the parallel slice")):
            if value:
                raise NotImplementedError(f"ServingEngine({name}=...) is not ported yet: "
                                          f"{slice_}")
        if speculative and sampling:
            raise ValueError("speculative serving is greedy-only (it must be parity-exact "
                             "with the greedy decode)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.chunk_size = chunk_size
        self.adaptive_chunk = adaptive_chunk
        self.sampling = sampling
        self.speculative = speculative
        self.spec_ngram = spec_ngram
        self.spec_k = spec_k
        self.prefill_chunk = prefill_chunk
        self.on_token = on_token
        self.pooling_method = pooling_method
        self.embed_causal = embed_causal
        self.normalized = normalized
        self.embed_batch = embed_batch or max_batch
        self.on_embedding = on_embedding
        self.buckets = [b for b in prompt_buckets if b <= max_len]
        if prefill_chunk is not None:
            bad = [b for b in self.buckets if b % prefill_chunk]
            if bad:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must divide every prompt bucket (got "
                    f"{bad}): a prompt's chunk count must fit its row cache exactly")
        self.overlap = overlap
        self.paged = paged
        self.page = page_size
        if paged:
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} % page {page_size} != 0")
            # page-aligned buckets: a request's private tail starts on a page
            # boundary, so prefix pages are never written
            self.buckets = [b for b in self.buckets if b % page_size == 0]
            if not self.buckets:
                raise ValueError(f"no prompt bucket is a multiple of page {page_size}")
            self.pool_pages = pool_pages or (max_batch * max_len) // page_size + 1
            # page 0 is the scratch page of inactive rows' writes
            self._free_pages = list(range(1, self.pool_pages))
            self._slot_pages: Dict[int, List[int]] = {}
            self.prefixes: Dict[object, tuple] = {}  # key -> (pids, w)

        self.kv_quant = kv_quant
        dev = self.device
        pool = (init_paged_cache(cfg, max_batch, max_len, self.pool_pages, page=page_size,
                                 device=dev, quant=kv_quant)
                if paged else init_cache(cfg, max_batch, max_len, device=dev, quant=kv_quant))
        self.carry = _Carry(
            tok=torch.full((max_batch,), pad_id, dtype=torch.int32, device=dev),
            cache=pool,
            row_lens=torch.zeros((max_batch,), dtype=torch.long, device=dev),
            row_pos=torch.zeros((max_batch,), dtype=torch.long, device=dev),
            active=torch.zeros((max_batch,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((max_batch,), dtype=torch.int32, device=dev),
            samp=_samp_init(max_batch, dev),
        )
        if speculative:
            self.carry.history = torch.zeros((max_batch, max_len + 1), dtype=torch.long,
                                             device=dev)
            self.carry.hist_len = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        self.slots: Dict[int, _Slot] = {}
        self.queue: List[Request] = []
        self.finished: List[Completion] = []
        self._pending: List[_Pending] = []  # chunked prefills in flight
        self._draining: Dict[int, int] = {}  # cancelled slots cooling down
        self._prev: Optional[_HostCopy] = None  # in-flight chunk's (toks, emitted)
        self.embed_queue: List[EmbedRequest] = []
        self.finished_embeds: List[EmbedCompletion] = []
        self._prev_embed = None  # in-flight (host copy, requests)
        self._steps = 0  # device decode steps taken (for stats)

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    # ---- prefixes (paged pools) ----------------------------------------

    def register_prefix(self, key, entry: tuple) -> None:
        """Pin a precomputed cache (doc-store entry format: k/v [L, w, Kv*Dh],
        w, scales) into shared pool pages. Requests with `prefix=key` read
        these pages; the cache is uploaded and stored once however many
        requests continue it. Pages stay pinned until release_prefix."""
        if not self.paged:
            raise ValueError("register_prefix requires paged=True")
        k, v, w, ks, vs = entry
        if (ks is not None) != self.kv_quant:
            raise ValueError(f"prefix quantization does not match kv_quant={self.kv_quant}")
        if key in self.prefixes:
            return
        page = self.page
        npg = -(-w // page)
        if npg > len(self._free_pages):
            raise ValueError(f"prefix needs {npg} pages, only {len(self._free_pages)} free")
        pids = [self._free_pages.pop() for _ in range(npg)]
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        L, _, KD = k.shape

        def stage(x):  # [L, w, KD] -> [L, npg, page, KD] on the device
            out = torch.zeros((L, npg * page, KD), dtype=x.dtype, device=self.device)
            out[:, :w] = x[:, :w].to(self.device)
            return out.reshape(L, npg, page, KD)

        def stage_scales(s):  # [L, Kv, w] -> [L, npg, Kv, page]
            s = torch.as_tensor(s)
            out = torch.zeros((L, s.shape[1], npg * page), dtype=s.dtype, device=self.device)
            out[..., :w] = s[..., :w].to(self.device)
            return out.reshape(L, s.shape[1], npg, page).transpose(1, 2)

        sk = sv = None
        if self.kv_quant:
            sk, sv = stage_scales(ks), stage_scales(vs)
        _write_pages(self.carry.cache, torch.as_tensor(pids, dtype=torch.long, device=self.device),
                     stage(k), stage(v), sk, sv)
        self.prefixes[key] = (pids, w)

    def release_prefix(self, key) -> bool:
        """Unpin a registered prefix and return its pages to the free list.
        Refuses while a queued, pending or in-flight request still refers to
        it (their page tables point at the shared pages). Returns True if
        released, False if unknown."""
        if key not in self.prefixes:
            return False
        refs = [r.request_id for r in self.queue if r.prefix == key]
        refs += [s.request.request_id for s in self.slots.values() if s.request.prefix == key]
        refs += [p.request.request_id for p in self._pending if p.request.prefix == key]
        if refs:
            raise ValueError(f"prefix {key!r} still referenced by {len(refs)} request(s): "
                             f"{refs[:4]}")
        pids, _ = self.prefixes.pop(key)
        self._free_pages.extend(pids)
        return True

    def _pages_needed(self, req: Request) -> int:
        span = _bucket(len(req.input_ids), self.buckets) + req.max_new_tokens
        if req.doc_cache is not None:
            span += _bucket(req.doc_cache[2], self.buckets)
        if self.speculative:
            # a verify chunk writes up to spec_k slots past the last accepted
            # token: those logical slots need real pages (an unmapped chunk
            # would alias the scratch page 0)
            span += self.spec_k
        return -(-span // self.page)

    def _samp_rows(self, rs: Sequence[Request]) -> Optional[_Samp]:
        """An admission batch's sampling state for its prefill (draw index
        0 for every row); None in greedy pools."""
        if not self.sampling:
            return None
        samp = _samp_init(len(rs), self.device)
        samp.temps.copy_(torch.tensor([r.temperature for r in rs], dtype=torch.float32))
        samp.top_k.copy_(torch.tensor([r.top_k for r in rs], dtype=torch.long))
        samp.top_p.copy_(torch.tensor([r.top_p for r in rs], dtype=torch.float32))
        samp.keys.copy_(torch.tensor([_seed_key(r.seed) for r in rs], dtype=torch.long))
        return samp

    def _arming(self, r: Request) -> dict:
        """The insert programs' arguments that arm a row for request r
        besides its prefill (None where the pool has no use for them): its
        sampling parameters, and its compact prompt as its history
        (speculative pools: the lookup corpus; generated tokens append on
        the device)."""
        req_samp = req_hist = None
        if self.sampling:
            req_samp = (float(r.temperature), int(r.top_k), float(r.top_p), _seed_key(r.seed))
        if self.speculative:
            seq = list(r.hist_ids or []) + list(r.input_ids)
            # generated tokens append at hist_len: keep the corpus's tail
            # when hist_ids would overflow the row (recent context matters most)
            seq = seq[-(self.max_len - r.max_new_tokens):]
            req_hist = (torch.tensor(seq, dtype=torch.long).to(self.device), len(seq))
        return dict(req_samp=req_samp, req_hist=req_hist)

    # ---- submission ----------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.temperature > 0.0 and not self.sampling:
            raise ValueError("temperature > 0 requires ServingEngine(sampling=True)")
        if req.adapter is not None:
            raise ValueError(f"unknown adapter {req.adapter!r} (this pool serves no adapters)")
        if req.prefix is not None:
            if not self.paged or req.prefix not in self.prefixes:
                raise ValueError(f"unknown prefix {req.prefix!r} (register_prefix first)")
            if req.doc_cache is not None:
                raise ValueError("pass doc_cache OR prefix, not both")
        need = len(req.input_ids) + req.max_new_tokens
        if req.doc_cache is not None:
            if (req.doc_cache[3] is not None) != self.kv_quant:
                raise ValueError("doc_cache quantization does not match the pool's "
                                 f"kv_quant={self.kv_quant}")
            need += _bucket(req.doc_cache[2], self.buckets)
        if req.prefix is not None:
            need += len(self.prefixes[req.prefix][0]) * self.page
        if self.speculative:
            # a verify chunk writes k + 1 slots at the row's write slot before
            # acceptance masks them, so the last one reaches written + spec_k
            need += self.spec_k
        if need > self.max_len:
            raise ValueError(
                f"prompt {len(req.input_ids)} + max_new {req.max_new_tokens}"
                + (" + doc bucket" if req.doc_cache is not None or req.prefix is not None
                   else "")
                + f" exceeds pool max_len {self.max_len}")
        self.queue.append(req)

    def submit_embed(self, req: EmbedRequest) -> None:
        if len(req.input_ids) > self.buckets[-1]:
            raise ValueError(f"embed prompt {len(req.input_ids)} exceeds largest prompt "
                             f"bucket {self.buckets[-1]}")
        if req.adapter is not None:
            raise ValueError(f"unknown adapter {req.adapter!r} (this pool serves no adapters)")
        self.embed_queue.append(req)

    # ---- embeddings ------------------------------------------------------

    def _dispatch_embeds(self):
        """One same-bucket embedding batch per scheduler step. Returns the
        in-flight (host copy, requests): results stream back while the next
        decode chunk computes."""
        if not self.embed_queue:
            return None
        if any(r.priority for r in self.embed_queue):
            self.embed_queue.sort(key=lambda r: -r.priority)  # stable
        bucket = _bucket(len(self.embed_queue[0].input_ids), self.buckets)
        group, rest = [], []
        for r in self.embed_queue:
            if len(group) < self.embed_batch and _bucket(len(r.input_ids),
                                                         self.buckets) == bucket:
                group.append(r)
            else:
                rest.append(r)
        self.embed_queue = rest
        n = len(group)
        ids = np.full((n, bucket), self.pad_id, np.int32)
        mask = np.zeros((n, bucket), np.int32)
        pmask = np.zeros((n, bucket), np.int32)
        for i, r in enumerate(group):
            ln = len(r.input_ids)
            ids[i, :ln] = r.input_ids
            mask[i, :ln] = 1
            # instruction tokens are left out of mean pooling only
            start = r.instr_len if "mean" in self.pooling_method else 0
            pmask[i, start:ln] = 1
        emb = _encode_step(self.params, self.cfg, self._put(ids), self._put(mask),
                           self._put(pmask), pooling_method=self.pooling_method,
                           causal=self.embed_causal, normalized=self.normalized)
        return _HostCopy(emb.float()), group

    def _process_embeds(self, prev) -> None:
        if prev is None:
            return
        copy, group = prev
        (out,) = copy.get()
        for i, r in enumerate(group):
            self.finished_embeds.append(EmbedCompletion(r.request_id, out[i]))
            if self.on_embedding is not None:
                self.on_embedding(r.request_id, out[i])

    def take_embeddings(self) -> List[EmbedCompletion]:
        """Drain finished embeddings (finish order)."""
        out, self.finished_embeds = self.finished_embeds, []
        return out

    # ---- admission -------------------------------------------------------

    def _doc_len(self, r: Request) -> int:
        if r.prefix is not None:
            return self.prefixes[r.prefix][1]
        if r.doc_cache is not None:
            return r.doc_cache[2]
        return 0

    def _table_row(self, slot: int, pids: List[int], prefix_pids=()) -> np.ndarray:
        table = np.zeros(self.max_len // self.page, np.int32)
        table[:len(prefix_pids)] = prefix_pids
        table[len(prefix_pids):len(prefix_pids) + len(pids)] = pids
        self._slot_pages[slot] = pids
        return table

    def _admit(self) -> None:
        if any(r.priority for r in self.queue):
            self.queue.sort(key=lambda r: -r.priority)  # stable: FIFO ties
        reserved = {p.slot for p in self._pending}
        free = [i for i in range(self.B)
                if i not in self.slots and i not in reserved and i not in self._draining]
        taken: List[tuple] = []  # (request, private page ids | None)
        while self.queue and len(taken) < len(free):
            r = self.queue[0]
            pids = None
            if self.paged:
                n = self._pages_needed(r)
                if n > len(self._free_pages):
                    break  # FIFO: the head waits for pages to free
                pids = [self._free_pages.pop() for _ in range(n)]
            taken.append((self.queue.pop(0), pids))
        if not taken:
            return
        if self.prefill_chunk is not None:
            # fresh prompts stream in chunks between decode chunks;
            # continuations keep the grouped path (their document is cached)
            rest = []
            for r, pids in taken:
                if r.doc_cache is None and r.prefix is None:
                    b = _bucket(len(r.input_ids), self.buckets)
                    self._pending.append(_Pending(
                        request=r, slot=free.pop(0), bucket=b, pids=pids,
                        cache=init_cache(self.cfg, 1, b, device=self.device,
                                         quant=self.kv_quant)))
                else:
                    rest.append((r, pids))
            taken = rest
            if not taken:
                return
        groups: Dict[tuple, List[tuple]] = {}
        for r, pids in taken:
            b = _bucket(len(r.input_ids), self.buckets)
            if r.prefix is not None:
                db, kind = len(self.prefixes[r.prefix][0]) * self.page, "prefix"
            elif r.doc_cache is not None:
                db, kind = _bucket(r.doc_cache[2], self.buckets), "host"
            else:
                db, kind = 0, "fresh"
            groups.setdefault((db, b, kind), []).append((r, pids))
        for (dbucket, bucket, kind), rps in groups.items():
            rs = [r for r, _ in rps]
            ids = np.full((len(rs), bucket), self.pad_id, np.int32)
            mask = np.zeros((len(rs), bucket), np.int32)
            for j, r in enumerate(rs):
                ids[j, :len(r.input_ids)] = r.input_ids
                mask[j, :len(r.input_ids)] = 1
            ids_t, mask_t = self._put(ids), self._put(mask)
            samp = self._samp_rows(rs)
            if kind == "fresh":
                rowc, firsts = _prefill_program(self.params, self.cfg, ids_t, mask_t, samp,
                                                quant=self.kv_quant)
            elif kind == "host":
                rowc, firsts = self._prefill_continue(rs, ids_t, mask_t, dbucket, samp)
            else:
                rowc, firsts = self._prefill_continue_prefix(rs, ids_t, mask_t, dbucket, samp)
            host_firsts = _HostCopy(firsts)
            for j, (r, pids) in enumerate(rps):
                slot = free.pop(0)
                write_len = dbucket + len(r.input_ids)
                pos0 = self._doc_len(r) + len(r.input_ids)
                if self.paged:
                    prefix_pids = self.prefixes[r.prefix][0] if kind == "prefix" else ()
                    _insert_paged_program(
                        self.carry, rowc, firsts, j, slot, self._table_row(slot, pids,
                                                                           prefix_pids),
                        write_len, pos0, r.max_new_tokens, **self._arming(r),
                        copy_from_page=dbucket // self.page if kind == "prefix" else 0,
                        eos_id=self.eos_id)
                else:
                    _insert_program(self.carry, rowc, firsts, j, slot, write_len, pos0,
                                    r.max_new_tokens, **self._arming(r), eos_id=self.eos_id)
                self.slots[slot] = _Slot(request=r, first_src=(host_firsts, j))

    def _advance_pending(self) -> None:
        """Advance every chunked prefill by one chunk and fold completed ones
        into their reserved slots."""
        C = self.prefill_chunk
        for p in list(self._pending):
            seg = p.request.input_ids[p.filled:p.filled + C]
            ids = np.full((1, C), self.pad_id, np.int32)
            mask = np.zeros((1, C), np.int32)
            ids[0, :len(seg)] = seg
            mask[0, :len(seg)] = 1
            p.cache, p.first = _prefill_chunk_program(self.params, self.cfg, p.cache,
                                                      self._put(ids), self._put(mask),
                                                      self._samp_rows([p.request]))
            p.filled += len(seg)
            if p.filled >= len(p.request.input_ids):
                self._pending.remove(p)
                self._insert_pending(p)

    def _insert_pending(self, p: _Pending) -> None:
        r = p.request
        n = len(r.input_ids)
        if self.paged:
            _insert_paged_program(self.carry, p.cache, p.first, 0, p.slot,
                                  self._table_row(p.slot, p.pids), n, n, r.max_new_tokens,
                                  **self._arming(r), copy_from_page=0, eos_id=self.eos_id)
        else:
            _insert_program(self.carry, p.cache, p.first, 0, p.slot, n, n, r.max_new_tokens,
                            **self._arming(r), eos_id=self.eos_id)
        self.slots[p.slot] = _Slot(request=r, first_src=(_HostCopy(p.first), 0))

    def _prefill_continue_prefix(self, rs, ids, mask, dbucket, samp=None):
        """Gather the group's shared prefix pages on the device into the dense
        doc tensors the continuation prefill takes."""
        npg = dbucket // self.page
        pt = np.zeros((len(rs), npg), np.int64)
        dl = np.zeros((len(rs),), np.int64)
        for j, r in enumerate(rs):
            pt[j], dl[j] = self.prefixes[r.prefix]
        dk, dv, sc = _gather_prefix_program(self.carry.cache, self._put(pt))
        doc_mask = (np.arange(dbucket)[None, :] < dl[:, None]).astype(np.int32)
        return _prefill_continue_program(self.params, self.cfg, dk, dv, sc,
                                         self._put(doc_mask), self._put(dl), ids, mask, samp)

    def _prefill_continue(self, rs, ids, mask, dbucket, samp=None):
        """Stack the group's host doc caches into [L, rows, dbucket, ...]
        device tensors and run the continuation prefill."""
        k0 = torch.as_tensor(rs[0].doc_cache[0])
        L, _, KD = k0.shape
        rows = len(rs)
        doc_k = torch.zeros((L, rows, dbucket, KD), dtype=k0.dtype, device=self.device)
        doc_v = torch.zeros_like(doc_k)
        doc_mask = np.zeros((rows, dbucket), np.int32)
        doc_lens = np.zeros((rows,), np.int64)
        scales = None
        if self.kv_quant:
            s0 = torch.as_tensor(rs[0].doc_cache[3])
            ks = torch.zeros((L, rows, s0.shape[1], dbucket), dtype=s0.dtype,
                             device=self.device)
            scales = (ks, torch.zeros_like(ks))
        for j, r in enumerate(rs):
            k, v, w, ksj, vsj = r.doc_cache
            doc_k[:, j, :w] = torch.as_tensor(k)[:, :w].to(self.device)
            doc_v[:, j, :w] = torch.as_tensor(v)[:, :w].to(self.device)
            doc_mask[j, :w] = 1
            doc_lens[j] = w
            if scales is not None:
                scales[0][:, j, :, :w] = torch.as_tensor(ksj)[..., :w].to(self.device)
                scales[1][:, j, :, :w] = torch.as_tensor(vsj)[..., :w].to(self.device)
        return _prefill_continue_program(self.params, self.cfg, doc_k, doc_v, scales,
                                         self._put(doc_mask), self._put(doc_lens), ids, mask,
                                         samp)

    # ---- results ---------------------------------------------------------

    def _emit(self, slot: int, tok: int) -> None:
        """Account one generated token: append it, fire the streaming
        callback, and retire the slot on EOS or budget."""
        s = self.slots[slot]
        s.generated.append(tok)
        if self.on_token is not None:
            self.on_token(s.request.request_id, tok)
        done_eos = tok == self.eos_id
        if done_eos or len(s.generated) >= s.request.max_new_tokens:
            self.finished.append(Completion(
                request_id=s.request.request_id, token_ids=list(s.generated),
                finish_reason="eos" if done_eos else "length",
                prompt_len=len(s.request.input_ids)))
            del self.slots[slot]
            # the slot's cache rows stay as dead data; the next insert
            # rebuilds the mask. Private pages return to the pool (prefix
            # pages stay pinned): an in-flight chunk may still read them, but
            # a later write is ordered after it on the stream, so stale reads
            # only feed inactive rows' discarded output.
            if self.paged:
                self._free_pages.extend(self._slot_pages.pop(slot, []))

    def cancel(self, request_id) -> bool:
        """Cancel a request wherever it is: queued (dropped), mid chunked
        prefill (slot and pages released), or decoding (its device row is
        deactivated; the slot cools down for two scheduler steps so that an
        in-flight chunk's stale emissions never reach a new tenant). Emits a
        Completion with finish_reason 'cancelled' and the tokens generated so
        far. Returns False for an unknown id (e.g. already finished)."""
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                self.queue.pop(i)
                self.finished.append(Completion(request_id, [], "cancelled",
                                                len(r.input_ids)))
                return True
        for i, p in enumerate(self._pending):
            if p.request.request_id == request_id:
                self._pending.pop(i)
                if p.pids:
                    self._free_pages.extend(p.pids)
                self.finished.append(Completion(request_id, [], "cancelled",
                                                len(p.request.input_ids)))
                return True
        for slot, sl in self.slots.items():
            if sl.request.request_id == request_id:
                _deactivate_program(self.carry, slot)
                self.finished.append(Completion(request_id, list(sl.generated), "cancelled",
                                                len(sl.request.input_ids)))
                del self.slots[slot]
                if self.paged:
                    self._free_pages.extend(self._slot_pages.pop(slot, []))
                self._draining[slot] = 2
                return True
        return False

    def _resolve_firsts(self) -> None:
        """Read any pending prefill first tokens (lazily, so admission never
        waited for them) and account them as emissions."""
        for slot in list(self.slots):
            s = self.slots[slot]
            if s.first_src is None:
                continue
            copy, j = s.first_src
            s.first_src = None
            self._emit(slot, int(copy.get()[0][j]))

    def _process(self, chunk: Optional[_HostCopy]) -> None:
        """Read one chunk's results and retire finished rows. First tokens
        resolve first: a slot's prefill token precedes its chunk tokens."""
        self._resolve_firsts()
        if chunk is None:
            return
        toks, emitted = chunk.get()  # [steps, B]; speculative: [steps, B, k+1], n_emit
        if self.speculative:
            for i in list(self.slots):
                for step in range(toks.shape[0]):
                    for t in toks[step, i, :emitted[step, i]].tolist():
                        self._emit(i, int(t))
                        if i not in self.slots:
                            break
                    if i not in self.slots:
                        break
            return
        for i in list(self.slots):
            # rows the device already stopped have emitted=False, so stale
            # chunk data for a reused slot index masks itself
            for t in toks[emitted[:, i], i].tolist():
                self._emit(i, int(t))
                if i not in self.slots:
                    break  # the device stopped this row too (EOS/budget)

    def _chunk_steps(self) -> int:
        """Decode steps for the next chunk: chunk_size, or with
        adaptive_chunk a power of two toward the earliest possible
        completion while requests wait (the host knows each row's remaining
        budget exactly). 0 when every row is already fully dispatched.
        Speculative pools keep chunk_size: a verify step emits up to k + 1
        tokens, so steps do not map onto the budget."""
        if self.speculative:
            return self.chunk_size
        rem = [s.request.max_new_tokens - 1 - s.dispatched for s in self.slots.values()]
        live = [r for r in rem if r > 0]
        if not live:
            return 0
        if not self.adaptive_chunk:
            return self.chunk_size
        if self.queue or self._pending:
            m = min(live)  # round down: never overshoot a completion
            return self.chunk_size if m >= self.chunk_size else 1 << (m.bit_length() - 1)
        m = max(live)  # nothing waits: one chunk covering the longest row
        if m >= self.chunk_size:
            return self.chunk_size
        return 1 << (m - 1).bit_length() if m > 1 else 1

    def step(self) -> int:
        """One scheduler iteration: admit what fits, dispatch one decode
        chunk for the pool, and process results (with overlap, the previous
        chunk's). Returns the number of occupied slots (0 = pool empty; a
        nonzero return with no chunk dispatched means rows are fully
        dispatched and await retirement: keep stepping until 0)."""
        if not self.overlap:
            self._process(self._prev)
            self._prev = None
            self._process_embeds(self._prev_embed)
            self._prev_embed = None
        self._admit()
        if self.prefill_chunk is not None:
            self._advance_pending()
        cur_embed = self._dispatch_embeds()
        n_active = len(self.slots)
        cur = None
        steps = self._chunk_steps() if self.slots else 0
        if steps:
            if self.speculative:
                toks, emitted = _spec_chunk_program(self.params, self.cfg, self.carry,
                                                    steps=steps, ngram=self.spec_ngram,
                                                    k=self.spec_k, eos_id=self.eos_id,
                                                    pad_id=self.pad_id)
            else:
                toks, emitted = _decode_chunk_program(self.params, self.cfg, self.carry,
                                                      steps=steps, eos_id=self.eos_id,
                                                      pad_id=self.pad_id, sample=self.sampling)
            cur = _HostCopy(toks, emitted)
            self._steps += steps
            for s in self.slots.values():
                s.dispatched += steps
        if self.overlap:
            self._process(self._prev)
            self._process_embeds(self._prev_embed)
        self._prev = cur
        self._prev_embed = cur_embed
        for slot in list(self._draining):
            self._draining[slot] -= 1
            if self._draining[slot] <= 0:
                del self._draining[slot]
        return n_active

    def run(self, requests: Sequence[Union[Request, EmbedRequest]] = ()) -> List[Completion]:
        """Serve until the queue and the pool drain; returns generation
        completions in finish order. Takes Request and EmbedRequest;
        embeddings are drained with take_embeddings()."""
        for r in requests:
            if isinstance(r, EmbedRequest):
                self.submit_embed(r)
            else:
                self.submit(r)
        while (self.queue or self.slots or self._pending or self._prev is not None
               or self.embed_queue or self._prev_embed is not None):
            self.step()
        out, self.finished = self.finished, []
        return out
