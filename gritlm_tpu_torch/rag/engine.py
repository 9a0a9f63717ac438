"""RAG engine with doc/query KV-cache reuse (port of gritlm_tpu.rag.engine).

The reference's seven cache modes:
  no_retrieval         plain chat answer
  prompt_query_doc     query-then-doc in the prompt (no cache)
  prompt_doc_query     doc-then-query in the prompt (no cache)
  query                reuse the query-encode KV cache, append doc text
  doc                  reuse the doc-encode KV cache, append query text
  querydoc / docquery  concatenate both caches (slot concat; each cache was
                       encoded without seeing the other)

Embedding and generation share weights, so the KV cache captured during the
bidirectional encode is consumed directly by the causal decoder: a cache is
written slots plus a validity mask (models/transformer.KVCache), and the
reference's per-layer torch.cat along the sequence becomes
generate.concat_caches. Timing follows the reference: doc-encode time is
excluded when the doc cache would have been precomputed at index build.

Per-doc caches precomputed at build live in a host store (CPU tensors,
trimmed to each doc's valid prefix). While the whole store fits
`doc_pool_bytes`, it is also stacked once into a device-resident pool
`[L, N_docs, W_max, ...]`, and a call's doc caches are one `index_select`
out of it; a larger store is copied to the device per call. `serve()`
answers through the continuous-batching ServingEngine (dense or paged pool;
greedy, sampled with `temperature > 0`, or speculative). With
`speculative=True` the answer step decodes by greedy prompt lookup
(spec_decode.py): in answer_batch through GritLM.generate_from_ids, in
serve() through the speculative verify pool with each retrieved document's
tokens as the request's lookup corpus (`Request.hist_ids`).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from gritlm_tpu_torch.generate import align_cache_len, concat_caches
from gritlm_tpu_torch.index.flat import FlatIndex
from gritlm_tpu_torch.models.transformer import KVCache
from gritlm_tpu_torch.spec_decode import spec_cache_extra
from gritlm_tpu_torch.training.templates import gritlm_instruction

logger = logging.getLogger(__name__)

# Prompt/continuation formats: the behavioral contract of the reference
# (rag/eval.py:19-34). {title}/{text} come from the retrieved passage.
NO_RETRIEVAL = "<|user|>\n{query}\n<|assistant|>\n"
PROMPT_QUERY_DOC = (
    "<|user|>\n{query}\n\n{title} {text}\n\n"
    "Optionally using the prior context answer the query prior to it\n<|assistant|>\n"
)
PROMPT_DOC_QUERY = (
    "<|user|>\n{title} {text}\n\n{query}\n\n"
    "Answer the prior query while optionally using the context prior to it\n<|assistant|>\n"
)
CONT_AFTER_QUERY_CACHE = (
    "\n<|user|>\n{title} {text}\n\n"
    "Optionally using the prior context answer the query prior to it\n<|assistant|>\n"
)
CONT_AFTER_DOC_CACHE = (
    "\n<|user|>\n{query}\n\n"
    "Answer the prior query while optionally using the context prior to it\n<|assistant|>\n"
)
CONT_AFTER_DOC_QUERY_CACHES = (
    "\n<|user|>\nAnswer the prior query while optionally using the context prior to it\n<|assistant|>\n"
)
CONT_AFTER_QUERY_DOC_CACHES = (
    "\n<|user|>\nOptionally using the prior context answer the query prior to it\n<|assistant|>\n"
)
ANSWER_PROMPT = "The answer is"


class CacheMode(str, enum.Enum):
    NO_RETRIEVAL = "no_retrieval"
    PROMPT_QUERY_DOC = "prompt_query_doc"
    PROMPT_DOC_QUERY = "prompt_doc_query"
    QUERY = "query"
    DOC = "doc"
    QUERYDOC = "querydoc"
    DOCQUERY = "docquery"


def _doc_fields(p: dict) -> dict:
    return {"title": p.get("title", ""), "text": p.get("text", "")}


def _doc_string(p: dict) -> str:
    """The exact string GritLM.encode_corpus embeds for a passage dict
    (title + ' ' + text), used for every doc-cache encode, so that index
    embeddings and KV caches tokenize the same document string."""
    return p["title"] + " " + p["text"] if "title" in p else p["text"]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 (which numpy lacks) as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@dataclasses.dataclass
class RAGResult:
    answer: str
    passages: List[dict]
    scores: List[float]
    seconds: float


class RAGEngine:
    def __init__(
        self,
        model,  # gritlm_tpu_torch.GritLM in unified mode
        index: Optional[FlatIndex] = None,
        max_new_tokens: int = 16,
        min_new_tokens: int = 0,
        encode_max_length: int = 2048,
        speculative: bool = False,
        spec_ngram: int = 3,
        spec_k: int = 7,
        doc_pool_bytes: int = 2 * 2**30,
    ):
        if speculative and min_new_tokens > 0:
            raise ValueError("speculative decoding is greedy-only and does not support "
                             "min_new_tokens (EOS suppression)")
        self.model = model
        self.index = index
        self.max_new_tokens = max_new_tokens
        self.min_new_tokens = min_new_tokens
        self.encode_max_length = encode_max_length
        # prompt-lookup speculative decoding for the answer step (greedy;
        # extractive answers quote the retrieved document)
        self.speculative = speculative
        self.spec_ngram = spec_ngram
        self.spec_k = spec_k
        # per-doc device caches for the B == 1 path, LRU-bounded: each entry
        # pins a whole per-doc KV cache on the device
        self._doc_cache: "OrderedDict[Any, KVCache]" = OrderedDict()
        self._doc_cache_limit = 4
        # build-time store: (doc id, after_query) -> (k [L, w, KD], v, w,
        # k_scale [L, Kv, w] or None, v_scale), CPU tensors
        self._doc_store: Dict[Any, Any] = {}
        # the last stacked doc-cache batch, device-resident: a repeat hit on
        # the same doc set skips the host -> device copy
        self._stacked_last: Optional[tuple] = None  # (key, KVCache)
        # device pool of every store entry, per after_query; None when the
        # pool would exceed doc_pool_bytes (fetches then copy from the host)
        self.doc_pool_bytes = doc_pool_bytes
        self._device_pool: Dict[bool, Any] = {}

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------------ build

    def build_index(
        self,
        passages: Sequence[dict],
        batch_size: int = 32,
        capacity: Optional[int] = None,
        mesh=None,
        cache_docs: bool = False,
        cache_batch_size: int = 8,
    ) -> FlatIndex:
        """Encode the corpus into a FlatIndex on the model's device. With
        `cache_docs`, also precompute every passage's KV cache into the host
        store (and the device pool, when it fits)."""
        # a new corpus invalidates every cache keyed by doc id
        self._doc_cache.clear()
        self._doc_store.clear()
        self._stacked_last = None
        self._device_pool.clear()
        embs = self.model.encode_corpus(
            list(passages), batch_size=batch_size, max_length=self.encode_max_length,
            instruction=gritlm_instruction(""), convert_to_tensor=True,
        )
        self.index = FlatIndex(embs.shape[1], capacity or len(passages), mesh=mesh,
                               device=self.device)
        self.index.add(embs, list(passages))
        if cache_docs:
            self.precompute_all_doc_caches(batch_size=cache_batch_size)
        return self.index

    def precompute_all_doc_caches(self, batch_size: int = 8, after_query: bool = False) -> None:
        """Encode every passage's KV cache into the host store, then pin the
        device pool (so the first answer does not pay for it)."""
        self._ensure_doc_entries(range(len(self.index.passages)), after_query=after_query,
                                 batch_size=batch_size)
        self._build_device_pool(after_query)

    def _encode_doc_caches(self, doc_strs: List[str], after_query: bool):
        # a doc cache that follows a query cache takes no bos and a leading
        # newline
        return self.model.encode(
            doc_strs,
            instruction=("\n" + gritlm_instruction("")) if after_query
            else gritlm_instruction(""),
            add_special_tokens=not after_query, max_length=self.encode_max_length,
            get_cache=True, batch_size=len(doc_strs),
        )

    def _ensure_doc_entries(self, doc_ids, after_query: bool = False,
                            batch_size: int = 8) -> None:
        """Encode any docs missing from the host store (no-op on a full hit)."""
        missing = sorted({int(d) for d in doc_ids if (int(d), after_query) not in self._doc_store})
        if missing:  # the store grows: a pinned pool is stale
            self._device_pool.pop(after_query, None)
        for start in range(0, len(missing), batch_size):
            ids = missing[start:start + batch_size]
            _, cache = self._encode_doc_caches(
                [_doc_string(self.index.passages[d]) for d in ids], after_query)
            widths = cache.mask.sum(dim=1).tolist()  # right-padded: valid prefixes
            wmax = max(1, max(widths))
            # cut to the batch's widest valid prefix on the device before the
            # copy to the host
            k, v = cache.k[:, :, :wmax].cpu(), cache.v[:, :, :wmax].cpu()
            ks = vs = None
            if cache.quantized:  # scales are slot-minor [L, b, Kv, S]
                ks, vs = cache.k_scale[..., :wmax].cpu(), cache.v_scale[..., :wmax].cpu()
            for i, (d, w) in enumerate(zip(ids, widths)):
                self._doc_store[(d, after_query)] = (
                    k[:, i, :w].clone(), v[:, i, :w].clone(), int(w),
                    None if ks is None else ks[:, i, :, :w].clone(),
                    None if vs is None else vs[:, i, :, :w].clone(),
                )

    def save_doc_store(self, path: str) -> None:
        """Write the host doc-cache store to one .npz beside a saved index, in
        the JAX package's layout: bf16 arrays as their uint16 bits under
        `<name>~bf16`, and a `__keys__` table of (doc id, after_query, width,
        quantized). Load with `load_doc_store`."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}

        def put(name: str, t: torch.Tensor) -> None:
            arrays[name + "~bf16" if t.dtype == torch.bfloat16 else name] = _to_numpy(t)

        keys = []
        for (doc_id, after_query), (k, v, w, ks, vs) in self._doc_store.items():
            tag = f"{doc_id}_{int(after_query)}"
            keys.append([int(doc_id), int(after_query), int(w), int(ks is not None)])
            put(f"k_{tag}", k)
            put(f"v_{tag}", v)
            if ks is not None:
                put(f"ks_{tag}", ks)
                put(f"vs_{tag}", vs)
        arrays["__keys__"] = np.asarray(keys, np.int64).reshape(-1, 4)
        np.savez(path, **arrays)

    def load_doc_store(self, path: str) -> int:
        """Load a doc-cache store written by either package; returns the
        number of entries. Replaces the current store (the caller makes sure
        it matches the index's doc ids)."""
        with np.load(path) as data:
            def get(name: str) -> torch.Tensor:
                if name + "~bf16" in data:
                    bits = np.ascontiguousarray(data[name + "~bf16"]).view(np.int16)
                    return torch.from_numpy(bits).view(torch.bfloat16)
                return torch.from_numpy(np.ascontiguousarray(data[name]))

            self._doc_store = {}
            self._stacked_last = None
            self._device_pool = {}
            for doc_id, after_query, w, quant in data["__keys__"]:
                tag = f"{doc_id}_{int(after_query)}"
                self._doc_store[(int(doc_id), bool(after_query))] = (
                    get(f"k_{tag}"), get(f"v_{tag}"), int(w),
                    get(f"ks_{tag}") if quant else None,
                    get(f"vs_{tag}") if quant else None,
                )
        return len(self._doc_store)

    def _stack(self, entries: List[tuple], W: int) -> tuple:
        """Device tensors k/v [L, n, W, KD] (and scales [L, n, Kv, W]) with
        each entry's valid prefix copied in, and widths [n]."""
        L, _, KD = entries[0][0].shape
        n = len(entries)
        k = torch.zeros((L, n, W, KD), dtype=entries[0][0].dtype, device=self.device)
        v = torch.zeros_like(k)
        ks = vs = None
        if entries[0][3] is not None:
            Kv = entries[0][3].shape[1]
            ks = torch.zeros((L, n, Kv, W), dtype=entries[0][3].dtype, device=self.device)
            vs = torch.zeros_like(ks)
        for i, (ki, vi, w, ksi, vsi) in enumerate(entries):
            k[:, i, :w].copy_(ki)
            v[:, i, :w].copy_(vi)
            if ks is not None:
                ks[:, i, :, :w].copy_(ksi)
                vs[:, i, :, :w].copy_(vsi)
        widths = torch.tensor([e[2] for e in entries], dtype=torch.int32, device=self.device)
        return k, v, ks, vs, widths

    def _build_device_pool(self, after_query: bool) -> None:
        """Stack every store entry for `after_query` into device pools
        [L, N, W_max, ...] (one copy, at build or first fetch). Stores None
        instead when the pool would exceed `doc_pool_bytes`."""
        items = sorted(((key[0], e) for key, e in self._doc_store.items()
                        if key[1] == after_query), key=lambda item: item[0])
        if not items:
            self._device_pool[after_query] = None
            return
        es = [e for _, e in items]
        L, _, KD = es[0][0].shape
        W, N = max(e[2] for e in es), len(es)
        nbytes = 2 * L * N * W * KD * es[0][0].element_size()
        if es[0][3] is not None:
            nbytes += 2 * L * N * es[0][3].shape[1] * W * es[0][3].element_size()
        if nbytes > self.doc_pool_bytes:
            self._device_pool[after_query] = None
            return
        row_of = {d: i for i, (d, _) in enumerate(items)}  # doc id -> pool row
        self._device_pool[after_query] = (row_of, *self._stack(es, W))

    def _gather_from_pool(self, pool, doc_ids: List[int]) -> KVCache:
        """The batch's caches as one index_select on the pool's row axis
        (rows right-padded to the pool width; the mask marks valid
        prefixes). Only the [B] row ids cross to the device."""
        row_of, k, v, ks, vs, widths = pool
        rows = torch.tensor([row_of[d] for d in doc_ids], dtype=torch.int64, device=self.device)
        W = k.shape[2]
        mask = (torch.arange(W, device=self.device)[None, :]
                < widths.index_select(0, rows)[:, None]).to(torch.int32)
        return KVCache(
            k=k.index_select(1, rows), v=v.index_select(1, rows), mask=mask, length=W,
            k_scale=None if ks is None else ks.index_select(1, rows),
            v_scale=None if vs is None else vs.index_select(1, rows),
        )

    def _fetch_doc_caches(self, doc_ids: List[int], after_query: bool) -> Optional[KVCache]:
        """The stored caches of `doc_ids` as one device KVCache [L, B, W, ...]
        (W the widest doc of the batch; the mask marks each row's valid
        prefix): from the device pool when it is pinned, else copied from the
        host store. None unless every doc is in the store."""
        entries = [self._doc_store.get((d, after_query)) for d in doc_ids]
        if any(e is None for e in entries):
            return None
        if after_query not in self._device_pool:
            self._build_device_pool(after_query)
        pool = self._device_pool[after_query]
        if pool is not None and all(d in pool[0] for d in doc_ids):
            return self._gather_from_pool(pool, doc_ids)
        W = max(e[2] for e in entries)
        k, v, ks, vs, widths = self._stack(entries, W)
        mask = (torch.arange(W, device=self.device)[None, :] < widths[:, None]).to(torch.int32)
        return KVCache(k=k, v=v, mask=mask, length=W, k_scale=ks, v_scale=vs)

    def _concat_total(self, a: KVCache, b: KVCache, prompts: List[str], mnt: int) -> int:
        """Slot count the concatenated cache needs for generation (both
        caches' lengths + the bucketed continuation prompt + new tokens, the
        formula generate_from_ids applies), so concat_caches sizes its
        buffer once. The concat-mode prompts are one fixed template."""
        if len(set(prompts)) != 1:
            raise ValueError("concat-mode prompts must be identical")
        enc = self.model.tokenizer([prompts[0] + ANSWER_PROMPT], add_special_tokens=False)
        plen = len(enc["input_ids"][0])
        total = self.model.required_cache_len(plen, int(a.length) + int(b.length), mnt)
        if self.speculative:
            total = align_cache_len(total + spec_cache_extra(mnt, self.spec_k,
                                                             a.mask.shape[0]))
        return total

    def precompute_doc_cache(self, doc_id: int, mode: "CacheMode") -> None:
        """Encode one passage with KV capture into the per-doc memo (the B == 1
        path of answer_batch reads it)."""
        after_query = mode == CacheMode.QUERYDOC
        _, cache = self._encode_doc_caches([_doc_string(self.index.passages[doc_id])],
                                           after_query)
        self._doc_cache[(doc_id, after_query)] = cache
        while len(self._doc_cache) > self._doc_cache_limit:
            self._doc_cache.popitem(last=False)

    # ----------------------------------------------------------------- answer

    def answer(self, query: str, mode: CacheMode = CacheMode.PROMPT_QUERY_DOC,
               max_new_tokens: Optional[int] = None) -> RAGResult:
        """Answer one query under the given cache mode (the answer, the
        retrieved passages and the wall time, cache-precompute time
        excluded)."""
        return self.answer_batch([query], mode=mode, max_new_tokens=max_new_tokens)[0]

    def answer_batch(self, queries: List[str], mode: CacheMode = CacheMode.PROMPT_QUERY_DOC,
                     max_new_tokens: Optional[int] = None) -> List[RAGResult]:
        """Batched answering: one encode over all queries, one index search,
        one batched doc-cache fetch or encode, one batched generate."""
        mode = CacheMode(mode)
        mnt = max_new_tokens or self.max_new_tokens
        t0 = time.perf_counter()
        excluded = 0.0
        B = len(queries)
        if B == 0:
            return []

        if mode == CacheMode.NO_RETRIEVAL:
            prompts = [NO_RETRIEVAL.format(query=q) for q in queries]
            kv_cache, passages, scores = None, [[] for _ in queries], [[] for _ in queries]
            add_special = True
        else:
            needs_q_cache = mode in (CacheMode.QUERY, CacheMode.QUERYDOC, CacheMode.DOCQUERY)
            # embeddings stay on the device (convert_to_tensor): the search
            # reads them where they are
            if needs_q_cache:
                q_emb, q_cache = self.model.encode_queries(
                    queries, instruction=gritlm_instruction(""), get_cache=True,
                    max_length=self.encode_max_length,
                    batch_size=B,  # cache capture needs one encode batch
                    convert_to_tensor=True,
                )
            else:
                q_emb = self.model.encode_queries(
                    queries, instruction=gritlm_instruction(""),
                    max_length=self.encode_max_length, convert_to_tensor=True,
                )
                q_cache = None
            sc, ids = self.index.search(q_emb, k=1)
            doc_ids = [int(i) for i in ids[:, 0]]
            passages = [[self.index.passages[d]] for d in doc_ids]
            scores = [[float(s)] for s in sc[:, 0]]

            d_cache = None
            if mode in (CacheMode.DOC, CacheMode.QUERYDOC, CacheMode.DOCQUERY):
                after_query = mode == CacheMode.QUERYDOC
                memo_key = (doc_ids[0], after_query)
                stack_key = (tuple(doc_ids), after_query)
                stored = (
                    self._stacked_last[1]
                    if self._stacked_last and self._stacked_last[0] == stack_key
                    else self._fetch_doc_caches(doc_ids, after_query)
                )
                if stored is not None:
                    # precomputed at build: the fetch counts as serving cost
                    d_cache = stored
                    self._stacked_last = (stack_key, stored)
                elif B == 1 and memo_key in self._doc_cache:
                    d_cache = self._doc_cache[memo_key]
                    self._doc_cache.move_to_end(memo_key)
                else:
                    te = time.perf_counter()
                    _, d_cache = self._encode_doc_caches(
                        [_doc_string(p[0]) for p in passages], after_query)
                    excluded += time.perf_counter() - te
                    if B == 1:
                        self._doc_cache[memo_key] = d_cache
                        while len(self._doc_cache) > self._doc_cache_limit:
                            self._doc_cache.popitem(last=False)

            kv_cache = None
            if mode == CacheMode.QUERY:
                prompts = [CONT_AFTER_QUERY_CACHE.format(**_doc_fields(p[0])) for p in passages]
                kv_cache = q_cache
            elif mode == CacheMode.DOC:
                prompts = [CONT_AFTER_DOC_CACHE.format(query=q) for q in queries]
                kv_cache = d_cache
            elif mode == CacheMode.DOCQUERY:
                prompts = [CONT_AFTER_DOC_QUERY_CACHES] * B
                kv_cache = concat_caches(
                    d_cache, q_cache,
                    total_len=self._concat_total(d_cache, q_cache, prompts, mnt))
            elif mode == CacheMode.QUERYDOC:
                prompts = [CONT_AFTER_QUERY_DOC_CACHES] * B
                kv_cache = concat_caches(
                    q_cache, d_cache,
                    total_len=self._concat_total(q_cache, d_cache, prompts, mnt))
            elif mode == CacheMode.PROMPT_QUERY_DOC:
                prompts = [PROMPT_QUERY_DOC.format(query=q, **_doc_fields(p[0]))
                           for q, p in zip(queries, passages)]
            elif mode == CacheMode.PROMPT_DOC_QUERY:
                prompts = [PROMPT_DOC_QUERY.format(query=q, **_doc_fields(p[0]))
                           for q, p in zip(queries, passages)]
            add_special = kv_cache is None

        prompts = [p + ANSWER_PROMPT for p in prompts]
        # prompt modes carry query and doc inline: budget both plus the
        # template
        prompt_budget = max(4096, 2 * self.encode_max_length + 256)
        enc = self.model.tokenizer(prompts, max_length=prompt_budget,
                                   add_special_tokens=add_special)
        if kv_cache is None and any(len(r) >= prompt_budget for r in enc["input_ids"]):
            # truncation keeps the prefix, so an over-long document would
            # silently eat the query/template tail
            logger.warning("prompt-mode input hit the %d-token budget and was truncated; the "
                           "query/answer template may be cut off (raise encode_max_length)",
                           prompt_budget)
        res = self.model.generate_from_ids(
            enc["input_ids"], enc["attention_mask"], cache=kv_cache, max_new_tokens=mnt,
            min_new_tokens=self.min_new_tokens, speculative=self.speculative,
            spec_ngram=self.spec_ngram, spec_k=self.spec_k,
        )
        toks = res.tokens.cpu().numpy()  # waits for the device
        nv = res.num_valid.cpu().numpy()
        per_q = (time.perf_counter() - t0 - excluded) / B
        return [
            RAGResult(
                answer=self.model.tokenizer.decode(toks[i, : nv[i]], skip_special_tokens=True),
                passages=passages[i], scores=scores[i], seconds=per_q,
            )
            for i in range(B)
        ]

    def serve(
        self,
        queries: List[str],
        max_new_tokens: Optional[int] = None,
        slots: int = 8,
        chunk_size: int = 16,
        pool_max_len: int = 4096,
        prompt_buckets=(64, 128, 256, 512),
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        speculative: bool = False,
        spec_ngram: int = 3,
        spec_k: int = 7,
        paged: bool = False,
        page_size: int = 256,
    ) -> List[RAGResult]:
        """Continuous-batching RAG serving: retrieve per query, reuse each
        document's precomputed KV cache from the host doc store, and decode
        every answer through one ServingEngine slot pool (doc-cache mode).
        Each request holds a slot at its own doc bucket and frees it the
        moment its answer ends; greedy answers are those of
        answer_batch(mode=DOC) up to the kernels' order of sums.

        temperature > 0 samples each answer with its own generator (query i
        uses seed + i): fixed by `seed` whatever the slot scheduling (see
        serving.Request).

        speculative=True (greedy) runs the prompt-lookup verify pool with
        each request's lookup corpus seeded by its retrieved passage's
        tokens: extractive answers quote the document, so proposals come
        from the text the answer copies, while the document's KV still comes
        from the precomputed cache.

        paged=True pins each unique retrieved document's cache into shared
        pool pages once; queries on the same document read the same pages."""
        from gritlm_tpu_torch.serving import Request, ServingEngine

        t0 = time.perf_counter()
        mnt = max_new_tokens or self.max_new_tokens
        B = len(queries)
        if B == 0:
            return []
        q_emb = self.model.encode_queries(queries, instruction=gritlm_instruction(""),
                                          max_length=self.encode_max_length,
                                          convert_to_tensor=True)
        sc, ids = self.index.search(q_emb, k=1)
        doc_ids = [int(i) for i in ids[:, 0]]
        self._ensure_doc_entries(doc_ids, after_query=False)

        prompts = [CONT_AFTER_DOC_CACHE.format(query=q) + ANSWER_PROMPT for q in queries]
        enc = self.model.tokenizer(prompts, add_special_tokens=False)
        hists = [None] * B
        if speculative:
            denc = self.model.tokenizer(
                [_doc_string(self.index.passages[d]) for d in doc_ids], add_special_tokens=False)
            hists = [[t for t, m in zip(denc["input_ids"][i], denc["attention_mask"][i]) if m]
                     for i in range(B)]
        paged_kw: dict = {}
        if paged:
            # one shared page pool: every unique retrieved document pins
            # once; per-slot private tails cover prompt + answer budget (and
            # the verify chunk's slack)
            uniq = sorted(set(doc_ids))
            prefix_pages = sum(-(-self._doc_store[(d, False)][2] // page_size) for d in uniq)
            tail = max(prompt_buckets) + mnt + (spec_k if speculative else 0)
            paged_kw = dict(paged=True, page_size=page_size,
                            pool_pages=1 + prefix_pages + slots * -(-tail // page_size) + slots)
        eng = ServingEngine(
            self.model.config, self.model.params, max_batch=slots, max_len=pool_max_len,
            kv_quant=self.model.kv_quant, eos_id=self.model.tokenizer.eos_token_id,
            pad_id=self.model.tokenizer.pad_token_id, chunk_size=chunk_size,
            prompt_buckets=prompt_buckets, sampling=temperature > 0.0, speculative=speculative,
            spec_ngram=spec_ngram, spec_k=spec_k, device=self.device, **paged_kw,
        )
        if paged:
            for d in uniq:
                eng.register_prefix(d, self._doc_store[(d, False)])
        done = eng.run([
            Request(input_ids=[t for t, m in zip(enc["input_ids"][i], enc["attention_mask"][i])
                               if m],
                    max_new_tokens=mnt, request_id=str(i),
                    **({"prefix": doc_ids[i]} if paged
                       else {"doc_cache": self._doc_store[(doc_ids[i], False)]}),
                    temperature=temperature, top_k=top_k, top_p=top_p, seed=seed + i,
                    hist_ids=hists[i])
            for i in range(B)
        ])
        per_q = (time.perf_counter() - t0) / B
        by_id = {int(c.request_id): c for c in done}
        return [
            RAGResult(answer=self.model.tokenizer.decode(by_id[i].token_ids,
                                                         skip_special_tokens=True),
                      passages=[self.index.passages[doc_ids[i]]], scores=[float(sc[i, 0])],
                      seconds=per_q)
            for i in range(B)
        ]

    def evaluate(self, queries: List[str], gold_answers: List[List[str]],
                 mode: CacheMode = CacheMode.PROMPT_QUERY_DOC,
                 max_new_tokens: Optional[int] = None, batch_size: int = 8) -> Dict[str, Any]:
        """QA eval loop: EM/match/F1 and latency stats (the schema of the
        reference's *-latency.json). Queries run in batches through
        answer_batch."""
        from gritlm_tpu_torch.rag.metrics import evaluate_answers

        mode = CacheMode(mode)
        preds, times = [], []
        for a in range(0, len(queries), batch_size):
            for r in self.answer_batch(queries[a:a + batch_size], mode=mode,
                                       max_new_tokens=max_new_tokens):
                preds.append(r.answer)
                times.append(r.seconds)
        metrics = evaluate_answers(preds, gold_answers)
        metrics.update({
            "mode": str(mode.value),
            "avg_seconds": float(np.mean(times)) if times else 0.0,
            "std_seconds": float(np.std(times)) if times else 0.0,
            "p50_seconds": float(np.median(times)) if times else 0.0,
            "min_seconds": float(np.min(times)) if times else 0.0,
            "total_seconds": float(np.sum(times)),
            "n": len(queries),
            "predictions": preds,
        })
        return metrics
