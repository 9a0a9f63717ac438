"""RAG latency harness (port of gritlm_tpu.eval.latency).

The reference's latency protocol (scripts/raglatency.sh sweep grid and the
rag/eval.py:341-366 JSON schema): synthetic queries and docs of fixed token
lengths, per-mode timing with cache-precompute time excluded, results keyed
"{qlen}-{dlen}-{maxtoks}-{device}-{mode}". The timed region is a batch of
queries per call, and the fixed per-call floor (a null op on the model's
device, fenced) is stored beside the results.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SWEEP_LENGTHS = (250, 500, 1000, 2000, 4000)
SWEEP_MODES = ("prompt_query_doc", "query", "doc", "querydoc", "docquery")

logger = logging.getLogger(__name__)


def synthetic_text(tokenizer, n_tokens: int) -> str:
    """A string that tokenizes to about n_tokens (a fixed repeated unit)."""
    unit = "lorem "
    per = max(tokenizer.tokenize_len(unit, add_special_tokens=False), 1)
    return unit * (n_tokens // per)


def measure_dispatch_floor(device, reps: int = 20) -> float:
    """Fixed per-call latency on `device`: a null op, fenced by
    torch.cuda.synchronize() on a CUDA device (by nothing on the CPU)."""
    device = torch.device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)

    def call():
        x.add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return (time.perf_counter() - t0) / reps


def measure_latency(
    engine,  # RAGEngine with a built index of synthetic docs
    queries: Sequence[str] | str,
    mode: str,
    n_queries: int = 8,  # batch per timed call
    reps: int = 10,
    max_new_tokens: int = 16,
    warmup: int = 2,
) -> Dict[str, float]:
    """Time `reps` batched answer calls; per-query stats (RAGResult.seconds
    is already wall time / batch with cache-precompute time excluded)."""
    if isinstance(queries, str):
        queries = [queries] * n_queries
    times: List[float] = []
    for i in range(warmup + reps):
        rs = engine.answer_batch(list(queries), mode=mode, max_new_tokens=max_new_tokens)
        if i >= warmup:
            times.append(rs[0].seconds)
    return {
        "avg": float(np.mean(times)),
        "std": float(np.std(times)),
        "p50": float(np.median(times)),
        "min": float(np.min(times)),
        "total": float(np.sum(times)),
        "n": reps,
        "batch": len(queries),
    }


def run_sweep(
    model,
    lengths: Sequence[int] = SWEEP_LENGTHS,
    modes: Sequence[str] = SWEEP_MODES,
    query_lengths: Optional[Sequence[int]] = None,
    max_new_tokens: int = 16,
    n_queries: int = 8,
    reps: int = 10,
    n_docs: int = 16,
    out_file: Optional[str] = None,
    device: Optional[str] = None,
    cache_docs: bool = True,
    warmup: int = 2,
) -> Dict[str, dict]:
    """The qlen x dlen x mode grid on synthetic data, keyed
    '{qlen}-{dlen}-{maxtoks}-{device}-{mode}'. With cache_docs (default)
    the doc modes read caches precomputed at build (the fetch is timed as
    serving cost), and querydoc reads the after-query variant."""
    from gritlm_tpu_torch.rag import RAGEngine

    device = device or model.device.type
    query_lengths = query_lengths or lengths
    results: Dict[str, dict] = {
        "_meta": {
            "dispatch_floor_s": measure_dispatch_floor(model.device),
            "batch_per_call": n_queries,
            "reps": reps,
            "device": device,
        }
    }
    for dlen in lengths:
        logger.info("sweep: building index, dlen=%d (%d docs)", dlen, n_docs)
        engine = RAGEngine(model, max_new_tokens=max_new_tokens,
                           encode_max_length=max(dlen + 64, 128))
        docs = [{"title": "", "text": synthetic_text(model.tokenizer, dlen)}
                for _ in range(n_docs)]
        engine.build_index(docs, batch_size=min(n_docs, 8), cache_docs=cache_docs)
        if cache_docs and any(m == "querydoc" for m in modes):
            engine.precompute_all_doc_caches(batch_size=8, after_query=True)
        for qlen in query_lengths:
            query = synthetic_text(model.tokenizer, qlen)
            for mode in modes:
                stats = measure_latency(engine, query, mode, n_queries=n_queries, reps=reps,
                                        max_new_tokens=max_new_tokens, warmup=warmup)
                key = f"{qlen}-{dlen}-{max_new_tokens}-{device}-{mode}"
                results[key] = stats
                logger.info("sweep: %s avg=%.4fs", key, stats["avg"])
                if out_file:
                    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
                    with open(out_file, "w") as f:
                        json.dump(results, f, indent=1)
        del engine  # its doc store and device pool go before the next length
    return results
