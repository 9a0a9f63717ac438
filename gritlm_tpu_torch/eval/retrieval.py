"""Retrieval evaluation: encode corpus and queries, exact top-k search, and
nDCG@k / MAP@k / Recall@k / Precision@k / MRR@k against qrels (port of
gritlm_tpu.eval.retrieval).

A self-contained BEIR-style evaluator, so retrieval quality is scored with
no network access; the MTEB adapter (mteb_adapter.py) layers on top when the
`mteb` package and its datasets are available. The corpus goes into an
fp32 `FlatIndex` on the model's device, as the JAX evaluator builds it, so
its search runs K9's fp32 kernel (`ops/scores_segmax.py`).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch


def _dcg(rels: Sequence[float]) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels))


def retrieval_metrics(
    results: Dict[str, Dict[str, float]],  # qid -> {doc_id: score}
    qrels: Dict[str, Dict[str, int]],  # qid -> {doc_id: relevance}
    k_values: Sequence[int] = (1, 3, 5, 10, 100),
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in k_values:
        ndcg, _map, recall, precision, mrr = [], [], [], [], []
        for qid, rels in qrels.items():
            if qid not in results:
                continue
            ranked = sorted(results[qid].items(), key=lambda x: -x[1])[:k]
            gains = [rels.get(d, 0) for d, _ in ranked]
            ideal = sorted(rels.values(), reverse=True)[:k]
            idcg = _dcg(ideal)
            ndcg.append(_dcg(gains) / idcg if idcg > 0 else 0.0)
            n_rel = sum(1 for v in rels.values() if v > 0)
            hits = [1.0 if g > 0 else 0.0 for g in gains]
            recall.append(sum(hits) / n_rel if n_rel else 0.0)
            precision.append(sum(hits) / k)
            num_correct, ap = 0, 0.0
            for i, h in enumerate(hits):
                if h:
                    num_correct += 1
                    ap += num_correct / (i + 1)
            _map.append(ap / min(n_rel, k) if n_rel else 0.0)
            rr = 0.0
            for i, h in enumerate(hits):
                if h:
                    rr = 1.0 / (i + 1)
                    break
            mrr.append(rr)

        def avg(x):
            return round(float(np.mean(x)) if x else 0.0, 5)

        out[f"ndcg_at_{k}"] = avg(ndcg)
        out[f"map_at_{k}"] = avg(_map)
        out[f"recall_at_{k}"] = avg(recall)
        out[f"precision_at_{k}"] = avg(precision)
        out[f"mrr_at_{k}"] = avg(mrr)
    return out


def evaluate_retrieval(
    model,  # GritLM
    corpus: Dict[str, dict],  # doc_id -> {"title": ..., "text": ...}
    queries: Dict[str, str],  # qid -> text
    qrels: Dict[str, Dict[str, int]],
    query_instruction: str = "",
    corpus_instruction: str = "",
    batch_size: int = 32,
    max_length: int = 512,
    top_k: int = 100,
    k_values: Sequence[int] = (1, 3, 5, 10, 100),
    reranker=None,
    rerank_depth: int = 10,
) -> Dict[str, float]:
    """Dense retrieval eval: exact cosine top-k through an fp32 FlatIndex on
    the model's device. `reranker` optionally rescores the top
    `rerank_depth` docs per query (the generative yes-logit reranker,
    eval/rerank.py); its metrics come back beside the dense ones with a
    `rerank_` prefix."""
    from gritlm_tpu_torch.index import FlatIndex

    doc_ids = list(corpus.keys())
    doc_embs = model.encode_corpus(
        [corpus[d] for d in doc_ids],
        instruction=corpus_instruction, batch_size=batch_size,
        max_length=max_length, convert_to_tensor=True,
    )
    index = FlatIndex(doc_embs.shape[1], len(doc_ids), dtype=torch.float32,
                      device=model.device)
    index.add(doc_embs)

    qids = list(queries.keys())
    q_embs = model.encode_queries(
        [queries[q] for q in qids],
        instruction=query_instruction, batch_size=batch_size,
        max_length=max_length, convert_to_tensor=True,
    )
    top_k = min(top_k, len(doc_ids))
    scores, ids = index.search(q_embs, k=top_k)
    results = {
        qid: {doc_ids[int(d)]: float(s) for d, s in zip(ids[i], scores[i])}
        for i, qid in enumerate(qids)
    }
    metrics = retrieval_metrics(results, qrels, k_values)
    if reranker is not None:
        # both metric sets: the dense ones under their own names, the
        # reranked ones prefixed
        reranked = reranker.rerank(
            queries, {d: corpus[d] for d in doc_ids}, results, depth=rerank_depth
        )
        for key, v in retrieval_metrics(reranked, qrels, k_values).items():
            metrics["rerank_" + key] = v
    return metrics
