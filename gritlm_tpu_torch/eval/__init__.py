"""Evaluation harnesses of the port: retrieval metrics and the dense
retrieval eval (retrieval.py), the generative reranker (rerank.py), the
MTEB adapter and CLI (mteb_adapter.py, mteb.py), result aggregation
(aggregate.py), generative benchmarks (generative.py) and the RAG latency
protocol (latency.py)."""

from gritlm_tpu_torch.eval.retrieval import evaluate_retrieval, retrieval_metrics  # noqa: F401
