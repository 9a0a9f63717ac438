"""Evaluation harnesses of the port. Only the RAG latency protocol
(`latency.py`) is ported so far."""
