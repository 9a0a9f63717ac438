"""Training-side helpers of the port. Only the prompt templates are ported
so far (the RAG path formats its embed instructions with them)."""
