"""gritlm_tpu_torch: GritLM on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of the JAX package `gritlm_tpu`, which stays beside it as the
reference. It imports torch and nothing of JAX or `gritlm_tpu`. Entry points
run on CUDA unless the caller passes `device="cpu"`; there every
hand-written kernel (flash attention forward and backward, flash decode,
paged decode, fused norm+pool, the index's fused scores + segment max, the
w8a16 / w4a16 quantized-weight matmuls) runs its plain PyTorch version,
which is how the CPU tests hold the port against the JAX package.

  - models/   dense Mistral-family trunk (stacked params, KV cache, remat,
              lazy LoRA weights, int8/int4 weight leaves), HF-safetensors
              load/export
  - ops/      kernel wrappers + plain versions, attention dispatch, pooling
  - csrc/     the CUDA sources, built by ops/_build.py at first use
  - index/    FlatIndex: exact inner-product search on the device
  - rag/      RAGEngine (seven cache modes, doc-cache store and pool,
              serve()), the rag.eval CLI, QA metrics, tasks and corpus loading
  - serving.py / serve.py  the continuous-batching ServingEngine (dense and
              paged KV pools) and its CLI
  - eval/     the RAG latency protocol
  - training/ GRIT training on one device (train_step with GradCache,
              LoRA and QLoRA, data pipeline, checkpoints), weight
              quantization (quant.py), and its CLI
              `python -m gritlm_tpu_torch.training.run`; prompt templates
"""

__version__ = "0.1.0"

from gritlm_tpu_torch.gritlm import GritLM  # noqa: E402,F401
