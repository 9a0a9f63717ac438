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

import torch  # noqa: E402


def _settle_cpu_vector_math() -> None:
    """PyTorch's CPU build computes exp, log, sin and cos of a contiguous
    float tensor with MKL's vector math (VML), which picks its kernel at its
    first call in a process. When that first call comes from two intra-op
    threads at once, one thread can get MKL's AVX2 low-accuracy exp (VML_EP,
    relative error up to 1.5e-4) for its whole chunk: the port's plain
    attention then came back up to 1.05e-4 off in about one fresh process in
    ten. One call on a tiny tensor, which runs on this thread alone, makes
    the first call before any parallel one, for each function the port's
    plain paths use."""
    x = torch.ones(8)
    for f in (torch.exp, torch.log, torch.sin, torch.cos):
        f(x)


_settle_cpu_vector_math()

from gritlm_tpu_torch.gritlm import GritLM  # noqa: E402,F401
