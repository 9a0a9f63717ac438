"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, runs on the CPU only when asked, and never computes a CUDA
tensor on a kernel's plain path; its config and tokenizer copies agree with
the JAX package's."""

import ast
import dataclasses
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import gritlm_tpu.config as jax_config
import gritlm_tpu.tokenizer as jax_tokenizer
import gritlm_tpu_torch
import gritlm_tpu_torch.config as port_config
import gritlm_tpu_torch.tokenizer as port_tokenizer
from gritlm_tpu_torch.ops import (
    _build,
    decode_attention,
    flash_attention,
    fused_pool,
    paged_attention,
    quant_matmul,
    scores_segmax,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gritlm_tpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "gritlm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_no_triton_at_module_level():
    """Modules are imported on machines with no triton."""
    for f in sorted((ROOT / "gritlm_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
        assert not any(n.split(".")[0] == "triton" for n in names), f


def test_gritlm_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gritlm_tpu_torch.GritLM(port_config.tiny_mistral())


def test_serving_without_device_needs_cuda(monkeypatch, tmp_path):
    """ServingEngine and the serve CLI default to CUDA and raise without it."""
    from gritlm_tpu_torch import serve
    from gritlm_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(port_config.tiny_mistral(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--model_preset", "tiny_mistral", "--requests", str(tmp_path / "r.jsonl"),
                    "--out", str(tmp_path / "o.jsonl")])


def _fake_cuda_tensor():
    t = mock.MagicMock(spec=torch.Tensor)
    t.device = torch.device("cuda", 0)
    return t


CALLS = {
    "flash_attention": (flash_attention, "flash_attention", "flash_attention_plain",
                        lambda f, x: f(x, x, x, x, causal=True)),
    "flash_attention_bwd_dq": (flash_attention, "flash_attention_bwd_dq",
                               "flash_attention_bwd_dq_plain",
                               lambda f, x: f(x, x, x, x, x, x, x, causal=True)),
    "flash_attention_bwd_dkv": (flash_attention, "flash_attention_bwd_dkv",
                                "flash_attention_bwd_dkv_plain",
                                lambda f, x: f(x, x, x, x, x, x, x, causal=False)),
    "flash_decode": (decode_attention, "flash_decode", "flash_decode_plain",
                     lambda f, x: f(x, x, x, x, causal=True, offset=3, layer=0)),
    "fused_pool": (fused_pool, "fused_norm_mean_pool", "fused_norm_mean_pool_plain",
                   lambda f, x: f(x, x, x, eps=1e-5)),
    "scores_segmax": (scores_segmax, "scores_segmax", "scores_segmax_plain",
                      lambda f, x: f(x, x, 7)),
    "paged_decode": (paged_attention, "paged_decode", "paged_decode_plain",
                     lambda f, x: f(x, x, x, x, x, layer=0)),
    "w8a16_matmul": (quant_matmul, "w8a16_matmul", "w8a16_matmul_plain",
                     lambda f, x: f(_shaped(x, 4, 64), {"q8": _shaped(_fake_cuda_tensor(), 64, 32),
                                                        "scale": x})),
    "w4a16_matmul": (quant_matmul, "w4a16_matmul", "w4a16_matmul_plain",
                     lambda f, x: f(_shaped(x, 4, 64), {"q4": _shaped(_fake_cuda_tensor(), 32, 32),
                                                        "scale": x})),
}


def _shaped(t, *shape):
    """A fake CUDA tensor with a shape (the quantized matmuls route by
    their row count before they reach the kernel)."""
    t.shape = torch.Size(shape)
    return t


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cuda_tensor_never_takes_the_plain_path(monkeypatch, name):
    """A CUDA tensor with the kernel unavailable raises; it is not computed
    by the plain version."""
    module, wrapper, plain, call = CALLS[name]

    def no_kernel(_name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(module, plain, mock.Mock(side_effect=AssertionError("plain path")))
    before = getattr(module, wrapper).launches
    with pytest.raises(RuntimeError, match="unavailable"):
        call(getattr(module, wrapper), _fake_cuda_tensor())
    assert getattr(module, wrapper).launches == before


def test_mixed_devices_raise():
    cpu = torch.zeros(1)
    with pytest.raises(ValueError):
        _build.plain_path(cpu, _fake_cuda_tensor())


def test_config_matches_jax():
    jfields = [f.name for f in dataclasses.fields(jax_config.ModelConfig)]
    pfields = [f.name for f in dataclasses.fields(port_config.ModelConfig)]
    assert jfields == pfields
    for preset in ("mistral_7b", "mixtral_8x7b", "tiny_mistral", "llama3_8b", "qwen2_7b",
                   "tiny_llama3", "tiny_qwen2", "tiny_mixtral"):
        assert (dataclasses.asdict(getattr(jax_config, preset)())
                == dataclasses.asdict(getattr(port_config, preset)())), preset
    hf = {"model_type": "llama", "hidden_size": 256, "num_attention_heads": 4,
          "torch_dtype": "float32",
          "rope_scaling": {"rope_type": "llama3", "factor": 8.0}}
    assert (dataclasses.asdict(jax_config.ModelConfig.from_hf_config(hf))
            == dataclasses.asdict(port_config.ModelConfig.from_hf_config(hf)))
    assert port_config.mistral_7b().torch_dtype == torch.bfloat16


def test_byte_tokenizer_matches_jax():
    texts = ["<s>Hello wörld</s>", "", "<|user|>\nHi\n<|embed|>\nthere"]
    jt, pt = jax_tokenizer.ByteTokenizer(), port_tokenizer.ByteTokenizer()
    je, pe = jt(texts, max_length=16), pt(texts, max_length=16)
    np.testing.assert_array_equal(je["input_ids"], pe["input_ids"])
    np.testing.assert_array_equal(je["attention_mask"], pe["attention_mask"])
    ilens = [m.instruction_token_lens(t, "<|user|>\nHi", e["input_ids"],
                                      e["attention_mask"])
             for m, t, e in ((jax_tokenizer, jt, je), (port_tokenizer, pt, pe))]
    np.testing.assert_array_equal(*ilens)
    assert pt.decode(pe["input_ids"][0]) == jt.decode(je["input_ids"][0])
