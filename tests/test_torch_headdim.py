"""The port's serving path at head dims 64 and 96 against the JAX package, on
narrow Llama-3.2-1B-shaped models (float32, CPU).

Each config is built from a HF-style dict through both packages'
`ModelConfig.from_hf_config`: the published Llama-3.2-1B `config.json`
keys (tied embeddings, llama3 RoPE scaling with factor 32, low/high
frequency factors 1 and 4, original context 8192, rope_theta 500000) at a
narrow width: 2 layers, hidden 256, vocab 512, and

  - head_dim 64 with 4 heads and 2 KV heads (Llama-3.2-1B's head dim, GQA);
  - head_dim 96 with 4 heads and 4 KV heads (Kv * Dh = 384, a multiple of
    128, as the JAX decode kernel needs).

The JAX params from `gritlm_tpu.models.init_params` cross to the port as
numpy (`params_from_jax`). The port runs its kernels' plain versions (CPU
tensors); the JAX package its Pallas kernels in interpret mode or their
einsum paths, as its own tests run them. Tolerances: embeddings 1e-5, as
tests/test_torch_model.py holds the Mistral ones (float32 sums in another
order); greedy tokens, served tokens and RAG answers equal.

Also: `FlashAttentionFn` trains at head dims 64 and 96 on the CPU, its
gradients within 1e-4 of `jax.grad` through the JAX flash kernel
(interpret mode), as tests/test_flash.py holds the JAX side against its
reference; the kernels' head-dim rule. The train steps at these head dims
and the arguments the kernels get are in tests/test_torch_headdim_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import ModelConfig as JaxModelConfig
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.serving import EmbedRequest as JaxEmbedRequest
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.ops import flash_attention
from gritlm_tpu_torch.ops.flash_attention import FlashAttentionFn
from gritlm_tpu_torch.rag import RAGEngine
from gritlm_tpu_torch.serving import EmbedRequest, Request, ServingEngine

EMB_ATOL = 1e-5
GRAD_ATOL = 1e-4
DOCS = ["Bitcoin is a digital currency.", "A KV cache stores keys and values."]
PROMPTS = ["<s><|user|>\nWhat is a cache?\n<|assistant|>\n", "abc"]
INSTRUCTION = "<|user|>\nRetrieve the passage\n<|embed|>\n"
# (head_dim, heads, KV heads)
HEADS = {64: (4, 2), 96: (4, 4)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def llama_dict(head_dim: int) -> dict:
    """The published Llama-3.2-1B config.json keys, narrowed: 2 layers,
    hidden 256, vocab 512, `head_dim` with HEADS' head counts."""
    heads, kv = HEADS[head_dim]
    return {
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": heads, "num_key_value_heads": kv,
        "head_dim": head_dim, "vocab_size": 512, "max_position_embeddings": 131072,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        "torch_dtype": "float32",
    }


@functools.lru_cache(maxsize=None)
def _setup(head_dim: int):
    """(JAX config, port config, JAX params, port params) on the same weights."""
    jcfg = JaxModelConfig.from_hf_config(llama_dict(head_dim))
    tcfg = ModelConfig.from_hf_config(llama_dict(head_dim))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _models(head_dim: int):
    jcfg, tcfg, jparams, tparams = _setup(head_dim)
    return JaxGritLM(jcfg, params=jparams), GritLM(tcfg, params=tparams, device="cpu")


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_config_is_llama_shaped(head_dim):
    """Both packages read the dict alike: the head dim, tied embeddings, the
    llama3 RoPE scaling; the port's params have no separate LM head."""
    jcfg, tcfg, _, tparams = _setup(head_dim)
    assert tcfg.head_dim_ == jcfg.head_dim_ == head_dim
    assert tcfg.tie_word_embeddings and tcfg.rope_scaling_ == jcfg.rope_scaling_
    assert tcfg.rope_scaling_ == ("llama3", 32.0, 1.0, 4.0, 8192)
    assert "lm_head" not in tparams


@pytest.mark.parametrize("instruction", ["", INSTRUCTION])
@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_encode_matches_jax(head_dim, instruction):
    jm, tm = _models(head_dim)
    want = jm.encode(DOCS, instruction=instruction)
    got = tm.encode(DOCS, instruction=instruction)
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_greedy_generate_matches_jax(head_dim):
    """Ragged batch (one long prompt, one short), 8 tokens, token-exact."""
    jm, tm = _models(head_dim)
    enc = tm.tokenizer(PROMPTS)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))


LENS = [3, 9, 5, 12, 7, 4, 11]
POOL = dict(max_batch=3, max_len=32, chunk_size=4, prompt_buckets=(16,))
PAGED = dict(paged=True, page_size=8, pool_pages=10)


def _run(eng, req_cls, embed_cls):
    rng = np.random.default_rng(0)
    reqs = [req_cls(input_ids=rng.integers(3, 512, size=n).tolist(), max_new_tokens=8,
                    request_id=f"r{i}") for i, n in enumerate(LENS)]
    rng = np.random.default_rng(3)
    reqs += [embed_cls(input_ids=rng.integers(3, 256, size=n).tolist(), instr_len=2,
                       request_id=f"e{i}") for i, n in enumerate([6, 12, 9])]
    done = eng.run(reqs)
    return ({c.request_id: list(c.token_ids) for c in done},
            {c.request_id: c.embedding for c in eng.take_embeddings()})


@functools.lru_cache(maxsize=None)
def _jax_served(head_dim: int):
    jcfg, _, jparams, _ = _setup(head_dim)
    return _run(JaxServingEngine(jcfg, jparams, embed_batch=2, **POOL), JaxRequest,
                JaxEmbedRequest)


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_serving_engine_matches_jax(head_dim, pool):
    """More generation requests than slots beside embedding requests, through
    a dense and a paged pool: the JAX engine's tokens and pool embeddings."""
    _, tcfg, _, tparams = _setup(head_dim)
    eng = ServingEngine(tcfg, tparams, device="cpu", embed_batch=2, **POOL,
                        **(PAGED if pool == "paged" else {}))
    tokens, embs = _run(eng, Request, EmbedRequest)
    want_tokens, want_embs = _jax_served(head_dim)
    assert tokens == want_tokens
    assert set(embs) == set(want_embs)
    for rid, vec in want_embs.items():
        np.testing.assert_allclose(embs[rid], vec, atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_rag_doc_mode_matches_jax(head_dim):
    """RAGEngine in doc-caching mode (each passage's cache built
    bidirectionally, the query continued over it): JAX's passages and
    answers."""
    jm, tm = _models(head_dim)
    passages = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(6)]
    queries = ["what is fact number 3?", "tell me about place 5"]
    je = JaxRAGEngine(jm, max_new_tokens=4, encode_max_length=64)
    te = RAGEngine(tm, max_new_tokens=4, encode_max_length=64)
    je.build_index(passages, batch_size=4)
    te.build_index(passages, batch_size=4)
    want = je.answer_batch(queries, mode="doc")
    got = te.answer_batch(queries, mode="doc")
    assert [r.passages for r in got] == [r.passages for r in want]
    assert [r.answer for r in got] == [r.answer for r in want]


@pytest.mark.parametrize("head_dim,causal", [
    pytest.param(64, False, id="False"), pytest.param(64, True, id="True"),
    pytest.param(96, False, id="96-False"), pytest.param(96, True, id="96-True")])
def test_flash_attention_fn_trains_at_head_dim_64(head_dim, causal):
    """FlashAttentionFn on CPU tensors at head dims 64 and 96 (its plain
    forward and backward): the gradients of sum(out^2) within GRAD_ATOL of
    jax.grad through the JAX flash kernel, which pads 64 and 96 to 128
    lanes."""
    rng = np.random.default_rng(11)
    B, S, H, Hkv, Dh = 2, 128, 4, 2, head_dim
    q, k, v = (rng.normal(size=(B, S, h, Dh)).astype(np.float32) for h in (H, Hkv, Hkv))
    mask = np.ones((B, S), np.int32)
    mask[1, 100:] = 0

    def f_jax(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, jnp.asarray(mask), causal=causal) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttentionFn.apply(tq, tk, tv, torch.from_numpy(mask), causal, None, 0)
    (out ** 2).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("Dh,want", [(64, 64), (128, 128), (96, 128), (80, 128), (32, 128),
                                     (256, None), (100, None)])
def test_k1_head_dims(Dh, want):
    """K1, K4 and K5 run head dims 64 and 128 as compiled instances,
    zero-pad other multiples of 8 below 128 to 128, and raise for any other
    head dim."""
    if want is None:
        with pytest.raises(NotImplementedError):
            flash_attention.kernel_head_dim(Dh)
    else:
        assert flash_attention.kernel_head_dim(Dh) == want

