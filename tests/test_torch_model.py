"""The port's model slice against the JAX package on tiny_mistral (forward
and encode also on tiny_llama3, and on tiny_qwen2 with random QKV biases
and a sliding window of 8).

The JAX params from `gritlm_tpu.models.init_params` cross to the port as
numpy (`params_from_jax`); token ids and masks are made with numpy. Both
sides run float32 on the CPU (the port's kernels as their plain versions).

Tolerances: hidden states and embeddings are float32 on both sides and
differ by summation order, so 1e-4 (hidden, values of order 1) and 1e-5
(unit-norm embeddings) hold; greedy tokens must be identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu import config as jax_config
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.generate import nucleus_filter as jax_nucleus_filter
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import forward as jax_forward
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import apply_rope as jax_apply_rope
from gritlm_tpu.models.transformer import rms_norm as jax_rms_norm
from gritlm_tpu.ops.pooling import pool as jax_pool
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch import config as port_config
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import _sample, nucleus_filter
from gritlm_tpu_torch.models import forward, params_from_jax
from gritlm_tpu_torch.models.transformer import apply_rope, rms_norm
from gritlm_tpu_torch.ops.pooling import POOLING_METHODS, pool

PROMPTS = ["<s><|user|>\nWhat is a cache?\n<|assistant|>\n", "abc"]
DOCS = ["Bitcoin is a digital currency.", "A KV cache stores keys and values."]
INSTRUCTION = "<|user|>\nRetrieve the passage\n<|embed|>\n"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FAMILIES = ["tiny_mistral", "tiny_llama3", "tiny_qwen2"]


@functools.lru_cache(maxsize=None)
def _family_pair(family: str):
    """(JAX GritLM, port GritLM) on the same weights of a tiny dense preset.
    Qwen2 gets nonzero random QKV biases (its init draws zeros) and a
    sliding window of 8, so both reach the forward."""
    jcfg, tcfg = getattr(jax_config, family)(), getattr(port_config, family)()
    if family == "tiny_qwen2":
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.attention_bias:
        rng = np.random.default_rng(1)
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(size=attn[name].shape).astype(np.float32) * 0.5)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    return (JaxGritLM(jcfg, params=jparams), GritLM(tcfg, params=tparams, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    """(JAX GritLM, port GritLM) on the same tiny_mistral weights."""
    return _family_pair("tiny_mistral")


def _ids(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 8:] = 0  # right padding
    return ids, mask


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_hidden_matches_jax(family, causal):
    jm, tm = _family_pair(family)
    ids, mask = _ids()
    want, _, _ = jax_forward(jm.params, jm.config, ids, attention_mask=mask, causal=causal)
    got, _, _ = forward(tm.params, tm.config, torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("instruction", ["", INSTRUCTION])
def test_encode_matches_jax(family, instruction):
    jm, tm = _family_pair(family)
    want = jm.encode(DOCS, instruction=instruction)
    got = tm.encode(DOCS, instruction=instruction)
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_greedy_generate_matches_jax(pair):
    """Ragged batch (one long prompt, one short), 8 tokens, token-exact."""
    jm, tm = pair
    enc = tm.tokenizer(PROMPTS)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))


def test_generate_from_encode_cache_matches_jax(pair):
    """encode(get_cache=True) builds the doc cache bidirectionally; generate
    continues it causally. The caller's cache is left as it was."""
    jm, tm = pair
    enc = tm.tokenizer(["<|user|>\nSummarise\n<|assistant|>\n"] * 2,
                       add_special_tokens=False)
    jemb, jcache = jm.encode(DOCS, get_cache=True)
    temb, tcache = tm.encode(DOCS, get_cache=True)
    np.testing.assert_allclose(temb, jemb, atol=1e-5)
    before = tcache.k.clone()
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=jcache,
                                max_new_tokens=8)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=tcache,
                               max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert torch.equal(tcache.k, before)


def test_int8_cache_generate_matches_jax(pair):
    """kv_quant=True: the int8 cache written by prefill and decode, and an
    int8 cache from encode(get_cache=True), give the JAX package's tokens."""
    jm, tm = pair
    jq = JaxGritLM(jax_tiny_mistral(), params=jm.params, kv_quant=True)
    tq = GritLM(tiny_mistral(), params=tm.params, device="cpu", kv_quant=True)
    enc = tm.tokenizer(PROMPTS)
    want = jq.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    got = tq.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.cache.quantized and got.cache.k.dtype == torch.int8
    _, jcache = jq.encode(DOCS, get_cache=True)
    _, tcache = tq.encode(DOCS, get_cache=True)
    want = jq.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=jcache,
                                max_new_tokens=8)
    got = tq.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=tcache,
                               max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_nucleus_filter_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 512)).astype(np.float32) * 3
    for top_p in (0.1, 0.5, 0.9):
        want = np.asarray(jax_nucleus_filter(logits, top_p))
        got = nucleus_filter(torch.from_numpy(logits), top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_top_k_1_sampling_is_greedy(pair):
    _, tm = pair
    enc = tm.tokenizer(PROMPTS)
    greedy = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
    sampled = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6,
                                   temperature=0.7, top_k=1, seed=5)
    assert torch.equal(greedy.tokens, sampled.tokens)


def test_sampling_follows_the_distribution():
    """JAX's threefry draws cannot be reproduced, so sampling is held to
    the distribution: 20000 draws from fixed logits match softmax within
    0.015 per token (about 4 standard errors at p = 0.25)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = _sample(logits, gen, temperature=1.0, top_k=0)
    freq = torch.bincount(draws, minlength=6).float() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)
    top2 = _sample(logits, gen, temperature=1.0, top_k=2)
    assert set(top2.unique().tolist()) == {0, 1}


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0, 1.0, 4.0, 8192),
                                     ("llama3", 8.0, 1.0, 4.0, 256)])
def test_rope_and_rms_norm_match_jax(scaling):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 9)).astype(np.int32)
    want = jax_apply_rope(x, pos, 10000.0, scaling)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    scale = (1 + rng.normal(size=(16,))).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jax_rms_norm(x, scale, 1e-5)), atol=1e-5)


@pytest.mark.parametrize("method", POOLING_METHODS)
def test_pool_matches_jax(method):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(3, 10, 8)).astype(np.float32)
    mask = np.ones((3, 10), np.int32)
    mask[0, :3] = 0
    mask[1, 6:] = 0
    want = jax_pool(hidden, mask, method)
    got = pool(torch.from_numpy(hidden), torch.from_numpy(mask), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
