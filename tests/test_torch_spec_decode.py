"""The port's prompt-lookup speculative decoding (gritlm_tpu_torch.spec_decode),
the per-row multi-token forward it verifies with, and K3's plain version
with per-row offsets, against the JAX package on tiny_mistral.

Both packages get the same weights (`params_from_jax`) and inputs made from
a seed with numpy, and run float32 on the CPU (the port's kernels as their
plain versions). Speculation never changes the text, so tokens are held
exactly: against the port's own greedy `generate` and against the JAX
`generate_speculative` (same tokens, same verify steps, same cache mask).
Tolerances of the float comparisons are stated where they are made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.generate import make_cache_for_prompt as jax_make_cache
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import KVCache as JaxKVCache
from gritlm_tpu.models.transformer import PagedKVCache as JaxPagedKVCache
from gritlm_tpu.models.transformer import forward as jax_forward
from gritlm_tpu.ops.attention import make_attention_bias as jax_bias
from gritlm_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.spec_decode import _lookup_proposals as jax_lookup
from gritlm_tpu.spec_decode import generate_speculative as jax_generate_speculative
from gritlm_tpu.spec_decode import spec_cache_extra as jax_spec_cache_extra
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import generate, make_cache_for_prompt
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    forward,
)
from gritlm_tpu_torch.ops import decode_attention
from gritlm_tpu_torch.ops.attention import cached_attention, make_attention_bias
from gritlm_tpu_torch.rag import CacheMode, RAGEngine
from gritlm_tpu_torch.spec_decode import (
    _lookup_proposals,
    generate_speculative,
    spec_cache_extra,
)

EOS = 2
ATOL = 5e-5  # float32 on both sides, sums in another order
LOW_ATOL = 2e-2  # bf16 and int8 caches, as tests/test_torch_paged.py holds the S = 1 step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(7), with_lm_head=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return jparams, tparams


# ------------------------------------------------------------ lookup


LOOKUP_CASES = {  # (history rows, lengths, ngram, k, pad): the JAX tests' cases and a sweep
    "basic": ([[4, 5, 6, 7, 9, 5, 6, 7, 0, 0]], [8], 3, 3, 0),
    "no_match": ([[1, 2, 3, 4, 5, 6, 0, 0]], [6], 3, 4, 99),
    "trailing_only": ([[9, 9, 1, 2, 3, 0]], [5], 3, 2, 0),
    "random_small_vocab": (np.random.default_rng(0).integers(0, 5, (6, 40)).tolist(),
                           [40, 31, 12, 3, 1, 0], 2, 6, 77),
    "random_ngram4": (np.random.default_rng(1).integers(0, 3, (4, 64)).tolist(),
                      [64, 50, 9, 4], 4, 7, 5),
}


@pytest.mark.parametrize("name", list(LOOKUP_CASES))
def test_lookup_proposals_match_jax(name):
    hist, lens, ngram, k, pad = LOOKUP_CASES[name]
    hist, lens = np.asarray(hist, np.int32), np.asarray(lens, np.int32)
    want = jax_lookup(jnp.asarray(hist), jnp.asarray(lens), ngram, k, pad)
    got = _lookup_proposals(torch.from_numpy(hist).long(), torch.from_numpy(lens), ngram, k,
                            pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lookup_proposals_basic_values():
    got = _lookup_proposals(torch.tensor([[4, 5, 6, 7, 9, 5, 6, 7, 0, 0]]), torch.tensor([8]),
                            3, 3, 0)
    assert got.tolist() == [[9, 5, 6]]  # the tokens after the match at 1..3


# ------------------------------------------------------------ generate


def _prompt(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "single_row":
        ids = rng.integers(4, 512, (1, 24)).astype(np.int32)
        return ids, np.ones_like(ids), 12, 3, 7
    if name == "repetitive":
        ids = np.tile(np.arange(7, 13, dtype=np.int32), 5)[None]
        return ids, np.ones_like(ids), 16, 2, 4
    if name == "ragged":
        B, S = 3, 20
        ids = rng.integers(4, 512, (B, S)).astype(np.int32)
        mask = (np.arange(S)[None] < np.asarray([20, 11, 5])[:, None]).astype(np.int32)
        ids = np.where(mask > 0, ids, 0)
        ids[1, :11] = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]  # acceptance diverges across rows
        return ids, mask, 10, 2, 3
    k, ngram = {"sweep_k1_ngram2": (1, 2), "sweep_k7_ngram4": (7, 4)}[name]
    ids = rng.integers(4, 512, (2, 16)).astype(np.int32)
    return ids, np.ones_like(ids), 8, ngram, k


@pytest.mark.parametrize("name", ["single_row", "repetitive", "ragged", "sweep_k1_ngram2",
                                  "sweep_k7_ngram4"])
def test_generate_speculative_matches_greedy_and_jax(tiny, name):
    """Token-exact against the port's greedy generate and against the JAX
    generate_speculative: tokens, counts, verify steps, the cache's mask and
    write pointer."""
    jparams, tparams = tiny
    cfg = tiny_mistral()
    ids, mask, max_new, ngram, k = _prompt(name)
    B, S = ids.shape
    extra = spec_cache_extra(max_new, k, B)
    assert extra == jax_spec_cache_extra(max_new, k, B)
    cache = make_cache_for_prompt(cfg, B, S, max_new, extra=extra, device="cpu")
    got = generate_speculative(tparams, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                               cache, max_new_tokens=max_new, ngram=ngram, k=k, eos_id=EOS,
                               pad_id=EOS)
    ref = generate(tparams, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                   make_cache_for_prompt(cfg, B, S, max_new, device="cpu"),
                   max_new_tokens=max_new, eos_id=EOS, pad_id=EOS)
    assert got.num_valid.tolist() == ref.num_valid.tolist()
    for r in range(B):
        n = int(ref.num_valid[r])
        assert got.tokens[r, :n].tolist() == ref.tokens[r, :n].tolist()
    want = jax_generate_speculative(
        jparams, jax_tiny_mistral(), jnp.asarray(ids), jnp.asarray(mask),
        jax_make_cache(jax_tiny_mistral(), B, S, max_new, extra=extra),
        max_new_tokens=max_new, ngram=ngram, k=k, eos_id=EOS, pad_id=EOS)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.spec_steps == int(want.spec_steps)
    assert got.cache.length == int(want.cache.length)
    np.testing.assert_array_equal(got.cache.mask.numpy(), np.asarray(want.cache.mask))


def test_spec_from_prefilled_cache(tiny):
    """RAG continuation: a document's KV prefilled, then the prompt and the
    speculative decode, against the greedy decode over the same cache."""
    _, tparams = tiny
    cfg = tiny_mistral()
    rng = np.random.default_rng(3)
    doc = torch.from_numpy(rng.integers(4, 512, (1, 16)).astype(np.int32))
    q = torch.from_numpy(rng.integers(4, 512, (1, 8)).astype(np.int32))
    max_new, k = 8, 3

    def prefilled(extra):
        cache = make_cache_for_prompt(cfg, 1, 24, max_new, extra=extra, device="cpu")
        _, cache, _ = forward(tparams, cfg, doc, attention_mask=torch.ones_like(doc),
                              causal=True, cache=cache)
        return cache

    ref = generate(tparams, cfg, q, torch.ones_like(q), prefilled(0), max_new_tokens=max_new,
                   eos_id=EOS, pad_id=EOS)
    got = generate_speculative(tparams, cfg, q, torch.ones_like(q),
                               prefilled(spec_cache_extra(max_new, k, 1)),
                               max_new_tokens=max_new, k=k, eos_id=EOS, pad_id=EOS)
    n = int(ref.num_valid[0])
    assert int(got.num_valid[0]) == n
    assert got.tokens[0, :n].tolist() == ref.tokens[0, :n].tolist()


def test_spec_cache_mask_stays_consistent(tiny):
    """After speculative decoding a row's valid slots are the prompt plus
    the emitted tokens but the last (whose KV is written by the step that
    would follow it); holes are masked off, never counted."""
    _, tparams = tiny
    cfg = tiny_mistral()
    ids = torch.from_numpy(np.tile(np.arange(7, 13, dtype=np.int32), 4)[None])
    cache = make_cache_for_prompt(cfg, 1, ids.shape[1], 12, extra=spec_cache_extra(12, 4, 1),
                                  device="cpu")
    out = generate_speculative(tparams, cfg, ids, torch.ones_like(ids), cache,
                               max_new_tokens=12, ngram=2, k=4, eos_id=EOS, pad_id=EOS)
    assert int(out.cache.mask.sum()) == ids.shape[1] + int(out.num_valid[0]) - 1


def test_gritlm_generate_speculative_matches_jax(tiny):
    """GritLM.generate(speculative=True) against plain greedy generate and
    the JAX GritLM's speculative generate (the same text), fresh and from a
    captured cache; sampling or min_new_tokens raise ValueError."""
    jparams, tparams = tiny
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams)
    tm = GritLM(tiny_mistral(), params=tparams, device="cpu")
    prompts = ["<s><|user|>\nrepeat: one two three one two three one two\n<|assistant|>\n",
               "<s><|user|>\nHi\n<|assistant|>\n"]
    kw = dict(max_new_tokens=10, spec_k=3, spec_ngram=2)
    got = tm.generate(prompts, speculative=True, **kw)
    assert got == tm.generate(prompts, max_new_tokens=10)
    assert got == jm.generate(prompts, speculative=True, **kw)
    _, cache = tm.encode(["a cached passage about place 3"], get_cache=True)
    _, jcache = jm.encode(["a cached passage about place 3"], get_cache=True)
    got = tm.generate(prompts[1], cache=cache, speculative=True, **kw)
    assert got == tm.generate(prompts[1], cache=cache, max_new_tokens=10)
    assert got == jm.generate(prompts[1], cache=jcache, speculative=True, **kw)
    for bad in (dict(temperature=0.7), dict(min_new_tokens=2)):
        with pytest.raises(ValueError, match="greedy-only"):
            tm.generate(prompts[0], speculative=True, **bad)


# ------------------------------------------------------------ forward(row_offsets, S > 1)


LENS = [3, 7, 5]  # ragged rows, each with its own write slot
SMAX, CHUNK = 32, 4


def _random_pool(rng, cache_dtype, L, lead, width, kv, dh):
    """K/V [L, lead, width, kv*dh] and slot-minor scales for int8."""
    shape = (L, lead, width, kv * dh)
    if cache_dtype == "int8":
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        sc = (L, lead, kv, width)
        ks = np.asarray(jnp.asarray(rng.random(sc) * 0.05, jnp.bfloat16), np.float32)
        vs = np.asarray(jnp.asarray(rng.random(sc) * 0.05, jnp.bfloat16), np.float32)
        return k, v, ks, vs
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if cache_dtype == "bf16":  # values a bf16 cache can hold
        k = np.asarray(jnp.asarray(k, jnp.bfloat16), np.float32)
        v = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
    return k, v, None, None


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("cache_dtype", ["f32", "bf16", "int8"])
def test_multi_token_per_row_forward_matches_jax(tiny, paged, cache_dtype):
    """The speculative verify chunk, forward(row_offsets=..., S=4): rows
    append 4 tokens at their own slots (one row inactive, one whose RoPE
    positions differ from its slots, a chunk straddling a page), causal
    inside the chunk, over a dense or a paged pool of float32, bf16 or int8
    K/V. Hidden states and every written cache entry match the JAX
    package's forward (the paged scratch page 0 excepted). Tolerances: ATOL
    for float32, LOW_ATOL for bf16 and int8, as the S = 1 step's test."""
    jparams, tparams = tiny
    cfg = tiny_mistral()
    L, kv, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    B, page = 4, 8
    rng = np.random.default_rng(17)
    offs = np.asarray([5, 14, 9, 27], np.int32)  # row 1's chunk straddles pages 1 and 2
    pos = offs + np.asarray([0, -4, 0, 0], np.int32)  # row 1 continues a doc bucket
    active = np.asarray([1, 1, 0, 1], np.int32)  # row 2 is inactive
    mask = np.zeros((B, SMAX), np.int32)
    for b, o in enumerate(offs):
        mask[b, :o] = 1
    mask[1, 3:6] = 0  # holes
    tok = rng.integers(3, cfg.vocab_size, size=(B, CHUNK)).astype(np.int32)
    step = np.repeat(active[:, None], CHUNK, 1)
    positions = pos[:, None] + np.arange(CHUNK)[None]
    if paged:
        maxp = SMAX // page
        n_pages = B * maxp + 1
        pt = (1 + rng.permutation(n_pages - 1)[: B * maxp]).reshape(B, maxp).astype(np.int32)
        k, v, ks, vs = _random_pool(rng, cache_dtype, L, n_pages, page, kv, dh)
    else:
        k, v, ks, vs = _random_pool(rng, cache_dtype, L, B, SMAX, kv, dh)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[cache_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[cache_dtype]

    def jcache():
        common = dict(k=jnp.asarray(k, jdt), v=jnp.asarray(v, jdt), mask=jnp.asarray(mask),
                      length=jnp.zeros((), jnp.int32),
                      k_scale=None if ks is None else jnp.asarray(ks, jnp.bfloat16),
                      v_scale=None if vs is None else jnp.asarray(vs, jnp.bfloat16))
        if paged:
            return JaxPagedKVCache(page_table=jnp.asarray(pt), **common)
        return JaxKVCache(**common)

    def tcache():
        common = dict(k=torch.from_numpy(k.copy()).to(tdt), v=torch.from_numpy(v.copy()).to(tdt),
                      mask=torch.from_numpy(mask.copy()),
                      k_scale=None if ks is None else torch.from_numpy(ks).to(torch.bfloat16),
                      v_scale=None if vs is None else torch.from_numpy(vs).to(torch.bfloat16))
        if paged:
            return PagedKVCache(page_table=torch.from_numpy(pt), **common)
        return KVCache(length=0, **common)

    want_h, want_c, _ = jax_forward(jparams, jax_tiny_mistral(), jnp.asarray(tok),
                                    attention_mask=jnp.asarray(step),
                                    positions=jnp.asarray(positions), cache=jcache(),
                                    row_offsets=jnp.asarray(offs))
    cache = tcache()
    got_h, got_c, _ = forward(tparams, cfg, torch.from_numpy(tok),
                              attention_mask=torch.from_numpy(step),
                              positions=torch.from_numpy(positions), cache=cache,
                              row_offsets=torch.from_numpy(offs))
    assert got_c is cache and int(cache.mask[2, 9:13].sum()) == 0  # inactive: no bit set
    assert cache.mask[1, 14:18].tolist() == [1, 1, 1, 1]
    atol = ATOL if cache_dtype == "f32" else LOW_ATOL
    active_rows = np.flatnonzero(active)
    np.testing.assert_allclose(got_h.numpy()[active_rows], np.asarray(want_h)[active_rows],
                               atol=atol, rtol=atol)
    names = ("mask", "k", "v") + (("k_scale", "v_scale") if cache_dtype == "int8" else ())
    for name in names:
        got = getattr(got_c, name).float().numpy()
        want = np.asarray(jnp.asarray(getattr(want_c, name), jnp.float32))
        if paged and name != "mask":
            got, want = got[:, 1:], want[:, 1:]  # page 0 is scratch
        np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=name)


# ------------------------------------------------------------ K3 with per-row offsets


K3_ROW_CASES = {  # (B, Sq, H, Hkv, Smax, window, offsets)
    "verify_sq8": (3, 8, 4, 2, 256, None, [17, 120, 200]),
    "verify_sq8_window": (3, 8, 4, 2, 256, 64, [17, 120, 200]),
    "sq1": (2, 1, 4, 4, 256, None, [0, 255]),
    "sq3_window_gqa4": (2, 3, 8, 2, 384, 32, [100, 7]),
}


@pytest.mark.parametrize("name", list(K3_ROW_CASES))
def test_flash_decode_per_row_offsets_matches_jax(name):
    """K3's plain version with a [B] tensor of offsets (each row's causal
    bound and window from its own offset, holes in the mask) against the
    JAX flash_decode with [B] offsets, its Pallas kernel run in interpret
    mode as the JAX package's own tests run it on the CPU (ATOL), and the
    same call through cached_attention and through the bias oracle
    (make_attention_bias with per-row offsets, both packages)."""
    B, Sq, H, Hkv, Smax, window, offs = K3_ROW_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = (rng.normal(size=(B, Sq, H, 128)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(1, B, Smax, Hkv * 128)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(1, B, Smax, Hkv * 128)) * 0.5).astype(np.float32)
    mask = (rng.uniform(size=(B, Smax)) > 0.2).astype(np.int32)
    offs = np.asarray(offs, np.int32)
    kw = dict(causal=True, sliding_window=window, layer=0)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                            offset=jnp.asarray(offs), **kw)
    qt, kt, vt, mt, ot = (torch.from_numpy(x) for x in (q, k, v, mask, offs))
    got = decode_attention.flash_decode(qt, kt, vt, mt, offset=ot, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    via = cached_attention(qt, kt, vt, mt, layer=0, offset=ot, causal=True,
                           sliding_window=window)
    assert torch.equal(via, got)
    for b in range(B):  # each row alone at an int offset: the same output
        alone = decode_attention.flash_decode(qt[b:b + 1], kt[:, b:b + 1], vt[:, b:b + 1],
                                              mt[b:b + 1], offset=int(offs[b]), **kw)
        np.testing.assert_allclose(alone.numpy(), got[b:b + 1].numpy(), atol=ATOL)
    bias = make_attention_bias(mt, Sq, Smax, causal=True, sliding_window=window, offset=ot)
    jbias = jax_bias(jnp.asarray(mask), Sq, Smax, causal=True, sliding_window=window,
                     offset=jnp.asarray(offs))
    assert tuple(bias.shape) == (B, 1, Sq, Smax)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))


# ------------------------------------------------------------ RAGEngine(speculative=True)


@pytest.fixture(scope="module")
def rag_models():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    tm = GritLM(tiny_mistral(), params=tparams, device="cpu")
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams)
    passages = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(6)]
    plain = RAGEngine(tm, max_new_tokens=8, encode_max_length=64)
    plain.build_index(passages, batch_size=4, cache_docs=True)
    jplain = JaxRAGEngine(jm, max_new_tokens=8, encode_max_length=64)
    jplain.build_index(passages, batch_size=4, cache_docs=True)
    return plain, jplain


@pytest.mark.parametrize("mode", [CacheMode.PROMPT_QUERY_DOC, CacheMode.DOCQUERY,
                                  CacheMode.DOC])
def test_rag_speculative_answers_match_plain_and_jax(rag_models, mode):
    """RAGEngine(speculative=True) answers equal the plain greedy answers in
    a prompt mode, a concatenated-cache mode and a doc-cache mode, and the
    JAX speculative engine's."""
    plain, jplain = rag_models
    kw = dict(max_new_tokens=8, encode_max_length=64, speculative=True, spec_k=3,
              spec_ngram=2)
    spec = RAGEngine(plain.model, index=plain.index, **kw)
    spec._doc_store = plain._doc_store
    jspec = JaxRAGEngine(jplain.model, index=jplain.index, **kw)
    jspec._doc_store = jplain._doc_store
    qs = ["what is fact number 3?", "tell me about place 5"]
    got = [r.answer for r in spec.answer_batch(qs, mode=mode)]
    assert got == [r.answer for r in plain.answer_batch(qs, mode=mode)]
    assert got == [r.answer for r in jspec.answer_batch(qs, mode=mode)]
    with pytest.raises(ValueError, match="greedy-only"):
        RAGEngine(plain.model, min_new_tokens=2, speculative=True)
