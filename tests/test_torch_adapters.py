"""Per-request LoRA adapters in the port's serving engine
(gritlm_tpu_torch.serving.ServingEngine(adapters=...)) against the JAX
package on tiny_mistral.

Both packages get the same base weights (`params_from_jax`) and the same
adapters (`lora_from_jax` of JAX adapters whose B factors are nonzero, so
every adapter changes the model) and run float32 on the CPU, the port's
kernels as their plain versions. `stack_adapters` / `set_adapter_ids` are
held leaf for leaf against the JAX functions (exact: stacking and one
scale multiply), the trunk's stacked-adapter matmul against the JAX `_mm`
within 1e-5 (fp32 products summed in another order), the port's pools
token for token against each request's adapter merged into the base
(`merge`) and run alone, and the plain pool against the JAX engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import _mm as jax_mm
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu.training import lora as jlora
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import generate, make_cache_for_prompt
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.models.convert import lora_from_jax
from gritlm_tpu_torch.models.transformer import _mm
from gritlm_tpu_torch.serving import EmbedRequest, Request, ServingEngine
from gritlm_tpu_torch.tokenizer import instruction_token_lens
from gritlm_tpu_torch.training import lora
from gritlm_tpu_torch.training.quant import dequantize_tree, quantize_for_serving

MAXNEW = 8
SCALE = 2.0  # alpha / r of the test adapters (r 4, alpha 8)
MM_ATOL = 1e-5
EMB_ATOL = 1e-5
POOL = dict(max_batch=2, max_len=64, chunk_size=2, prompt_buckets=(16,))
# (prompt length, adapter) of the mixed workload: the base and both adapters
# interleaved, more requests than slots
MIX = [(5, None), (9, "a"), (7, "b"), (11, "a"), (4, "b"), (12, None)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_adapter(params, key, r=4):
    """A JAX LoRA tree (init_lora's A, r 4, alpha 8) with nonzero B factors,
    as tests/test_serving.py draws them: init_lora's B = 0 is a no-op."""
    tree, _ = jlora.init_lora(params, key, r=r, alpha=8)

    def walk(node, k):
        if isinstance(node, dict) and "A" in node and "B" in node:
            k, sub = jax.random.split(k)
            return {"A": node["A"],
                    "B": jax.random.normal(sub, node["B"].shape, node["B"].dtype) * 0.5}, k
        if isinstance(node, dict):
            out = {}
            for kk, v in node.items():
                out[kk], k = walk(v, k)
            return out, k
        return node, k

    return walk(tree, key)[0]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """JAX and port base params, two adapters in both packages' trees, and
    each adapter merged into the port's base (the oracles' weights)."""
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    tparams = params_from_jax(_np(jparams), tiny_mistral(), device="cpu")
    jad = {"a": _rand_adapter(jparams, jax.random.PRNGKey(11)),
           "b": _rand_adapter(jparams, jax.random.PRNGKey(12))}
    tad = {n: lora_from_jax(_np(t), device="cpu") for n, t in jad.items()}
    merged = {None: tparams, **{n: lora.merge(tparams, t, SCALE) for n, t in tad.items()}}
    return jparams, tparams, jad, tad, merged


def _workload(seed=31):
    rng = np.random.default_rng(seed)
    return [(f"m{i}", rng.integers(3, 512, size=n).tolist(), a) for i, (n, a) in enumerate(MIX)]


def _requests(specs, cls=Request, **kw):
    return [cls(input_ids=list(ids), max_new_tokens=MAXNEW, request_id=rid, adapter=a, **kw)
            for rid, ids, a in specs]


def _tokens(done):
    return {c.request_id: list(c.token_ids) for c in done}


def _oracle(params, ids, quant=False):
    """The port's lockstep greedy generate of one request alone."""
    cfg = tiny_mistral()
    arr = torch.tensor([ids], dtype=torch.int32)
    cache = make_cache_for_prompt(cfg, 1, len(ids), MAXNEW, device="cpu", quant=quant)
    res = generate(params, cfg, arr, torch.ones_like(arr), cache, max_new_tokens=MAXNEW,
                   eos_id=2, pad_id=2)
    return res.tokens[0, :int(res.num_valid[0])].tolist()


def _engine(tparams, tad, **kw):
    return ServingEngine(tiny_mistral(), tparams, adapters=tad, lora_scale=SCALE,
                         device="cpu", **{**POOL, **kw})


# ---------------------------------------------------------------- the stacked tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("base", ["dense", "w8"])
def test_stack_adapters_and_ids_match_jax(models, base):
    """stack_adapters over the same base and adapters gives JAX's tree leaf
    for leaf (the zero slot 0, A stacked, B pre-scaled; a quantized base
    node kept whole as the leaf's "w"), and set_adapter_ids grafts the same
    [L, B] ids."""
    jparams, tparams, jad, tad, _ = models
    if base == "w8":
        from gritlm_tpu.training.quant import quantize_tree as jax_quantize_tree

        from gritlm_tpu_torch.training.quant import quantize_tree

        jparams, tparams = jax_quantize_tree(jparams), quantize_tree(tparams)
    aid = np.array([2, 0, 1], np.int32)
    L = jax_tiny_mistral().num_hidden_layers
    want = dict(_leaves(_np(jlora.set_adapter_ids(
        jlora.stack_adapters(jparams, [jad["a"], jad["b"]], SCALE), aid, L))))
    got = dict(_leaves(lora.set_adapter_ids(
        lora.stack_adapters(tparams, [tad["a"], tad["b"]], SCALE), torch.from_numpy(aid), L)))
    assert set(got) == set(want)
    stacked = [p for p in got if p[-1] == "As"]
    assert sorted(p[-2] for p in stacked) == sorted(lora.DEFAULT_TARGETS)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=str(path))
    for path in stacked:
        assert float(got[path].select(1, 0).abs().max()) == 0.0  # slot 0: the zero adapter
        assert (path[:-1] + ("w", "q8") in got) == (base == "w8")


@pytest.mark.parametrize("fault", ["targets", "rank"])
def test_stack_adapters_rejects_mismatch(models, fault):
    """Adapters on different target sets or ranks cannot share one stacked
    leaf: both packages raise ValueError."""
    jparams, tparams, jad, tad, _ = models
    if fault == "targets":
        jother = {"layers": {k: dict(v) for k, v in jad["b"]["layers"].items()}}
        del jother["layers"]["attn"]["wq"]
        match = "disagree on target wq"
    else:
        jother = _rand_adapter(jparams, jax.random.PRNGKey(5), r=2)
        match = "shapes differ"
    tother = lora_from_jax(_np(jother), device="cpu")
    with pytest.raises(ValueError, match=match):
        jlora.stack_adapters(jparams, [jad["a"], jother], SCALE)
    with pytest.raises(ValueError, match=match):
        lora.stack_adapters(tparams, [tad["a"], tother], SCALE)


@pytest.mark.parametrize("leaf", [("attn", "wq"), ("mlp", "down")])
def test_mm_stacked_branch_matches_jax(models, leaf):
    """_mm on one layer of a stacked leaf: the base product plus each row's
    own adapter's (x A) B, against the JAX _mm on the same leaf and ids."""
    jparams, tparams, jad, tad, _ = models
    jst = jlora.stack_adapters(jparams, [jad["a"], jad["b"]], SCALE)
    tst = lora.stack_adapters(tparams, [tad["a"], tad["b"]], SCALE)
    jnode = jst["layers"][leaf[0]][leaf[1]]
    tnode = tst["layers"][leaf[0]][leaf[1]]
    aid = np.array([1, 0, 2, 1], np.int32)
    x = np.random.default_rng(3).normal(size=(4, 5, tnode["As"].shape[2])).astype(np.float32)
    layer = 1
    want = jax_mm(jnp.asarray(x), {"w": jnode["w"][layer], "As": jnode["As"][layer],
                                   "Bs": jnode["Bs"][layer], "aid": jnp.asarray(aid)})
    got = _mm(torch.from_numpy(x), {"w": tnode["w"][layer], "As": tnode["As"][layer],
                                    "Bs": tnode["Bs"][layer], "aid": torch.from_numpy(aid)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MM_ATOL, rtol=MM_ATOL)
    # slot 0 rows are the plain base product
    base = torch.from_numpy(x[1:2]) @ tnode["w"][layer]
    np.testing.assert_array_equal(got[1:2].numpy(), base.numpy())


def test_mm_stacked_branch_raises(models):
    """No grafted ids: ValueError; activations that are not [B, S, D]:
    NotImplementedError (both as in the JAX package)."""
    _, tparams, _, tad, _ = models
    node = lora.stack_adapters(tparams, [tad["a"]], SCALE)["layers"]["attn"]["wq"]
    node = {k: v[0] for k, v in node.items()}
    x = torch.zeros((2, 3, node["As"].shape[1]))
    with pytest.raises(ValueError, match="without adapter ids"):
        _mm(x, node)
    with pytest.raises(NotImplementedError, match=r"\[B, S, D\]"):
        _mm(x[0], {**node, "aid": torch.zeros(2, dtype=torch.long)})


# ---------------------------------------------------------------- the pools


POOLS = {
    "plain": dict(),
    "chunked": dict(prefill_chunk=4),
    "speculative": dict(speculative=True, spec_ngram=2, spec_k=3),
    "paged": dict(paged=True, page_size=8, pool_pages=25),
    "int8_kv": dict(kv_quant=True),
    "sampling": dict(sampling=True),
}


@pytest.mark.parametrize("pool", list(POOLS))
def test_adapter_pool_matches_merged_oracles(models, pool):
    """One pool serves the base and both adapters at once (more requests
    than slots, so rows change adapter as they are reused); each request is
    token-exact against its adapter merged into the base and run alone
    (over an int8 cache for the int8-KV pool). In the sampling pool half the
    requests sample (T 1.0, top_p 0.9): each stream against its request
    alone in a sampling pool over the merged weights."""
    _, tparams, _, tad, merged = models
    specs = _workload()
    kw = POOLS[pool]
    reqs = _requests(specs)
    if pool == "sampling":
        for i, r in enumerate(reqs):
            if i % 2:
                r.temperature, r.top_p, r.seed = 1.0, 0.9, 100 + i
    got = _tokens(_engine(tparams, tad, **kw).run(reqs))
    assert sorted(got) == sorted(rid for rid, _, _ in specs)
    for r in reqs:
        if r.temperature > 0:
            solo = ServingEngine(tiny_mistral(), merged[r.adapter], device="cpu", sampling=True,
                                 **{**POOL, "max_batch": 1})
            want = _tokens(solo.run([Request(input_ids=r.input_ids, max_new_tokens=MAXNEW,
                                             request_id="x", temperature=1.0, top_p=0.9,
                                             seed=r.seed)]))["x"]
        else:
            want = _oracle(merged[r.adapter], r.input_ids, quant=pool == "int8_kv")
        assert got[r.request_id] == want, (r.request_id, r.adapter)
    # guard: each adapter moved some request off the base model's tokens
    for name in ("a", "b"):
        assert any(got[rid] != _oracle(tparams, ids) for rid, ids, a in specs if a == name)


def test_adapter_pool_matches_jax_engine(models):
    """The port's plain adapter pool against the JAX engine with the same
    base, adapters and requests: the same tokens."""
    jparams, tparams, jad, tad, _ = models
    specs = _workload(seed=32)
    jeng = JaxServingEngine(jax_tiny_mistral(), jparams, adapters=jad, lora_scale=SCALE, **POOL)
    want = _tokens(jeng.run(_requests(specs, JaxRequest)))
    assert _tokens(_engine(tparams, tad).run(_requests(specs))) == want


def test_adapter_embeddings_match_merged_encode(models):
    """Pool embeddings, each request on its own adapter (the base too), in
    one dispatch, against GritLM.encode on that adapter's merged weights."""
    _, tparams, _, tad, merged = models
    texts = ["a first text to embed", "the second one", "and a third, longer, text here",
             "four"]
    names = [None, "a", "b", "a"]
    instr = "<|user|>\nRepresent this\n<|embed|>\n"
    want = {n: GritLM(tiny_mistral(), params=merged[n], device="cpu") for n in set(names)}
    tok = want[None].tokenizer
    enc = tok([instr + t + want[None].embed_eos for t in texts])
    ilens = instruction_token_lens(tok, instr, enc["input_ids"], enc["attention_mask"])
    eng = _engine(tparams, tad, max_batch=4, max_len=128, prompt_buckets=(128,))
    for i, n in enumerate(names):
        ids = enc["input_ids"][i, :int(enc["attention_mask"][i].sum())].tolist()
        eng.submit_embed(EmbedRequest(input_ids=ids, instr_len=int(ilens[i]),
                                      request_id=f"e{i}", adapter=n))
    eng.run()
    got = {e.request_id: e.embedding for e in eng.take_embeddings()}
    for i, (t, n) in enumerate(zip(texts, names)):
        np.testing.assert_allclose(got[f"e{i}"], want[n].encode([t], instruction=instr)[0],
                                   atol=EMB_ATOL)
    assert np.abs(got["e1"] - want[None].encode([texts[1]], instruction=instr)[0]).max() > 1e-3


@pytest.mark.parametrize("bits", [8, 4])
def test_adapters_over_quantized_base(models, bits):
    """Adapters over a w8 / w4 serving base (the base product through K6 /
    K7's plain versions, the delta beside it) against `merge`, which
    dequantizes the base first (here in float32, the activations' dtype)."""
    _, tparams, _, tad, _ = models
    qparams = quantize_for_serving(tparams, bits=bits)
    dense = dequantize_tree(qparams, torch.float32)
    specs = _workload(seed=33)
    got = _tokens(_engine(qparams, tad).run(_requests(specs)))
    for rid, ids, a in specs:
        want = dense if a is None else lora.merge(dense, tad[a], SCALE)
        assert got[rid] == _oracle(want, ids), (rid, a)


def test_unknown_adapter_rejected(models):
    """A name the pool does not serve raises ValueError in submit and
    submit_embed; a pool without adapters rejects any name."""
    _, tparams, _, tad, _ = models
    eng = _engine(tparams, tad)
    for submit, cls in ((eng.submit, Request), (eng.submit_embed, EmbedRequest)):
        with pytest.raises(ValueError, match="unknown adapter"):
            submit(cls(input_ids=[3, 4], adapter="nope"))
    plain = ServingEngine(tiny_mistral(), tparams, device="cpu", **POOL)
    with pytest.raises(ValueError, match="unknown adapter"):
        plain.submit(Request(input_ids=[3, 4], adapter="a"))
    with pytest.raises(ValueError, match="unknown adapter"):
        plain.submit_embed(EmbedRequest(input_ids=[3, 4], adapter="a"))
