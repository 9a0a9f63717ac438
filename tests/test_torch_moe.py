"""The port's Mixtral MoE serving path against the JAX package on
tiny_mixtral (float32, 4 experts, top-2).

The JAX params from `gritlm_tpu.models.init_params` cross to the port as
numpy (`params_from_jax`); activations, token ids and masks are made with
numpy from a seed. Both sides run float32 on the CPU (the port's kernels as
their plain versions, the dropless grouped products as torch._grouped_mm).

Tolerances:
  - router logits, probabilities and weights: 1e-6 (float32 sums of 64
    products in another order; values of order 0.1-1); expert indices equal;
  - one MoE layer's output: 1e-6 absolute on outputs of order 1e-3 (the
    same float32 products summed in another order);
  - hidden states 1e-4 and embeddings 1e-5, as tests/test_torch_model.py
    holds the Mistral cases; 2e-2 over bf16 and int8 KV caches, as
    tests/test_torch_paged.py and test_torch_spec_decode.py hold them;
  - greedy tokens, retrieved passages, quantized bytes and checkpoint
    leaves equal.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mixtral as jax_tiny_mixtral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import forward as jax_forward
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import transformer as jt
from gritlm_tpu.models.loader import load_checkpoint as jax_load_checkpoint
from gritlm_tpu.models.loader import save_checkpoint as jax_save_checkpoint
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.serving import EmbedRequest as JaxEmbedRequest
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu.training import quant as jq
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mixtral
from gritlm_tpu_torch.models import forward, params_from_jax
from gritlm_tpu_torch.models import transformer as pt
from gritlm_tpu_torch.models.convert import expected_shapes, params_to_numpy
from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
from gritlm_tpu_torch.rag import RAGEngine
from gritlm_tpu_torch.serving import EmbedRequest, Request, ServingEngine
from gritlm_tpu_torch.training import quant as pq

from tok_fixtures import make_bpe_tokenizer

ROUTER_ATOL = 1e-6
LAYER_ATOL = 1e-6
ATOL = 1e-4  # hidden states
EMB_ATOL = 1e-5
LOW_ATOL = 2e-2  # bf16 and int8 KV caches
DOCS = ["Bitcoin is a digital currency.", "A KV cache stores keys and values."]
PROMPTS = ["<s><|user|>\nWhat is a cache?\n<|assistant|>\n", "abc"]
INSTRUCTION = "<|user|>\nRetrieve the passage\n<|embed|>\n"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _params():
    """(JAX params, numpy params, port params) on the same weights."""
    jparams = jax_init_params(jax_tiny_mixtral(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, np_params, params_from_jax(np_params, tiny_mixtral(), device="cpu")


def _cfgs(**kw):
    return (dataclasses.replace(jax_tiny_mixtral(), **kw),
            dataclasses.replace(tiny_mixtral(), **kw))


def _layer0():
    """Layer 0's MoE leaves: (JAX, port)."""
    jparams, _, tparams = _params()
    return ({k: v[0] for k, v in jparams["layers"]["moe"].items()},
            {k: v[0] for k, v in tparams["layers"]["moe"].items()})


def _x(seed, B=2, S=13, D=64):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


def _ids(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 8:] = 0  # right padding
    return ids, mask


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ------------------------------------------------------------ one MoE layer


def test_router_matches_jax():
    jp, tp = _layer0()
    x = _x(1).reshape(-1, 64)
    want = jt._router(jp, jnp.asarray(x), jax_tiny_mixtral())
    got = pt._router(tp, torch.from_numpy(x), tiny_mixtral())
    for name, g, w in zip(("logits", "probs", "weights"), got[:3], want[:3]):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROUTER_ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-6)


IMPLS = {
    "dense": ("_moe_mlp_dense", {}),
    "dropless": ("_moe_mlp_dropless", {}),
    "gshard exact": ("_moe_mlp_gshard", dict(capacity_factor=4 / 2)),  # E / k
    "gshard 0.5": ("_moe_mlp_gshard", dict(capacity_factor=0.5)),
}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_moe_impl_matches_jax(impl):
    """Each impl against its JAX counterpart on the same layer and input:
    the output, the router logits and the dropped fraction (0 but for
    gshard below capacity, where it must be JAX's to the bit)."""
    fn, kw = IMPLS[impl]
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _layer0()
    x = _x(2)
    w_out, w_logits, w_drop = getattr(jt, fn)(jp, jnp.asarray(x), jcfg)
    g_out, g_logits, g_drop = getattr(pt, fn)(tp, torch.from_numpy(x), tcfg)
    assert g_out.shape == x.shape and g_out.dtype == torch.float32
    _close(g_out, w_out, LAYER_ATOL)
    _close(g_logits, w_logits, ROUTER_ATOL)
    assert float(g_drop) == float(w_drop)
    assert (float(g_drop) > 0) == (impl == "gshard 0.5")


def test_dropless_matches_dense():
    """dropless (stable sort + grouped products) computes every route, as
    the dense all-experts pass does (tests/test_moe.py's case)."""
    _, tp = _layer0()
    _, tcfg = _cfgs()
    x = torch.from_numpy(_x(6))
    out_d, logits_d, _ = pt._moe_mlp_dense(tp, x, tcfg)
    out_l, logits_l, drop = pt._moe_mlp_dropless(tp, x, tcfg)
    torch.testing.assert_close(logits_l, logits_d, atol=0, rtol=0)
    torch.testing.assert_close(out_l, out_d, atol=LAYER_ATOL, rtol=0)
    assert float(drop) == 0.0


def test_gshard_exact_at_full_capacity_and_drops_below():
    """gshard equals dense at capacity_factor E/k (no route can overflow,
    dropped 0); at 0.25 it drops routes and departs from dense."""
    _, tp = _layer0()
    _, tcfg = _cfgs()
    x = torch.from_numpy(_x(4, S=9))
    out_d, _, _ = pt._moe_mlp_dense(tp, x, tcfg)
    out_g, _, drop = pt._moe_mlp_gshard(tp, x, dataclasses.replace(tcfg, capacity_factor=2.0))
    torch.testing.assert_close(out_g, out_d, atol=LAYER_ATOL, rtol=0)
    assert float(drop) == 0.0
    out_low, _, drop_low = pt._moe_mlp_gshard(tp, x, dataclasses.replace(tcfg,
                                                                        capacity_factor=0.25))
    assert 0.0 < float(drop_low) <= 1.0
    assert not torch.allclose(out_low, out_d, atol=1e-5)


@pytest.mark.parametrize("T", [pt.MOE_AUTO_DENSE_MAX - 1, pt.MOE_AUTO_DENSE_MAX])
def test_auto_impl_dispatches_on_token_count(T, monkeypatch):
    """moe_impl="auto" runs dense below MOE_AUTO_DENSE_MAX tokens and
    dropless from there, as the JAX package does (the same crossover), and
    gives JAX's auto output."""
    assert pt.MOE_AUTO_DENSE_MAX == jt.MOE_AUTO_DENSE_MAX
    jcfg, tcfg = _cfgs(moe_impl="auto")
    jp, tp = _layer0()
    x = _x(7, B=1, S=T)
    called = []
    for name in ("_moe_mlp_dense", "_moe_mlp_dropless"):
        fn = getattr(pt, name)
        monkeypatch.setattr(pt, name, lambda *a, _n=name, _f=fn: called.append(_n) or _f(*a))
    got = pt._moe_mlp(tp, torch.from_numpy(x), tcfg)[0]
    assert called == ["_moe_mlp_dense" if T < pt.MOE_AUTO_DENSE_MAX else "_moe_mlp_dropless"]
    _close(got, jt._moe_mlp(jp, jnp.asarray(x), jcfg)[0], LAYER_ATOL)


# ------------------------------------------------------------ the trunk


def test_init_params_draws_the_moe_tree():
    """init_params gives the JAX package's MoE tree shapes (one layer of a
    4-D expert stack drawn at a time), and forward runs on it."""
    cfg = tiny_mixtral()
    params = pt.init_params(cfg, 0, device="cpu")
    assert "mlp" not in params["layers"]
    leaves = {("layers", "moe", k): tuple(v.shape) for k, v in params["layers"]["moe"].items()}
    shapes = expected_shapes(cfg)
    assert leaves == {k: v for k, v in shapes.items() if k[:2] == ("layers", "moe")}
    gate = params["layers"]["moe"]["gate"]
    assert abs(float(gate.std()) - 0.02) < 2e-3 and not torch.equal(gate[0], gate[1])
    h, _, _ = forward(params, cfg, torch.from_numpy(_ids()[0]))
    assert h.shape == (2, 12, 64) and torch.isfinite(h).all()


@pytest.mark.parametrize("impl", ["dense", "dropless", "gshard"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(impl, causal):
    jparams, _, tparams = _params()
    jcfg, tcfg = _cfgs(moe_impl=impl)
    ids, mask = _ids()
    want, _, _ = jax_forward(jparams, jcfg, ids, attention_mask=mask, causal=causal)
    got, _, _ = forward(tparams, tcfg, torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask), causal=causal)
    _close(got, want, ATOL)


CACHES = {"f32": (None, None, False), "bf16": (jnp.bfloat16, torch.bfloat16, False),
          "int8": (None, None, True)}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("causal", [True, False])
def test_cached_forward_matches_jax(cache, causal):
    """A prefill into a float32, bf16 or int8 KV cache (causal, or
    bidirectional as encode(get_cache=True) builds it), then two causal
    decode steps: the hidden states of each call and the cache after."""
    jparams, _, tparams = _params()
    jcfg, tcfg = _cfgs()
    jdt, tdt, quant = CACHES[cache]
    atol = ATOL if cache == "f32" else LOW_ATOL
    ids, mask = _ids(3, S=10)
    jc = jt.init_cache(jcfg, 2, 16, dtype=jdt, quant=quant)
    tc = pt.init_cache(tcfg, 2, 16, dtype=tdt, quant=quant, device="cpu")
    steps = [(ids, mask, causal)] + [
        (np.random.default_rng(s).integers(0, 512, size=(2, 1)).astype(np.int32), None, True)
        for s in (4, 5)]
    for step_ids, step_mask, c in steps:
        want, jc, _ = jax_forward(jparams, jcfg, step_ids, attention_mask=step_mask, causal=c,
                                  cache=jc)
        got, tc, _ = forward(tparams, tcfg, torch.from_numpy(step_ids),
                             attention_mask=None if step_mask is None else torch.from_numpy(
                                 step_mask), causal=c, cache=tc)
        _close(got, want, atol)
    assert tc.length == int(jc.length) == 12
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    for name in ("k", "v"):
        _close(getattr(tc, name), np.asarray(getattr(jc, name), np.float32),
               2 if quant else atol)  # int8: at most one step where a rounding tie fell apart


# ------------------------------------------------------------ the entry points


@functools.lru_cache(maxsize=None)
def _models(impl="dense"):
    jparams, _, tparams = _params()
    jcfg, tcfg = _cfgs(moe_impl=impl)
    return (JaxGritLM(jcfg, params=jparams), GritLM(tcfg, params=tparams, device="cpu"))


@pytest.mark.parametrize("impl,instruction", [("dense", ""), ("dense", INSTRUCTION),
                                              ("dropless", INSTRUCTION)])
def test_encode_matches_jax(impl, instruction):
    jm, tm = _models(impl)
    want = jm.encode(DOCS, instruction=instruction)
    got = tm.encode(DOCS, instruction=instruction)
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)


def test_greedy_generate_matches_jax():
    """Ragged batch (one long prompt, one short), 8 tokens, token-exact."""
    jm, tm = _models()
    enc = tm.tokenizer(PROMPTS)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))


def test_generate_from_encode_cache_matches_jax():
    """encode(get_cache=True) (bidirectional through the MoE) continued
    causally by generate."""
    jm, tm = _models()
    _, jcache = jm.encode(DOCS, get_cache=True)
    _, tcache = tm.encode(DOCS, get_cache=True)
    enc = tm.tokenizer(["<|user|>\nSummarise\n<|assistant|>\n"] * 2, add_special_tokens=False)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=jcache,
                                max_new_tokens=6)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], cache=tcache,
                               max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


LENS = [3, 9, 5, 12, 7, 4, 11]
POOL = dict(max_batch=3, max_len=32, chunk_size=4, prompt_buckets=(16,))
PAGED = dict(paged=True, page_size=8, pool_pages=10)


def _specs(lens=LENS, seed=0, max_new=8):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(3, 512, size=n).tolist(), max_new)
            for i, n in enumerate(lens)]


def _embed_specs():
    rng = np.random.default_rng(3)
    return [(f"e{i}", rng.integers(3, 256, size=n).tolist()) for i, n in enumerate([6, 12, 9])]


def _run(eng, req_cls, embed_cls):
    reqs = [req_cls(input_ids=list(ids), max_new_tokens=n, request_id=rid)
            for rid, ids, n in _specs()]
    reqs += [embed_cls(input_ids=ids, instr_len=2, request_id=rid) for rid, ids in _embed_specs()]
    done = eng.run(reqs)
    return ({c.request_id: list(c.token_ids) for c in done},
            {c.request_id: c.embedding for c in eng.take_embeddings()})


@pytest.fixture(scope="module")
def jax_served():
    jparams, _, _ = _params()
    eng = JaxServingEngine(jax_tiny_mixtral(), jparams, embed_batch=2, **POOL)
    return _run(eng, JaxRequest, JaxEmbedRequest)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_serving_engine_matches_jax(jax_served, pool):
    """More generation requests than slots (slots reused) beside embedding
    requests, through a dense and a paged pool: the JAX engine's tokens and
    pool embeddings."""
    _, _, tparams = _params()
    eng = ServingEngine(tiny_mixtral(), tparams, device="cpu", embed_batch=2, **POOL,
                        **(PAGED if pool == "paged" else {}))
    tokens, embs = _run(eng, Request, EmbedRequest)
    want_tokens, want_embs = jax_served
    assert tokens == want_tokens
    assert set(embs) == set(want_embs)
    for rid, vec in want_embs.items():
        np.testing.assert_allclose(embs[rid], vec, atol=EMB_ATOL, rtol=0)


def test_rag_doc_mode_matches_jax():
    """RAGEngine in doc-caching mode (each passage's cache built through the
    MoE trunk, the query continued over it): JAX's passages and answers."""
    jm, tm = _models()
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


# ------------------------------------------------------------ quantized experts


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quant_moe_matches_jax(bits):
    """quantize_for_serving quantizes the 4-D expert stacks (int4 groups
    along each expert matrix's contracting axis) to JAX's bytes, the router
    stays dense, params_from_jax carries JAX's quantized tree over to the
    same bytes, `_w` dequantizes a layer's stack to JAX's values, and the
    quantized forward gives JAX's hidden states."""
    jparams, _, tparams = _params()
    jcfg, tcfg = _cfgs()
    jtree = jq.quantize_for_serving(jparams, bits=bits)
    ttree = pq.quantize_for_serving(tparams, bits=bits)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), tcfg, device="cpu")
    key = "q8" if bits == 8 else "q4"
    assert torch.equal(ttree["layers"]["moe"]["router"], tparams["layers"]["moe"]["router"])
    for name, K in (("gate", 64), ("up", 64), ("down", 128)):
        want = jtree["layers"]["moe"][name]
        for tree in (ttree, carried):
            node = tree["layers"]["moe"][name]
            for leaf in (key, "scale"):
                np.testing.assert_array_equal(node[leaf].numpy(), np.asarray(want[leaf]),
                                              err_msg=f"{name}/{leaf}")
        if bits == 4:
            assert node["scale"].shape[-2] == K // 32  # groups of 32 along K
        layer = {k: v[1] for k, v in node.items()}
        jlayer = {k: v[1] for k, v in want.items()}
        np.testing.assert_array_equal(pt._w(layer, torch.float32).numpy(),
                                      np.asarray(jt._w(jlayer, jnp.float32)))
    ids, mask = _ids(8)
    for causal in (True, False):
        want, _, _ = jax_forward(jtree, jcfg, ids, attention_mask=mask, causal=causal)
        got, _, _ = forward(ttree, tcfg, torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask), causal=causal)
        _close(got, want, ATOL)


def test_weight_quant_generate_matches_jax():
    """GritLM(weight_quant=8) on a Mixtral config: JAX's greedy tokens."""
    jparams, _, tparams = _params()
    jm = JaxGritLM(jax_tiny_mixtral(), params=jparams, weight_quant=8)
    tm = GritLM(tiny_mixtral(), params=tparams, device="cpu", weight_quant=8)
    assert tm.params["layers"]["moe"]["gate"]["q8"].dtype == torch.int8
    enc = tm.tokenizer(PROMPTS)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


# ------------------------------------------------------------ checkpoints


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


MOE_KEYS = {"model_type": "mixtral", "num_local_experts": 4, "num_experts_per_tok": 2,
            "router_aux_loss_coef": 0.02}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_round_trip(tmp_path, writer):
    """A Mixtral checkpoint written by one package's save_checkpoint loads
    in the other's load_checkpoint: every leaf equal, the MoE keys of
    config.json and the config's MoE fields as written."""
    jparams, np_params, tparams = _params()
    if writer == "jax":
        jax_save_checkpoint(str(tmp_path), jax_tiny_mixtral(), jparams)
        cfg, loaded = load_checkpoint(str(tmp_path), device="cpu")
        loaded = params_to_numpy(loaded)
    else:
        save_checkpoint(str(tmp_path), tiny_mixtral(), tparams)
        cfg, loaded = jax_load_checkpoint(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    assert {k: hf[k] for k in MOE_KEYS} == MOE_KEYS
    assert (cfg.is_moe, cfg.num_local_experts, cfg.num_experts_per_tok) == (True, 4, 2)
    names = sorted(json.load(open(tmp_path / "model.safetensors.index.json"))["weight_map"]) \
        if (tmp_path / "model.safetensors.index.json").exists() else None
    assert names is None or "model.layers.1.block_sparse_moe.experts.3.w2.weight" in names
    want, got = _flat(np_params), _flat(loaded)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_from_pretrained_encodes_as_jax(tmp_path):
    """GritLM.from_pretrained on a Mixtral checkpoint (the port's writer, a
    BPE tokenizer.json beside it): the JAX from_pretrained's token ids,
    embeddings and greedy tokens."""
    _, _, tparams = _params()
    save_checkpoint(str(tmp_path), tiny_mixtral(), tparams)
    make_bpe_tokenizer()._tok.save(str(tmp_path / "tokenizer.json"))
    jm = JaxGritLM.from_pretrained(str(tmp_path))
    tm = GritLM.from_pretrained(str(tmp_path), device="cpu")
    assert tm.config.is_moe and tm.config == dataclasses.replace(tm.config, **{
        f: getattr(jm.config, f) for f in ("num_local_experts", "num_experts_per_tok",
                                          "hidden_size", "num_hidden_layers")})
    enc = jm.tokenizer(PROMPTS)
    np.testing.assert_array_equal(tm.tokenizer(PROMPTS)["input_ids"], enc["input_ids"])
    np.testing.assert_allclose(tm.encode(DOCS), jm.encode(DOCS), atol=EMB_ATOL)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
    got = tm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
