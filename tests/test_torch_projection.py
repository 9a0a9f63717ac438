"""The embedding projection head and `add_lm_head` against the JAX package,
on tiny_mistral (float32, CPU; the port's kernels as their plain versions).

JAX draws a fresh head from its PRNG, the port from a torch.Generator, so
the bits differ: every parity test carries JAX's head over to the port
through `params_from_jax` (a checkpoint's trained head), as the other
tests carry the trunk. Tolerances as tests/test_torch_model.py (unit-norm
embeddings, float32 sums in another order: 1e-5) and
tests/test_torch_train.py (losses rtol 1e-5).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import loader as jax_loader
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.serving import EmbedRequest as JaxEmbedRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import loader, params_from_jax
from gritlm_tpu_torch.models.convert import lora_from_jax, params_to_numpy
from gritlm_tpu_torch.models.transformer import init_projection
from gritlm_tpu_torch.rag import CacheMode, RAGEngine
from gritlm_tpu_torch.serving import EmbedRequest, ServingEngine
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import lora_train_step_fns, make_lora_train_state

P = 32
DOCS = ["Bitcoin is a digital currency.", "A KV cache stores keys and values.",
        "Paris is the capital of France."]
INSTRUCTION = "<|user|>\nRetrieve the passage\n<|embed|>\n"
EMB_ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_head():
    """tiny_mistral's JAX params and a head of width P that the JAX GritLM
    drew itself (projection=P, seed 0: its PRNGKey(1))."""
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams, projection=P)
    head = jax.tree_util.tree_map(np.asarray, jm.projection)
    return jparams, head


def _np_params(jparams, head=None) -> dict:
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if head is not None:
        tree["projection"] = head
    return tree


def _pair(jax_head, **kw):
    """(JAX GritLM, port GritLM) on the same weights and the same head."""
    jparams, head = jax_head
    jm = JaxGritLM(jax_tiny_mistral(), params={**jparams, "projection": head}, **kw)
    tparams = params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
    return jm, GritLM(tiny_mistral(), params=tparams, device="cpu", **kw)


# ------------------------------------------------------------------ encode


@pytest.mark.parametrize("method,instruction", [
    ("mean", ""), ("mean", INSTRUCTION), ("weightedmean", INSTRUCTION), ("lasttoken", ""),
    ("cls", ""),
], ids=["mean", "mean-instruction", "weightedmean-instruction", "lasttoken", "cls"])
def test_encode_with_head_matches_jax(jax_head, method, instruction):
    """Every token projected, then pooled and normalized: P columns, the
    JAX package's values; K2 is not on this path."""
    jm, tm = _pair(jax_head, pooling_method=method, projection=P)
    want = jm.encode(DOCS, instruction=instruction)
    got = tm.encode(DOCS, instruction=instruction)
    assert got.shape == want.shape == (3, P)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    assert tm.encode([]).shape == (0, P)


def test_encode_with_cache_and_head_matches_jax(jax_head):
    """get_cache=True: the same embeddings through the head and the same
    doc cache (the cache is the trunk's, untouched by the head)."""
    jm, tm = _pair(jax_head)
    jemb, jcache = jm.encode(DOCS, get_cache=True)
    temb, tcache = tm.encode(DOCS, get_cache=True)
    assert temb.shape == (3, P)
    np.testing.assert_allclose(temb, jemb, atol=EMB_ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-4)
    np.testing.assert_array_equal(tcache.mask.numpy(), np.asarray(jcache.mask))


def test_head_normalized_false_matches_jax(jax_head):
    jm, tm = _pair(jax_head, normalized=False)
    np.testing.assert_allclose(tm.encode(DOCS), jm.encode(DOCS), atol=1e-4)


# ------------------------------------------------------------ which head


def test_trained_head_wins_and_a_mismatch_warns(jax_head):
    """A head in params wins over no request and over a request of its
    width; another width warns and draws a fresh head, as the JAX GritLM
    does. The caller's params keep their head."""
    jparams, head = jax_head
    tparams = params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
    for request in (None, P):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            m = GritLM(tiny_mistral(), params=tparams, projection=request, device="cpu")
        assert m.projection is tparams["projection"]
        assert "projection" not in m.params
    with pytest.warns(UserWarning, match="trained projection head"):
        m = GritLM(tiny_mistral(), params=tparams, projection=16, device="cpu")
    with pytest.warns(UserWarning, match="trained projection head"):
        jm = JaxGritLM(jax_tiny_mistral(), params={**jparams, "projection": head}, projection=16)
    assert tuple(m.projection["kernel"].shape) == tuple(jm.projection["kernel"].shape)
    assert "projection" in tparams
    assert m.encode(DOCS).shape == (3, 16)


def test_fresh_head_is_drawn_as_jax_draws_it():
    """projection=P with no trained head: uniform in +-sqrt(6 / (D + P)) in
    the model dtype, zero bias, from a generator seeded with seed + 1
    (init_projection); JAX's head has the same shape, dtype and bound."""
    cfg = dataclasses.replace(tiny_mistral(), dtype="bfloat16")
    m = GritLM(cfg, projection=P, seed=4, device="cpu")
    k, b = m.projection["kernel"], m.projection["bias"]
    lim = (6.0 / (cfg.hidden_size + P)) ** 0.5
    assert k.shape == (cfg.hidden_size, P) and k.dtype == b.dtype == torch.bfloat16
    assert float(k.float().abs().max()) <= lim and float(k.float().std()) > lim / 3
    assert not b.any()
    again = init_projection(cfg, P, 5, device="cpu")
    assert torch.equal(again["kernel"], k) and torch.equal(again["bias"], b)
    jm = JaxGritLM(dataclasses.replace(jax_tiny_mistral(), dtype="bfloat16"), projection=P)
    jk = np.asarray(jm.projection["kernel"].astype(jnp.float32))
    assert jk.shape == tuple(k.shape) and np.abs(jk).max() <= lim
    assert jm.projection["kernel"].dtype == jnp.bfloat16


def test_params_from_jax_takes_any_head_width(jax_head):
    jparams, _ = jax_head
    for width in (1, 7, 200):
        head = {"kernel": np.ones((64, width), np.float32), "bias": np.zeros(width, np.float32)}
        got = params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
        assert tuple(got["projection"]["kernel"].shape) == (64, width)
    bad = [{"kernel": np.ones((63, 8), np.float32), "bias": np.zeros(8, np.float32)},
           {"kernel": np.ones((64, 8), np.float32), "bias": np.zeros(9, np.float32)},
           {"kernel": np.ones((64, 8), np.float32)},
           {"kernel": np.ones((64, 8), np.float32), "bias": np.zeros(8, np.float32),
            "scale": np.ones(8, np.float32)}]
    for head in bad:
        with pytest.raises(ValueError, match="projection"):
            params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
    tree = _np_params(jparams)
    tree["extra"] = {"w": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="unknown leaf"):
        params_from_jax(tree, tiny_mistral(), device="cpu")


# ------------------------------------------------------------ checkpoints


def test_checkpoint_head_round_trips(tmp_path, jax_head):
    """save_checkpoint writes the head, from_pretrained carries it (with a
    BPE tokenizer.json): the head bit for bit, P columns, and the JAX
    from_pretrained's embeddings on the same directory."""
    from tok_fixtures import make_bpe_tokenizer

    jparams, head = jax_head
    tparams = params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
    loader.save_checkpoint(str(tmp_path), tiny_mistral(), tparams)
    make_bpe_tokenizer()._tok.save(str(tmp_path / "tokenizer.json"))
    pm = GritLM.from_pretrained(str(tmp_path), device="cpu")
    for key in ("kernel", "bias"):
        assert torch.equal(pm.projection[key], tparams["projection"][key])
    _, back = jax_loader.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(back["projection"]["kernel"]), head["kernel"])
    jm = JaxGritLM.from_pretrained(str(tmp_path))
    got, want = pm.encode(DOCS, instruction=INSTRUCTION), jm.encode(DOCS, instruction=INSTRUCTION)
    assert got.shape == (3, P)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)


def test_add_lm_head_matches_jax():
    """An embedding-only model gets the donor's LM head (mirrors
    tests/test_loader.py::test_add_lm_head), the same tree as the JAX
    package's add_lm_head gives."""
    cfg = tiny_mistral()
    donor = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(3), with_lm_head=True)
    embed_only = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(4), with_lm_head=False)
    want = jax_loader.add_lm_head(embed_only, donor)
    t_donor = params_from_jax(_np_params(donor), cfg, device="cpu")
    t_embed = params_from_jax(_np_params(embed_only), cfg, device="cpu")
    assert "lm_head" not in t_embed
    got = loader.add_lm_head(t_embed, t_donor)
    assert "lm_head" not in t_embed
    assert torch.equal(got["lm_head"]["kernel"], t_donor["lm_head"]["kernel"])
    np.testing.assert_array_equal(params_to_numpy(got)["lm_head"]["kernel"],
                                  np.asarray(want["lm_head"]["kernel"]))
    assert got["embed"]["embedding"] is t_embed["embed"]["embedding"]
    m = GritLM(cfg, params=got, device="cpu")
    assert isinstance(m.generate("<s><|user|>\nHi\n<|assistant|>\n", max_new_tokens=2), str)


# ---------------------------------------------------------------- training


def _batch(bs=4, group=2):
    coll = GritCollator(ByteTokenizer(), query_max_len=32, passage_max_len=32,
                        generative_max_len=48)
    feats = []
    for i in range(bs):
        q = ("find it", f"query number {i}")
        ps = [("find it", f"matching passage {i}")] + [
            ("find it", f"junk {i} {j}") for j in range(group - 1)]
        feats.append((q, ps, [f"what is {i}?", f"it is {i}"]))
    return coll(feats)


def _trained_head_params():
    """JAX params with a head as tests/test_train.py draws it (normal * 0.1,
    zero bias), from numpy."""
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    head = {"kernel": (rng.normal(size=(64, P)) * 0.1).astype(np.float32),
            "bias": np.zeros(P, np.float32)}
    return {**jparams, "projection": jax.tree_util.tree_map(jnp.asarray, head)}


def test_encode_reps_with_head_matches_jax():
    """Training projects the pooled rep (not every token) before the
    normalize: the JAX package's reps."""
    jparams = _trained_head_params()
    batch = _batch()
    tc, jtc = pt.TrainConfig(mode="embedding"), jt.TrainConfig(mode="embedding")
    tparams = params_from_jax(_np_params(jparams), tiny_mistral(), device="cpu")
    feat = pt.batch_to_device(batch, "cpu")["query"]
    got = pt.encode_reps(tparams, tiny_mistral(), tc, feat)
    want = jt.encode_reps(jparams, jax_tiny_mistral(), jtc,
                          jax.tree_util.tree_map(jnp.asarray, batch["query"]))
    assert tuple(got.shape) == (4, P)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=EMB_ATOL)


def test_train_step_with_head_matches_jax():
    """Two train steps with a head (mirrors tests/test_train.py::
    test_projection_head_trains_and_roundtrips): the JAX package's losses
    and grad norms, and the head moved."""
    jparams = _trained_head_params()
    batch = _batch()
    kw = dict(mode="embedding", total_steps=4, learning_rate=1e-2, warmup_ratio=0.0,
              remat=False)
    jtc, tc = jt.TrainConfig(**kw), pt.TrainConfig(**kw)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    tparams = params_from_jax(_np_params(jparams), tiny_mistral(), device="cpu")
    head0 = tparams["projection"]["kernel"].clone()
    state = pt.init_train_state(tparams, tc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    for step in (1, 2):
        jstate, jm = jstep(jstate, jbatch, jax_tiny_mistral(), jtc)
        state, m = pt.train_step(state, batch, tiny_mistral(), tc)
        for name in ("loss", "loss_emb"):
            np.testing.assert_allclose(float(getattr(m, name)), float(getattr(jm, name)),
                                       rtol=LOSS_RTOL, err_msg=f"step {step} {name}")
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm), rtol=1e-4)
    assert np.isfinite(float(m.loss))
    assert not torch.allclose(state.params["projection"]["kernel"], head0)
    np.testing.assert_allclose(state.params["projection"]["kernel"].detach().numpy(),
                               np.asarray(jstate.params["projection"]["kernel"]), atol=1e-4)


def test_lora_keeps_the_head_frozen_as_jax():
    """Under LoRA the head is part of the frozen base, as in the JAX
    package's make_lora_train_state: the LoRA loss with the head is JAX's,
    no adapter targets it, it takes no gradient, and merge exports it
    unchanged."""
    jparams = _trained_head_params()
    batch = _batch()
    jtc = jt.TrainConfig(mode="unified", remat=False, total_steps=10, learning_rate=2e-3)
    jlora, scale = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    want, _ = jax_lora_fns(jparams, jax_tiny_mistral(), jtc, scale)(
        jlora, jax.tree_util.tree_map(jnp.asarray, batch))
    tc = pt.TrainConfig(mode="unified", remat=False, total_steps=10, learning_rate=2e-3)
    base = params_from_jax(_np_params(jparams), tiny_mistral(), device="cpu")
    run_step, state, frozen, _ = make_lora_train_state(tiny_mistral(), tc, base, r=4, alpha=8,
                                                       device="cpu")
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora), device="cpu")
    got, _ = lora_train_step_fns(frozen, tiny_mistral(), tc, scale)(
        start, pt.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert "projection" not in state.params and "projection" not in jlora
    for _ in range(2):
        state, m = run_step(state, batch)
    assert np.isfinite(float(m.loss))
    assert not frozen["projection"]["kernel"].requires_grad
    from gritlm_tpu_torch.training.lora import merge

    merged = merge(frozen, state.params, scale)
    assert torch.equal(merged["projection"]["kernel"], base["projection"]["kernel"])


def test_cli_reloads_a_checkpoint_with_its_head(tmp_path, jax_head):
    """`training.run --model_name_or_path ckpt` on a checkpoint that
    carries a head trains it with the rest (full parameters) and exports
    it; the export reloads through from_pretrained with P columns."""
    from gritlm_tpu_torch.training.run import main

    jparams, head = jax_head
    ckpt = tmp_path / "ckpt"
    tparams = params_from_jax(_np_params(jparams, head), tiny_mistral(), device="cpu")
    loader.save_checkpoint(str(ckpt), tiny_mistral(), tparams)
    out = tmp_path / "run"
    r = main(["--train_data", "tests/toy_data", "--model_name_or_path", str(ckpt),
              "--device", "cpu", "--per_device_train_batch_size", "2", "--max_steps", "2",
              "--query_max_len", "128", "--passage_max_len", "128",
              "--generative_max_len", "64", "--save_steps", "0", "--output_dir", str(out)])
    assert r["steps"] == 2 and all(np.isfinite(v) for v in r["final"].values())
    _, back = loader.load_checkpoint(r["export"], device="cpu")
    assert tuple(back["projection"]["kernel"].shape) == (64, P)
    assert not torch.equal(back["projection"]["kernel"], tparams["projection"]["kernel"])
    assert GritLM.from_pretrained(r["export"], device="cpu").encode(DOCS).shape == (3, P)


# -------------------------------------------------------- serving and RAG


def test_serving_embeddings_ignore_the_head(jax_head):
    """The JAX ServingEngine encodes with has_projection=False, so pool
    embeddings ignore a head in the params; the port's engine does the
    same (D columns, the JAX engine's values, equal to the headless
    engine's)."""
    jparams, head = jax_head
    pool = dict(max_batch=2, max_len=32, chunk_size=4, prompt_buckets=(16,), embed_batch=2)
    rng = np.random.default_rng(3)
    specs = [(f"e{i}", rng.integers(3, 256, size=n).tolist()) for i, n in enumerate((6, 11))]
    jeng = JaxServingEngine(jax_tiny_mistral(), {**jparams, "projection": head}, **pool)
    jeng.run([JaxEmbedRequest(input_ids=ids, instr_len=2, request_id=rid)
              for rid, ids in specs])
    want = {c.request_id: c.embedding for c in jeng.take_embeddings()}
    got = {}
    for tree in (_np_params(jparams, head), _np_params(jparams)):
        eng = ServingEngine(tiny_mistral(), params_from_jax(tree, tiny_mistral(), device="cpu"),
                            device="cpu", **pool)
        eng.run([EmbedRequest(input_ids=ids, instr_len=2, request_id=rid)
                 for rid, ids in specs])
        got["projection" in tree] = {c.request_id: c.embedding for c in eng.take_embeddings()}
    for rid, vec in want.items():
        assert np.shape(vec) == (64,)
        np.testing.assert_allclose(got[True][rid], vec, atol=EMB_ATOL, rtol=0)
        np.testing.assert_array_equal(got[True][rid], got[False][rid])


def test_rag_engine_encodes_through_the_head(jax_head):
    """RAGEngine encodes passages and queries through the model, so the
    head applies: a P-wide index, and the JAX engine's passages and
    scores."""
    jm, tm = _pair(jax_head)
    passages = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(6)]
    queries = ["what is fact number 3?", "tell me about place 5"]
    je = JaxRAGEngine(jm, max_new_tokens=4, encode_max_length=64)
    te = RAGEngine(tm, max_new_tokens=4, encode_max_length=64)
    je.build_index(passages, batch_size=4)
    te.build_index(passages, batch_size=4)
    assert te.index.dim == P
    want = je.answer_batch(queries, mode="doc")
    got = te.answer_batch(queries, mode=CacheMode.DOC)
    assert [r.passages for r in got] == [r.passages for r in want]
    assert [r.answer for r in got] == [r.answer for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.scores, w.scores, atol=EMB_ATOL, rtol=0)
