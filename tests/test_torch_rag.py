"""The port's RAG path (concat_caches, RAGEngine in all seven cache modes,
the doc-cache store and pool, the latency harness and the rag.eval CLI)
against the JAX package on tiny_mistral.

Both packages get the same weights (`params_from_jax`), passages and
queries, and run float32 on the CPU (the port's kernels as their plain
versions). Greedy answers and retrieved passages must be identical;
retrieval scores agree within 1e-5 (the same bf16 corpus and queries, fp32
sums in another order). The doc-cache store is held bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gritlm_tpu.eval.latency as jax_latency
import gritlm_tpu.rag.corpus as jax_corpus
import gritlm_tpu.rag.eval as jax_eval
import gritlm_tpu.rag.metrics as jax_metrics
import gritlm_tpu.rag.tasks as jax_tasks
import gritlm_tpu.training.templates as jax_templates
import gritlm_tpu_torch.eval.latency as latency
import gritlm_tpu_torch.rag.corpus as corpus
import gritlm_tpu_torch.rag.eval as port_eval
import gritlm_tpu_torch.rag.metrics as metrics
import gritlm_tpu_torch.rag.tasks as tasks
import gritlm_tpu_torch.training.templates as templates
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.generate import concat_caches as jax_concat_caches
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import KVCache as JaxKVCache
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import concat_caches
from gritlm_tpu_torch.index import FlatIndex
from gritlm_tpu_torch.models import KVCache, params_from_jax
from gritlm_tpu_torch.rag import CacheMode, RAGEngine

ROOT = Path(__file__).resolve().parents[1]
MODES = [m.value for m in CacheMode]
PASSAGES = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(8)]
QUERIES = ["what is fact number 3?", "tell me about place 5", "fact number 1?"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(kv_quant=False):
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return (JaxGritLM(jax_tiny_mistral(), params=jparams, kv_quant=kv_quant),
            GritLM(tiny_mistral(), params=tparams, device="cpu", kv_quant=kv_quant))


@pytest.fixture(scope="module")
def engines():
    """(JAX RAGEngine, port RAGEngine) on the same weights and index."""
    jm, tm = _models()
    je = JaxRAGEngine(jm, max_new_tokens=4, encode_max_length=64)
    te = RAGEngine(tm, max_new_tokens=4, encode_max_length=64)
    je.build_index(PASSAGES, batch_size=4)
    te.build_index(PASSAGES, batch_size=4)
    return je, te


@pytest.mark.parametrize("mode", MODES)
def test_answers_match_jax(engines, mode):
    je, te = engines
    want = je.answer_batch(QUERIES, mode=mode)
    got = te.answer_batch(QUERIES, mode=mode)
    assert [r.answer for r in got] == [r.answer for r in want]
    assert [r.passages for r in got] == [r.passages for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)
        assert g.seconds > 0


def test_answer_batch_matches_answer(engines):
    _, te = engines
    queries = QUERIES[:2]
    for mode in MODES:
        batch = te.answer_batch(queries, mode=mode)
        singles = [te.answer(q, mode=mode) for q in queries]
        assert [b.answer for b in batch] == [s.answer for s in singles], mode
        assert [b.passages for b in batch] == [s.passages for s in singles], mode


def test_single_query_doc_memo(engines):
    """The B == 1 path keeps per-doc caches (LRU of 4): a repeat answer and
    a cache made by precompute_doc_cache are reused, not encoded again."""
    _, te = engines
    eng = RAGEngine(te.model, index=te.index, max_new_tokens=4, encode_max_length=64)
    first = eng.answer("what is fact number 2?", mode=CacheMode.DOC)
    assert len(eng._doc_cache) == 1
    assert eng.answer("what is fact number 2?", mode=CacheMode.DOC).answer == first.answer
    assert len(eng._doc_cache) == 1
    for d in range(6):
        eng.precompute_doc_cache(d, CacheMode.QUERYDOC)
    assert list(eng._doc_cache) == [(d, True) for d in range(2, 6)]


def _random_cache(rng, S, length, quant):
    L, B, Kv, Dh = 2, 2, 2, 4
    if quant:
        k = rng.integers(-127, 128, size=(L, B, S, Kv * Dh)).astype(np.int8)
        v = rng.integers(-127, 128, size=(L, B, S, Kv * Dh)).astype(np.int8)
        ks = rng.random((L, B, Kv, S)).astype(np.float32)
        vs = rng.random((L, B, Kv, S)).astype(np.float32)
    else:
        k = rng.normal(size=(L, B, S, Kv * Dh)).astype(np.float32)
        v = rng.normal(size=(L, B, S, Kv * Dh)).astype(np.float32)
        ks = vs = None
    mask = (rng.random((B, S)) > 0.3).astype(np.int32)
    mask[:, length:] = 0
    return k, v, mask, length, ks, vs


@pytest.mark.parametrize("total_len", [None, 24])
@pytest.mark.parametrize("quant", [False, True])
def test_concat_caches_matches_jax(quant, total_len):
    rng = np.random.default_rng(0)
    a, b = _random_cache(rng, 8, 5, quant), _random_cache(rng, 6, 4, quant)

    def jax_cache(k, v, mask, length, ks, vs):
        return JaxKVCache(k=jnp.asarray(k), v=jnp.asarray(v), mask=jnp.asarray(mask),
                          length=jnp.int32(length),
                          k_scale=None if ks is None else jnp.asarray(ks),
                          v_scale=None if vs is None else jnp.asarray(vs))

    def port_cache(k, v, mask, length, ks, vs):
        return KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                       mask=torch.from_numpy(mask), length=length,
                       k_scale=None if ks is None else torch.from_numpy(ks),
                       v_scale=None if vs is None else torch.from_numpy(vs))

    want = jax_concat_caches(jax_cache(*a), jax_cache(*b), total_len=total_len)
    got = concat_caches(port_cache(*a), port_cache(*b), total_len=total_len)
    assert got.length == int(want.length) == 9
    assert got.max_len == want.max_len == (total_len or 9)
    for name in ("k", "v", "mask") + (("k_scale", "v_scale") if quant else ()):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    mixed = port_cache(*_random_cache(rng, 6, 4, not quant))
    with pytest.raises(ValueError, match="int8"):
        concat_caches(port_cache(*a), mixed)


def _store_as_float(store):
    out = {}
    for key, (k, v, w, ks, vs) in store.items():
        arrs = [x for x in (k, v, ks, vs) if x is not None]
        out[key] = (w, [np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                                   dtype=np.float32) for x in arrs],
                    [str(x.dtype) for x in arrs])
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_doc_store_cross_load(tmp_path, kv_quant, direction):
    """bf16 caches (bf16 model) and int8 caches with bf16 scales
    (kv_quant=True) saved by one package load bit for bit in the other."""
    docs = [{"title": "", "text": f"stored doc {i} " + "word " * i} for i in range(3)]
    path = str(tmp_path / "doc_store.npz")
    if direction == "jax_to_port":
        cfg = jax_tiny_mistral() if kv_quant else dataclasses.replace(jax_tiny_mistral(),
                                                                      dtype="bfloat16")
        src = JaxRAGEngine(JaxGritLM(cfg, seed=0, kv_quant=kv_quant), encode_max_length=64)
        dst = RAGEngine(GritLM(tiny_mistral(), device="cpu"), encode_max_length=64)
    else:
        cfg = tiny_mistral() if kv_quant else dataclasses.replace(tiny_mistral(),
                                                                  dtype="bfloat16")
        src = RAGEngine(GritLM(cfg, seed=0, device="cpu", kv_quant=kv_quant),
                        encode_max_length=64)
        dst = JaxRAGEngine(JaxGritLM(jax_tiny_mistral(), seed=0), encode_max_length=64)
    src.build_index(docs, batch_size=4, cache_docs=True)
    src.save_doc_store(path)
    assert dst.load_doc_store(path) == len(src._doc_store) == 3
    want, got = _store_as_float(src._doc_store), _store_as_float(dst._doc_store)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key][0] == want[key][0]
        assert [d.replace("torch.", "") for d in got[key][2]] == \
               [d.replace("torch.", "") for d in want[key][2]]
        for g, w in zip(got[key][1], want[key][1]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_device_pool_matches_host_fetch(kv_quant):
    """The device pool (index_select) gives the host fetch's caches on every
    valid slot and the same answers in the three doc-cache modes, with
    ragged doc widths and int8 stores."""
    _, model = _models(kv_quant)
    docs = [{"title": f"t{i}", "text": "doc " + "word " * (3 + 5 * i)} for i in range(5)]
    queries = ["what is doc 1?", "tell me about doc 4"]
    pooled = RAGEngine(model, max_new_tokens=4, encode_max_length=64)
    pooled.build_index(docs, batch_size=4, cache_docs=True)
    assert pooled._device_pool.get(False) is not None
    host = RAGEngine(model, max_new_tokens=4, encode_max_length=64, doc_pool_bytes=0)
    host.index, host._doc_store, host._device_pool = pooled.index, pooled._doc_store, {}

    ids = [0, 3, 1]
    a, b = pooled._fetch_doc_caches(ids, False), host._fetch_doc_caches(ids, False)
    assert host._device_pool[False] is None  # over budget: not pinned
    Wb = b.k.shape[2]  # host stacks to the batch's widest doc, the pool to the corpus's
    assert torch.equal(a.mask[:, :Wb], b.mask) and not a.mask[:, Wb:].any()
    for i in range(len(ids)):
        w = int(b.mask[i].sum())
        assert torch.equal(a.k[:, i, :w], b.k[:, i, :w])
        assert torch.equal(a.v[:, i, :w], b.v[:, i, :w])
        if kv_quant:
            assert torch.equal(a.k_scale[:, i, :, :w], b.k_scale[:, i, :, :w])
            assert torch.equal(a.v_scale[:, i, :, :w], b.v_scale[:, i, :, :w])
    for mode in (CacheMode.DOC, CacheMode.QUERYDOC, CacheMode.DOCQUERY):
        if mode == CacheMode.QUERYDOC:
            pooled.precompute_all_doc_caches(after_query=True)
            host._doc_store, host._device_pool = pooled._doc_store, {}
        got = [r.answer for r in pooled.answer_batch(queries, mode=mode)]
        want = [r.answer for r in host.answer_batch(queries, mode=mode)]
        assert got == want, mode


def test_device_pool_invalidated_when_store_grows():
    _, model = _models()
    eng = RAGEngine(model, max_new_tokens=4, encode_max_length=64)
    eng.build_index([{"title": "", "text": f"growing doc {i}"} for i in range(4)], batch_size=4)
    eng._ensure_doc_entries([0, 1])
    assert eng._fetch_doc_caches([0, 1], False) is not None
    assert len(eng._device_pool[False][0]) == 2  # a 2-doc pool, pinned lazily
    eng._ensure_doc_entries([2, 3])  # the store grows: the pool is dropped
    assert False not in eng._device_pool
    assert eng._fetch_doc_caches([0, 3], False) is not None
    assert len(eng._device_pool[False][0]) == 4


def test_build_index_invalidates_doc_caches(tmp_path):
    """A new corpus drops every doc-id-keyed cache; a store saved beside the
    index serves a fresh engine without any corpus re-encode."""
    _, model = _models()
    eng = RAGEngine(model, max_new_tokens=4, encode_max_length=64)
    eng.build_index([{"title": "", "text": f"alpha document {i}"} for i in range(4)],
                    batch_size=4, cache_docs=True)
    eng.answer_batch(["alpha?"], mode=CacheMode.DOC)
    assert eng._doc_store and eng._stacked_last is not None
    corpus_b = [{"title": "", "text": f"beta passage {i}"} for i in range(4)]
    eng.build_index(corpus_b, batch_size=4, cache_docs=False)
    assert not eng._doc_store and not eng._doc_cache and not eng._device_pool
    assert eng._stacked_last is None
    rb = eng.answer_batch(["beta?"], mode=CacheMode.DOC)
    assert "beta" in rb[0].passages[0]["text"]
    fresh = RAGEngine(model, max_new_tokens=4, encode_max_length=64)
    fresh.build_index(corpus_b, batch_size=4, cache_docs=True)
    assert fresh.answer_batch(["beta?"], mode=CacheMode.DOC)[0].answer == rb[0].answer

    fresh.index.save(str(tmp_path / "idx"))
    fresh.save_doc_store(str(tmp_path / "idx" / "doc_store.npz"))
    loaded = RAGEngine(model, max_new_tokens=4, encode_max_length=64)
    loaded.index = FlatIndex.load(str(tmp_path / "idx"), device="cpu")
    assert loaded.load_doc_store(str(tmp_path / "idx" / "doc_store.npz")) == 4
    encode = model.encode

    def guarded(*a, **kw):
        assert not kw.get("get_cache"), "the corpus cache was encoded again"
        return encode(*a, **kw)

    model.encode = guarded
    try:
        assert loaded.answer_batch(["beta?"], mode=CacheMode.DOC)[0].answer == rb[0].answer
    finally:
        model.encode = encode


def test_evaluate_matches_jax(engines):
    je, te = engines
    golds = [["K"], ["place 5"], ["nothing"]]
    want = je.evaluate(QUERIES, golds, mode="no_retrieval", batch_size=2)
    got = te.evaluate(QUERIES, golds, mode="no_retrieval", batch_size=2)
    assert sorted(got) == sorted(want)
    for key in ("exact_match", "match", "f1", "mode", "n", "predictions"):
        assert got[key] == want[key], key


PREDS = ["The  Quick, Brown Fox!", "in Paris", "the answer is Paris.", "Paris France", "", "dog"]
GOLDS = [["quick brown fox"], ["Paris"], ["Paris", "London"], ["Paris"], [""], ["cat", "a dog"]]


def test_copied_modules_match_jax(tmp_path):
    """metrics, tasks, corpus and templates are copies: the same numbers and
    strings on the same inputs."""
    for fn in ("exact_match_score", "match_score", "f1_score"):
        assert ([getattr(metrics, fn)(p, g) for p, g in zip(PREDS, GOLDS)]
                == [getattr(jax_metrics, fn)(p, g) for p, g in zip(PREDS, GOLDS)])
    assert [metrics.normalize_answer(p) for p in PREDS] == \
           [jax_metrics.normalize_answer(p) for p in PREDS]
    assert metrics.evaluate_answers(PREDS, GOLDS) == jax_metrics.evaluate_answers(PREDS, GOLDS)

    qa = tmp_path / "qa.jsonl"
    qa.write_text("".join(json.dumps({"id": i, "question": f"q{i}?", "answers": [f"a{i}"]})
                          + "\n" for i in range(5)) + "\n")
    for kw in ({}, {"shard_rank": 1, "shard_count": 2}):
        assert list(tasks.data_iterator(str(qa), **kw)) == \
               list(jax_tasks.data_iterator(str(qa), **kw))
    for name in ("qa", "base"):
        pt, jt = tasks.get_task(name), jax_tasks.get_task(name)
        ex = {"question": "q?", "query": "q?", "answers": ["Paris"], "target": "Paris"}
        assert pt.process(dict(ex)) == jt.process(dict(ex))
        assert pt.gold_answers(dict(ex)) == jt.gold_answers(dict(ex))
        assert pt.evaluation("in Paris", ["Paris"]) == jt.evaluation("in Paris", ["Paris"])
    ps = [[{"id": 1, "text": "a"}, {"id": 2, "text": "b"}]] * 2
    sc = [[0.9, 0.8]] * 2
    meta = [{"id": 1}, {"id": 3}]
    assert tasks.filter_results_by_id(meta, ps, sc, 2) == \
           jax_tasks.filter_results_by_id(meta, ps, sc, 2)
    assert list(tasks.batch_iterator(range(0), 2)) == []

    pfile = tmp_path / "p.jsonl"
    pfile.write_text('{"title": "T", "section": "S", "text": "x"}\n\n{"text": "y"}\n'
                     '{"title": "U", "text": "z"}\n')
    assert corpus.load_passages(str(pfile)) == jax_corpus.load_passages(str(pfile))
    assert corpus.load_passages(str(pfile), maxload=2, shard_rank=1, shard_count=2) == \
           jax_corpus.load_passages(str(pfile), maxload=2, shard_rank=1, shard_count=2)
    loaded = corpus.load_passages(str(pfile))
    assert [corpus.passage_text(p) for p in loaded] == \
           [jax_corpus.passage_text(p) for p in loaded]
    assert corpus.limit_passages(loaded, 2, 1) == jax_corpus.limit_passages(loaded, 2, 1)
    assert corpus.synthetic_passages(7) == jax_corpus.synthetic_passages(7)

    for s in ("", "Retrieve passages\n", ("Find it: ", "text")):
        if isinstance(s, str):
            assert templates.gritlm_instruction(s) == jax_templates.gritlm_instruction(s)
            assert templates.embed_prefix(s) == jax_templates.embed_prefix(s)
        assert templates.format_embed(s) == jax_templates.format_embed(s)
    turns = ["hi", "hello", "more?"]
    assert templates.format_generative(turns) == jax_templates.format_generative(turns)


def test_run_sweep_keys_match_jax(engines):
    """The latency harness's key schema '{q}-{d}-{maxtoks}-{device}-{mode}'
    and stats keys, on the same tiny grid."""
    je, te = engines
    kw = dict(lengths=(16,), modes=("prompt_query_doc", "docquery"), query_lengths=(8,),
              max_new_tokens=2, n_queries=2, reps=1, n_docs=2)
    want = jax_latency.run_sweep(je.model, **kw)
    got = latency.run_sweep(te.model, warmup=1, **kw)
    assert sorted(got) == sorted(want)
    assert sorted(got["_meta"]) == sorted(want["_meta"]) and got["_meta"]["device"] == "cpu"
    for key in got:
        assert sorted(got[key]) == sorted(want[key]), key
    tok = te.model.tokenizer
    assert latency.synthetic_text(tok, 30) == jax_latency.synthetic_text(tok, 30)
    assert latency.measure_dispatch_floor("cpu", reps=2) > 0


def _files_and_keys(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            data = json.load(f)
        out[name] = {k: sorted(v) if isinstance(v, dict) else None for k, v in data.items()}
    return out


@pytest.mark.parametrize("form", ["qa", "latency"])
def test_cli_matches_jax(tmp_path, form):
    """`python -m gritlm_tpu_torch.rag.eval --device cpu` writes the JAX
    CLI's file names with the same JSON keys."""
    common = ["--model_preset", "tiny_mistral", "--max_new_tokens", "2", "--embedbs", "4"]
    if form == "qa":
        passages, qa = tmp_path / "passages.jsonl", tmp_path / "qa.jsonl"
        passages.write_text("".join(json.dumps(p) + "\n" for p in PASSAGES))
        qa.write_text("".join(json.dumps({"question": q, "answers": ["4"]}) + "\n"
                              for q in QUERIES[:2]))
        common += ["--passages", str(passages), "--eval_data", str(qa), "--cache", "doc",
                   "--max_length", "64"]
    else:
        common += ["--latency", "--customq", "8", "--customd", "16", "--cache", "docquery",
                   "--latency_reps", "1", "--n_latency_queries", "2"]
    jax_eval.main(common + ["--save_dir", str(tmp_path / "jax")])
    subprocess.run([sys.executable, "-m", "gritlm_tpu_torch.rag.eval", *common, "--device",
                    "cpu", "--save_dir", str(tmp_path / "port")],
                   cwd=ROOT, check=True, capture_output=True, timeout=300)
    want, got = _files_and_keys(tmp_path / "jax"), _files_and_keys(tmp_path / "port")
    assert got == want and len(got) == 1


def test_not_ported_parts_raise(engines, tmp_path):
    """What raised before the speculative and sampling slice now runs:
    serve(speculative=True) and serve(temperature > 0), RAGEngine(
    speculative=True) (greedy-only: min_new_tokens raises ValueError), and
    the CLI's --speculative."""
    _, te = engines
    kw = dict(max_new_tokens=3, slots=2, pool_max_len=512, prompt_buckets=(64, 128, 256))
    plain = [r.answer for r in te.serve(["q"], **kw)]
    assert [r.answer for r in te.serve(["q"], speculative=True, spec_k=3, **kw)] == plain
    assert len(te.serve(["q"], temperature=0.7, **kw)) == 1
    spec = RAGEngine(te.model, index=te.index, max_new_tokens=4, encode_max_length=64,
                     speculative=True)
    assert [r.answer for r in spec.answer_batch(QUERIES[:2])] == \
           [r.answer for r in te.answer_batch(QUERIES[:2])]
    with pytest.raises(ValueError, match="greedy-only"):
        RAGEngine(te.model, speculative=True, min_new_tokens=1)
    qa = tmp_path / "qa.jsonl"
    qa.write_text(json.dumps({"question": QUERIES[0], "answers": ["4"]}) + "\n")
    out = port_eval.main(["--model_preset", "tiny_mistral", "--device", "cpu",
                          "--no_retrieval", "--speculative", "--max_new_tokens", "2",
                          "--eval_data", str(qa), "--save_dir", str(tmp_path / "out")])
    assert out is not None and len(list((tmp_path / "out").glob("*.json"))) == 1
