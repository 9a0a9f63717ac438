"""The port's serving engine (gritlm_tpu_torch.serving), its CLI
(`python -m gritlm_tpu_torch.serve`) and `RAGEngine.serve` against the JAX
package on tiny_mistral.

Both packages get the same weights (`params_from_jax`) and requests and run
float32 on the CPU (the port's kernels as their plain versions), so greedy
tokens must be identical. Pool embeddings agree within 1e-5 (the same
encoder forward, fp32 sums in another order). The JAX engines are few and
built once per module (module fixtures); the cheaper cases are held to the
port's own lockstep `generate`, which tests/test_torch_model.py holds to the
JAX package.
"""

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gritlm_tpu.serve as jax_serve
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import forward as jax_forward
from gritlm_tpu.models.transformer import init_cache as jax_init_cache
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.serving import EmbedRequest as JaxEmbedRequest
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import generate, make_cache_for_prompt
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.rag import RAGEngine
from gritlm_tpu_torch.serving import EmbedRequest, Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
MAXNEW = 8
LENS = [3, 9, 5, 12, 7, 4, 11]
POOL = dict(max_batch=3, max_len=32, chunk_size=4, prompt_buckets=(16,))
EMB_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    cfg = jax_tiny_mistral()
    jparams = jax_init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return jparams, tparams


def _specs(lens, seed=0, max_new=MAXNEW):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(3, 512, size=n).tolist(), max_new)
            for i, n in enumerate(lens)]


def _requests(specs, cls=Request, **kw):
    return [cls(input_ids=list(ids), max_new_tokens=n, request_id=rid, **kw)
            for rid, ids, n in specs]


def _embed_specs(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [(f"e{i}", rng.integers(3, 256, size=n).tolist()) for i, n in enumerate(lens)]


def _tokens(done) -> Dict[str, list]:
    return {c.request_id: list(c.token_ids) for c in done}


def _port(tparams, **kw):
    return ServingEngine(tiny_mistral(), tparams, device="cpu", **{**POOL, **kw})


def _oracle(tparams, ids, max_new):
    """The port's lockstep generate, one request alone."""
    cfg = tiny_mistral()
    arr = torch.tensor([ids], dtype=torch.int32)
    cache = make_cache_for_prompt(cfg, 1, len(ids), max_new, device="cpu")
    res = generate(tparams, cfg, arr, torch.ones_like(arr), cache, max_new_tokens=max_new,
                   eos_id=2, pad_id=2)
    return res.tokens[0, :int(res.num_valid[0])].tolist()


@pytest.fixture(scope="module")
def jax_mixed(models):
    """The JAX engine's greedy tokens and pool embeddings for LENS plus
    three embedding requests, dense pool, float32 and int8 KV."""
    jparams, _ = models
    out = {}
    for quant in (False, True):
        eng = JaxServingEngine(jax_tiny_mistral(), jparams, kv_quant=quant, embed_batch=2,
                               **POOL)
        reqs = _requests(_specs(LENS), JaxRequest) + [
            JaxEmbedRequest(input_ids=ids, instr_len=2, request_id=rid)
            for rid, ids in _embed_specs([6, 12, 9])]
        done = eng.run(reqs)
        out[quant] = (_tokens(done), {c.request_id: c.embedding
                                      for c in eng.take_embeddings()})
    return out


@pytest.mark.parametrize("kv_quant,overlap", [(False, False), (False, True), (True, True)])
def test_dense_pool_matches_jax(models, jax_mixed, kv_quant, overlap):
    """Ragged requests (more than slots, so slots are reused) mixed with
    embedding requests: the JAX engine's tokens and embeddings."""
    _, tparams = models
    streamed = {}
    eng = _port(tparams, kv_quant=kv_quant, overlap=overlap, embed_batch=2,
                on_embedding=lambda rid, v: streamed.__setitem__(rid, v))
    reqs = _requests(_specs(LENS)) + [EmbedRequest(input_ids=ids, instr_len=2, request_id=rid)
                                      for rid, ids in _embed_specs([6, 12, 9])]
    done = eng.run(reqs)
    want_tok, want_emb = jax_mixed[kv_quant]
    assert _tokens(done) == want_tok
    got_emb = {c.request_id: c.embedding for c in eng.take_embeddings()}
    assert set(got_emb) == set(want_emb) == set(streamed)
    for rid, vec in want_emb.items():
        np.testing.assert_allclose(got_emb[rid], vec, atol=EMB_ATOL, rtol=0)
    assert all(c.finish_reason in ("eos", "length") for c in done)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_pool_matches_jax(models, jax_mixed, kv_quant):
    """A paged pool with fewer pages than the dense equivalent gives the
    JAX engine's tokens (paging is invisible to outputs in both packages)."""
    _, tparams = models
    eng = _port(tparams, kv_quant=kv_quant, paged=True, page_size=8, pool_pages=10)
    done = eng.run(_requests(_specs(LENS)))
    assert _tokens(done) == jax_mixed[kv_quant][0]
    assert len(eng._free_pages) == 9  # every private page returned


def test_chunked_prefill_and_adaptive_chunks_match_jax(models, jax_mixed):
    """Scheduling never changes tokens: chunked prefill (dense and paged) and
    adaptive decode-chunk lengths give the JAX engine's tokens."""
    _, tparams = models
    for kw in (dict(prefill_chunk=4), dict(prefill_chunk=4, paged=True, page_size=8),
               dict(adaptive_chunk=True, chunk_size=8)):
        eng = _port(tparams, **kw)
        assert _tokens(eng.run(_requests(_specs(LENS)))) == jax_mixed[False][0], kw


def _doc_entries(jparams, docs):
    """Doc-store entries (k, v, w, None, None) by causal prefill in the JAX
    package: numpy for the JAX engine, torch for the port."""
    out = []
    for d in docs:
        cache = jax_init_cache(jax_tiny_mistral(), 1, len(d))
        _, cache, _ = jax_forward(jparams, jax_tiny_mistral(), jnp.asarray([d], jnp.int32),
                                  causal=True, cache=cache)
        out.append((np.asarray(cache.k[:, 0]), np.asarray(cache.v[:, 0]), len(d), None, None))
    return out


@pytest.fixture(scope="module")
def doc_case(models):
    """Doc-continuation requests beside a plain one, through the JAX engine."""
    jparams, _ = models
    rng = np.random.default_rng(3)
    docs = [rng.integers(3, 512, size=n).tolist() for n in (7, 13, 5)]
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 6, 9)]
    entries = _doc_entries(jparams, docs)
    plain = _specs([8], seed=5)
    eng = JaxServingEngine(jax_tiny_mistral(), jparams, max_batch=2, max_len=64, chunk_size=4,
                           prompt_buckets=(16,))
    reqs = [JaxRequest(input_ids=p, max_new_tokens=MAXNEW, request_id=f"c{i}", doc_cache=e)
            for i, (p, e) in enumerate(zip(prompts, entries))]
    want = _tokens(eng.run(reqs + _requests(plain, JaxRequest)))
    torch_entries = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()), w, None, None)
                     for k, v, w, _, _ in entries]
    return prompts, torch_entries, plain, want


def test_doc_cache_continuation_matches_jax(models, doc_case):
    _, tparams = models
    prompts, entries, plain, want = doc_case
    eng = ServingEngine(tiny_mistral(), tparams, max_batch=2, max_len=64, chunk_size=4,
                        prompt_buckets=(16,), device="cpu")
    reqs = [Request(input_ids=p, max_new_tokens=MAXNEW, request_id=f"c{i}", doc_cache=e)
            for i, (p, e) in enumerate(zip(prompts, entries))]
    assert _tokens(eng.run(reqs + _requests(plain))) == want


def test_prefix_sharing_and_release(models, doc_case):
    """Three concurrent requests on one registered prefix read its pages
    (pinned once) and give the doc-continuation tokens of the JAX engine;
    release_prefix refuses while a request refers to the prefix and frees
    its pages after."""
    _, tparams = models
    prompts, entries, _, want = doc_case
    eng = ServingEngine(tiny_mistral(), tparams, max_batch=3, max_len=64, chunk_size=2,
                        prompt_buckets=(16,), paged=True, page_size=8, pool_pages=16,
                        device="cpu")
    for i, e in enumerate(entries):
        eng.register_prefix(f"doc{i}", e)
    pinned = sum(-(-e[2] // 8) for e in entries)
    assert len(eng._free_pages) == 15 - pinned
    reqs = [Request(input_ids=p, max_new_tokens=MAXNEW, request_id=f"c{i}", prefix=f"doc{i}")
            for i, p in enumerate(prompts)]
    reqs.append(Request(input_ids=prompts[0], max_new_tokens=MAXNEW, request_id="again",
                        prefix="doc0"))
    for r in reqs:
        eng.submit(r)
    with pytest.raises(ValueError, match="still referenced"):
        eng.release_prefix("doc0")
    got = _tokens(eng.run())
    assert got.pop("again") == want["c0"]
    assert got == {k: v for k, v in want.items() if k != "r0"}
    assert len(eng._free_pages) == 15 - pinned
    assert eng.release_prefix("doc0") and not eng.release_prefix("doc0")
    assert len(eng._free_pages) == 15 - pinned + 1


def test_streaming_priority_and_oracle(models):
    """on_token streams every token in order; a higher priority jumps the
    queue (FIFO within a level); tokens match the lockstep oracle."""
    _, tparams = models
    specs = _specs([4, 4, 4], seed=9)
    streams = {}
    eng = _port(tparams, max_batch=1, chunk_size=2, overlap=False,
                on_token=lambda rid, t: streams.setdefault(rid, []).append(t))
    reqs = _requests(specs)
    reqs[2].priority = 5
    done = eng.run(reqs)
    assert [c.request_id for c in done] == ["r2", "r0", "r1"]
    for (rid, ids, n), c in zip(specs, sorted(done, key=lambda c: c.request_id)):
        assert c.token_ids == _oracle(tparams, ids, n) == streams[rid]


def test_cancel_queued_pending_and_inflight(models):
    """cancel() at every stage of a request's life; the survivor of the
    slot churn is token-exact."""
    _, tparams = models
    specs = _specs([5, 7, 6, 4], seed=8)
    reqs = _requests(specs)
    for r, n in zip(reqs, [24, 24, 24, 8]):
        r.max_new_tokens = n
    eng = ServingEngine(tiny_mistral(), tparams, max_batch=1, max_len=64, chunk_size=1,
                        prompt_buckets=(16,), prefill_chunk=4, overlap=False, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.step()  # r0 enters its chunked prefill; r1..r3 queue
    assert eng.cancel("r1")  # queued
    for _ in range(4):
        eng.step()
    assert eng.cancel("r0")  # decoding
    while not eng._pending:
        eng.step()
    assert eng.cancel("r2")  # mid chunked prefill
    while eng.queue or eng.slots or eng._pending or eng._prev is not None:
        eng.step()
    assert not eng.cancel("nope")
    by_id = {c.request_id: c for c in eng.finished}
    assert by_id["r1"].finish_reason == by_id["r2"].finish_reason == "cancelled"
    assert by_id["r1"].token_ids == [] and by_id["r0"].finish_reason == "cancelled"
    assert 0 < len(by_id["r0"].token_ids) < 24
    assert by_id["r3"].token_ids == _oracle(tparams, specs[3][1], 8)


def test_paged_admission_waits_for_pages_and_rejects_oversized(models):
    _, tparams = models
    specs = _specs([4, 6, 5], seed=2)
    eng = _port(tparams, chunk_size=2, paged=True, page_size=8, pool_pages=4, overlap=False)
    done = eng.run(_requests(specs))  # pages for one request at a time
    assert _tokens(done) == {rid: _oracle(tparams, ids, n) for rid, ids, n in specs}
    small = ServingEngine(tiny_mistral(), tparams, max_batch=1, max_len=16,
                          prompt_buckets=(16,), device="cpu")
    with pytest.raises(ValueError, match="exceeds pool max_len"):
        small.submit(Request(input_ids=list(range(12)), max_new_tokens=8))


def test_not_ported_options_raise(models):
    """mesh= still raises NotImplementedError; sampling and speculative
    pools build and serve (tests/test_torch_serving_sampling.py holds their
    tokens), but not together, and a sampled request needs a sampling
    pool. adapters= is ported (test_zero_adapter_pool_serves_base_tokens
    here, tests/test_torch_adapters.py)."""
    _, tparams = models
    with pytest.raises(NotImplementedError, match="mesh"):
        _port(tparams, mesh=object())
    with pytest.raises(ValueError, match="greedy-only"):
        _port(tparams, sampling=True, speculative=True)
    with pytest.raises(ValueError, match="sampling=True"):
        _port(tparams).submit(Request(input_ids=[3, 4], temperature=0.7))
    specs = _specs([5, 7], seed=4)
    (s1, s2) = (_tokens(_port(tparams, sampling=True).run(
        _requests(specs, temperature=0.7, seed=3))) for _ in range(2))
    assert s1 == s2 and all(len(t) >= 1 for t in s1.values())
    spec = _port(tparams, max_len=48, speculative=True, spec_k=3)
    assert _tokens(spec.run(_requests(specs))) == {rid: _oracle(tparams, ids, n)
                                                   for rid, ids, n in specs}


# ---------------------------------------------------------------- the CLI


def _cli_lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_serve_cli_matches_jax(tmp_path):
    """`python -m gritlm_tpu_torch.serve --device cpu` takes the JAX CLI's
    request file and writes its output schema: the same ids, types and keys
    per line, one embedding of the model's width, and the same summary
    keys. (The two CLIs draw their random weights from different generators,
    so their tokens differ; the engines' tokens are held above.)"""
    reqs = tmp_path / "reqs.jsonl"
    rows = [{"id": "g0", "prompt": "<s><|user|>\nHi\n<|assistant|>\n", "max_new_tokens": 4},
            {"id": "g1", "prompt": "<s><|user|>\nName a city\n<|assistant|>\n",
             "priority": 1},
            {"id": "e0", "type": "embed", "text": "a passage to embed",
             "instruction": "<|user|>\nRepresent this\n<|embed|>\n"}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model_preset", "tiny_mistral", "--requests", str(reqs), "--slots", "2",
              "--max_len", "128", "--prompt_buckets", "64", "--max_new_tokens", "3"]
    want_summary = jax_serve.main(common + ["--out", str(tmp_path / "jax.jsonl")])
    proc = subprocess.run([sys.executable, "-m", "gritlm_tpu_torch.serve", *common,
                           "--device", "cpu", "--out", str(tmp_path / "port.jsonl")],
                          cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
    got_summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(got_summary) == sorted(want_summary)
    for key in ("requests", "completions", "embeddings"):
        assert got_summary[key] == want_summary[key]
    want, got = _cli_lines(tmp_path / "jax.jsonl"), _cli_lines(tmp_path / "port.jsonl")
    assert sorted((r["id"], r["type"], sorted(r)) for r in got) == \
           sorted((r["id"], r["type"], sorted(r)) for r in want)
    by_id = {r["id"]: r for r in got}
    assert len(by_id["e0"]["embedding"]) == 64
    assert len(by_id["g0"]["token_ids"]) <= 4 and len(by_id["g1"]["token_ids"]) <= 3
    from gritlm_tpu_torch.serve import main  # --speculative serves the same requests
    spec_summary = main(common + ["--device", "cpu", "--out", str(tmp_path / "x.jsonl"),
                                  "--speculative"])
    assert sorted(spec_summary) == sorted(want_summary)
    assert sorted(r["id"] for r in _cli_lines(tmp_path / "x.jsonl")) == ["e0", "g0", "g1"]


def test_serve_cli_tiny_mixtral(tmp_path):
    """`python -m gritlm_tpu_torch.serve --model_preset tiny_mixtral --device
    cpu` answers a generation and an embedding request."""
    reqs = tmp_path / "reqs.jsonl"
    rows = [{"id": "g0", "prompt": "<s><|user|>\nHi\n<|assistant|>\n", "max_new_tokens": 4},
            {"id": "e0", "type": "embed", "text": "a passage to embed"}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = tmp_path / "done.jsonl"
    proc = subprocess.run([sys.executable, "-m", "gritlm_tpu_torch.serve", "--model_preset",
                           "tiny_mixtral", "--device", "cpu", "--requests", str(reqs), "--out",
                           str(out), "--slots", "2", "--max_len", "128", "--prompt_buckets", "64"],
                          cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (summary["requests"], summary["completions"], summary["embeddings"]) == (2, 1, 1)
    by_id = {r["id"]: r for r in map(json.loads, out.read_text().splitlines())}
    assert 1 <= len(by_id["g0"]["token_ids"]) <= 4
    assert len(by_id["e0"]["embedding"]) == 64


# ---------------------------------------------------------- RAGEngine.serve

PASSAGES = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(6)]
QUERIES = ["what is fact number 3?", "tell me about place 5", "fact number 1?",
           "place 3 again"]


def test_rag_serve_matches_jax(models):
    """Continuous-batching RAG: the JAX engine's retrieved passages and
    answers, through a dense pool and a paged pool with each retrieved
    document pinned once."""
    jparams, tparams = models
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams)
    tm = GritLM(tiny_mistral(), params=tparams, device="cpu")
    je = JaxRAGEngine(jm, max_new_tokens=4, encode_max_length=64)
    te = RAGEngine(tm, max_new_tokens=4, encode_max_length=64)
    je.build_index(PASSAGES, batch_size=4, cache_docs=True)
    te.build_index(PASSAGES, batch_size=4, cache_docs=True)
    kw = dict(slots=3, chunk_size=2, pool_max_len=512, prompt_buckets=(64, 128, 256))
    want = je.serve(QUERIES, **kw)
    for paged in (False, True):
        got = te.serve(QUERIES, paged=paged, page_size=64, **kw)
        assert [r.answer for r in got] == [r.answer for r in want], paged
        assert [r.passages for r in got] == [r.passages for r in want], paged
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)
    # speculative serving gives the same answers; sampled serving answers
    # every query, the same way twice
    got = te.serve(QUERIES, speculative=True, spec_k=3, **kw)
    assert [r.answer for r in got] == [r.answer for r in want]
    sampled = [[r.answer for r in te.serve(QUERIES, temperature=0.5, seed=1, **kw)]
               for _ in range(2)]
    assert sampled[0] == sampled[1] and len(sampled[0]) == len(QUERIES)


def test_zero_adapter_pool_serves_base_tokens(models):
    """ServingEngine(adapters=...) builds and serves: an adapter fresh from
    init_lora (B = 0) leaves every request on the base model's tokens,
    requests on it and on the base side by side (the adapters' own tokens:
    tests/test_torch_adapters.py)."""
    from gritlm_tpu_torch.training.lora import init_lora

    _, tparams = models
    zero, scale = init_lora(tparams, 5, r=4, alpha=8)
    specs = _specs(LENS[:4], seed=6)
    reqs = [Request(input_ids=list(ids), max_new_tokens=n, request_id=rid,
                    adapter="z" if i % 2 else None) for i, (rid, ids, n) in enumerate(specs)]
    done = _port(tparams, adapters={"z": zero}, lora_scale=scale).run(reqs)
    assert _tokens(done) == {rid: _oracle(tparams, ids, n) for rid, ids, n in specs}
