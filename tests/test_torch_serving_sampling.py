"""The port's serving sampling and speculative verify pool
(gritlm_tpu_torch.serving), the two CLIs' --speculative runs and
RAGEngine.serve with sampling, against the JAX package on tiny_mistral.

Both packages get the same weights (`params_from_jax`) and requests and run
float32 on the CPU (the port's kernels as their plain versions).
  - Greedy and speculative streams are held token-exact: against the port's
    own lockstep `generate` (which tests/test_torch_model.py holds to the JAX
    package) and against the JAX engine.
  - Sampled streams cannot be: the JAX package draws with threefry keys
    folded per token, the port with threefry2x32 at counter (token index,
    vocab index) (`serving._sample_rows`). They are held to what a
    counter-based generator promises: a request's tokens do not depend on
    its schedule, its pool's layout or chunked prefill; another seed moves
    them; top_k=1 is greedy; and the first draws over 4000 seeds follow
    softmax(filtered logits / T) (a chi-square test, p >= 1e-3). The block
    function itself is held bit for bit against JAX's threefry_2x32.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import gritlm_tpu.rag.eval as jax_eval
import gritlm_tpu.serve as jax_serve
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.generate import nucleus_filter as jax_nucleus_filter
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import forward as jax_forward
from gritlm_tpu.models.transformer import init_cache as jax_init_cache
from gritlm_tpu.rag import RAGEngine as JaxRAGEngine
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu_torch import GritLM, serving
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.generate import generate, make_cache_for_prompt, nucleus_filter
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.models.transformer import forward, init_params, logits_from_hidden
from gritlm_tpu_torch.rag import RAGEngine
from gritlm_tpu_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
MAXNEW = 8
CHI2_P_MIN = 1e-3  # the least p-value of the distribution test's chi-square


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return jparams, tparams


def _specs(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(3, 512, size=n).tolist()) for i, n in enumerate(lens)]


def _requests(specs, cls=Request, **kw):
    return [cls(input_ids=list(ids), max_new_tokens=MAXNEW, request_id=rid, **kw)
            for rid, ids in specs]


def _sampled(seed_base=100):
    """Five sampled requests: T 1.0, top_p 0.9, seeds seed_base + i."""
    return [Request(input_ids=ids, max_new_tokens=MAXNEW, request_id=rid, temperature=1.0,
                    top_p=0.9, seed=seed_base + i)
            for i, (rid, ids) in enumerate(_specs([5, 9, 4, 11, 7], seed=7))]


def _tokens(done):
    return {c.request_id: list(c.token_ids) for c in done}


def _port(tparams, **kw):
    return ServingEngine(tiny_mistral(), tparams, device="cpu", **kw)


def _oracle(tparams, ids, max_new=MAXNEW):
    """The port's lockstep greedy generate, one request alone."""
    cfg = tiny_mistral()
    arr = torch.tensor([ids], dtype=torch.int32)
    res = generate(tparams, cfg, arr, torch.ones_like(arr),
                   make_cache_for_prompt(cfg, 1, len(ids), max_new, device="cpu"),
                   max_new_tokens=max_new, eos_id=2, pad_id=2)
    return res.tokens[0, :int(res.num_valid[0])].tolist()


def _check_oracle(tparams, done, specs):
    got = _tokens(done)
    assert sorted(got) == sorted(rid for rid, _ in specs)
    for rid, ids in specs:
        assert got[rid] == _oracle(tparams, ids), rid


# ---------------------------------------------------------------- sampling


def test_threefry_matches_jax():
    """serving.threefry2x32 bit for bit against JAX's threefry_2x32 over
    random keys and counters (the block function of the port's sampler)."""
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    for _ in range(4):
        key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2**32, (2, 257), dtype=np.uint64).astype(np.uint32)
        want = np.asarray(threefry_2x32((jnp.uint32(key[0]), jnp.uint32(key[1])),
                                        jnp.asarray(x.reshape(-1))))
        y0, y1 = serving.threefry2x32(int(key[0]), int(key[1]),
                                      torch.from_numpy(x[0].astype(np.int64)),
                                      torch.from_numpy(x[1].astype(np.int64)))
        np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                                      want.astype(np.int64))


def test_sampling_pool_greedy_rows_exact(models):
    """temperature 0 rows in a sampling pool stay exactly greedy."""
    _, tparams = models
    specs = _specs([3, 9, 5, 12])
    eng = _port(tparams, max_batch=2, max_len=64, chunk_size=4, prompt_buckets=(16,),
                sampling=True)
    _check_oracle(tparams, eng.run(_requests(specs)), specs)


def test_sampling_requires_flag(models):
    _, tparams = models
    eng = _port(tparams, max_batch=1, max_len=32, prompt_buckets=(16,))
    with pytest.raises(ValueError, match="sampling=True"):
        eng.submit(Request(input_ids=[3, 4], temperature=0.7))


@pytest.fixture(scope="module")
def sampled_streams(models):
    """The five sampled requests through a tight strict pool of one-step
    chunks: the reference streams of the schedule tests."""
    _, tparams = models
    eng = _port(tparams, max_batch=2, max_len=64, chunk_size=1, prompt_buckets=(16,),
                overlap=False, sampling=True)
    return _tokens(eng.run(_sampled()))


@pytest.mark.parametrize("schedule", ["wide_pipelined", "alone", "paged", "chunked_prefill"])
def test_sampling_schedule_invariant(models, sampled_streams, schedule):
    """The same sampled requests give the same tokens under very different
    schedules: a wide pool of 4-step chunks, overlapped; each request alone
    in its own engine; a paged pool; chunked prefill (the first token drawn
    off the last chunk)."""
    _, tparams = models
    kw = dict(max_len=64, prompt_buckets=(16,), sampling=True)
    if schedule == "alone":
        got = {}
        for r in _sampled():
            got.update(_tokens(_port(tparams, max_batch=1, chunk_size=2, **kw).run([r])))
    else:
        extra = {"wide_pipelined": dict(max_batch=4, chunk_size=4, overlap=True),
                 "paged": dict(max_batch=3, chunk_size=2, paged=True, page_size=8,
                               pool_pages=25),
                 "chunked_prefill": dict(max_batch=2, chunk_size=2, prefill_chunk=4)}[schedule]
        got = _tokens(_port(tparams, **extra, **kw).run(_sampled()))
    assert got == sampled_streams
    assert all(len(t) == MAXNEW or t[-1] == 2 for t in got.values())


def test_sampling_seed_moves_streams(models, sampled_streams):
    """Deterministic in the seed, but stochastic: other seeds move at least
    one stream; the same seeds reproduce them."""
    _, tparams = models
    eng = _port(tparams, max_batch=4, max_len=64, chunk_size=4, prompt_buckets=(16,),
                sampling=True)
    assert _tokens(eng.run(_sampled(seed_base=1100))) != sampled_streams
    assert _tokens(eng.run(_sampled())) == sampled_streams


def test_sampling_topk1_is_greedy(models):
    """top_k=1 at any temperature is the argmax: the filters' thresholds
    against the greedy oracle."""
    _, tparams = models
    specs = _specs([6, 10, 4])
    eng = _port(tparams, max_batch=3, max_len=64, chunk_size=4, prompt_buckets=(16,),
                sampling=True)
    _check_oracle(tparams, eng.run(_requests(specs, temperature=3.0, top_k=1, seed=7)), specs)


def _spread_model(V=16):
    """tiny_mistral(vocab_size=16) with its LM head scaled so the logits of
    a prompt spread over about 1.5 logit units (random weights give near
    uniform ones): returns those [V] float32 logits."""
    cfg = tiny_mistral(vocab_size=V)
    params = init_params(cfg, seed=3, device="cpu")
    ids = torch.tensor([[5, 9, 3, 12, 7, 1]], dtype=torch.int32)
    hidden, _, _ = forward(params, cfg, ids, causal=True)
    logits = logits_from_hidden(params, cfg, hidden[:, -1:])[0, 0].float()
    return logits * (1.5 / logits.std())


def _filtered_probs(logits, T, top_k, top_p):
    """softmax(filtered logits / T) in float64, the filter computed apart
    from the port: top-k and the nucleus by value."""
    lg = logits.double().numpy() / T
    order = np.sort(lg)[::-1]
    keep = np.ones_like(lg, bool)
    if top_k:
        keep &= lg >= order[top_k - 1]
    if top_p < 1.0:
        p = np.exp(order - order.max())
        cum = np.cumsum(p / p.sum())
        keep &= lg >= order[min(int((cum < top_p).sum()), len(lg) - 1)]
    p = np.where(keep, np.exp(lg - lg.max()), 0.0)
    return p / p.sum()


@pytest.mark.parametrize("T,top_k,top_p", [(0.7, 0, 1.0), (0.7, 0, 0.9), (0.7, 5, 1.0),
                                           (1.0, 5, 0.9)])
def test_sampling_distribution(T, top_k, top_p):
    """The first draw (index 0, as a prefill takes it) of 4000 requests with
    seeds 0..3999 over the same logits: no filtered-out token is drawn, and
    the frequencies pass a chi-square test against softmax(filtered logits
    / T) at p >= CHI2_P_MIN."""
    logits = _spread_model()
    V, n = logits.shape[0], 4000
    samp = serving._samp_init(n, "cpu")
    samp.temps.fill_(T)
    samp.top_k.fill_(top_k)
    samp.top_p.fill_(top_p)
    samp.keys.copy_(torch.tensor([serving._seed_key(s) for s in range(n)]))
    draws = serving._sample_rows(logits[None].expand(n, V), samp).numpy()
    want = _filtered_probs(logits, T, top_k, top_p)
    counts = np.bincount(draws, minlength=V)
    assert counts[want == 0].sum() == 0
    kept = want > 0
    assert kept.sum() >= 3
    p = stats.chisquare(counts[kept], want[kept] * n).pvalue
    assert p >= CHI2_P_MIN, (counts, want * n, p)


def test_nucleus_kept_set_matches_jax():
    """generate.nucleus_filter and the sampler's top-p filter keep the JAX
    nucleus_filter's set at top_p 0.9 (never compared near top_p 1: the
    fp32 cumsum sums in another order there)."""
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(6, 512)) * 2).astype(np.float32)
    want = np.isfinite(np.asarray(jax_nucleus_filter(jnp.asarray(logits), 0.9)))
    got = torch.isfinite(nucleus_filter(torch.from_numpy(logits), 0.9)).numpy()
    np.testing.assert_array_equal(got, want)
    samp = serving._samp_init(6, "cpu")
    samp.temps.fill_(1.0)
    samp.top_p.fill_(0.9)
    kept = np.zeros_like(want)
    for s in range(400):  # draws only ever land in the kept set, and cover it
        samp.keys[:, 1] = s
        kept[np.arange(6), serving._sample_rows(torch.from_numpy(logits), samp).numpy()] = True
    assert not (kept & ~want).any()


@pytest.mark.parametrize("fn", ["_decode_chunk_program", "_spec_chunk_program", "_sample_rows",
                                "_gumbel", "threefry2x32", "_lookup_proposals", "_accept",
                                "_router", "_moe_mlp", "_moe_mlp_dense", "_moe_mlp_dropless",
                                "_moe_mlp_gshard"])
def test_chunk_programs_have_no_host_sync(fn):
    """The decode and verify chunks (and what they call per step, the MoE
    layer of a Mixtral trunk too) never read the device from the host: no
    .item(), .cpu(), .tolist() or .numpy(), so a chunk queues its steps
    without waiting (and a CUDA graph could capture it)."""
    import inspect

    from gritlm_tpu_torch import spec_decode
    from gritlm_tpu_torch.models import transformer

    mod = next(m for m in (serving, spec_decode, transformer) if hasattr(m, fn))
    src = inspect.getsource(getattr(mod, fn))
    for call in (".item(", ".cpu(", ".tolist(", ".numpy("):
        assert call not in src, (fn, call)


# ---------------------------------------------------------------- speculative pools


def _jax_spec(jparams, specs, **kw):
    eng = JaxServingEngine(jax_tiny_mistral(), jparams, speculative=True, spec_ngram=2,
                           spec_k=3, **kw)
    return _tokens(eng.run(_requests(specs, JaxRequest)))


SPEC_POOLS = {
    "dense": dict(max_batch=3, max_len=64, chunk_size=2, prompt_buckets=(16,)),
    "paged": dict(max_batch=3, max_len=64, chunk_size=2, prompt_buckets=(16,), paged=True,
                  page_size=8, pool_pages=30),
    "int8": dict(max_batch=2, max_len=64, chunk_size=2, prompt_buckets=(16,), kv_quant=True),
    "chunked_prefill": dict(max_batch=2, max_len=64, chunk_size=2, prompt_buckets=(16,),
                            prefill_chunk=4),
}


@pytest.mark.parametrize("pool", list(SPEC_POOLS))
def test_speculative_pool_matches_jax(models, pool):
    """Ragged requests (slots reused) through the verify pool: the JAX
    speculative engine's tokens, and (float32 pools) the solo greedy
    oracle's; verify chunks straddle pages in the paged pool."""
    jparams, tparams = models
    specs = _specs([3, 9, 5, 12, 7, 4], seed=9 if pool == "int8" else 0)
    kw = SPEC_POOLS[pool]
    eng = _port(tparams, speculative=True, spec_ngram=2, spec_k=3, **kw)
    done = eng.run(_requests(specs))
    assert _tokens(done) == _jax_spec(jparams, specs, **kw)
    if pool != "int8":
        _check_oracle(tparams, done, specs)


def test_speculative_pool_accepts_on_repetitive_prompts(models):
    """Repetitive prompts give the lookup real hits: still the oracle's
    tokens, and fewer verify steps than a greedy pool's decode steps (16
    tokens a row need 15 after the prefill's)."""
    _, tparams = models
    specs = [("rep0", [5, 11, 23, 7] * 4), ("rep1", [9, 13] * 6)]
    eng = _port(tparams, max_batch=2, max_len=96, chunk_size=1, prompt_buckets=(16,),
                speculative=True, spec_ngram=2, spec_k=4)
    done = eng.run([Request(input_ids=ids, max_new_tokens=16, request_id=rid)
                    for rid, ids in specs])
    got = _tokens(done)
    for rid, ids in specs:
        assert got[rid] == _oracle(tparams, ids, 16)
    assert eng._steps < 15, eng._steps


def _doc_entry(jparams, doc):
    """A doc-store entry (k, v, w, None, None) by causal prefill in the JAX
    package: numpy for the JAX engine, torch for the port."""
    cache = jax_init_cache(jax_tiny_mistral(), 1, len(doc))
    _, cache, _ = jax_forward(jparams, jax_tiny_mistral(), jnp.asarray([doc], jnp.int32),
                              causal=True, cache=cache)
    k, v = np.asarray(cache.k[:, 0]), np.asarray(cache.v[:, 0])
    return (k, v, len(doc), None, None), (torch.from_numpy(k.copy()),
                                          torch.from_numpy(v.copy()), len(doc), None, None)


def test_speculative_doc_cache_continuation(models):
    """A doc-cache continuation row decodes speculatively with the document's
    tokens as its lookup corpus: the JAX engine's tokens and the oracle's
    over document + prompt."""
    jparams, tparams = models
    rng = np.random.default_rng(11)
    doc = rng.integers(3, 512, size=9).tolist()
    prompt = rng.integers(3, 512, size=5).tolist()
    jentry, tentry = _doc_entry(jparams, doc)
    kw = dict(max_batch=1, max_len=64, chunk_size=2, prompt_buckets=(16,), speculative=True,
              spec_ngram=2, spec_k=3)
    (want,) = JaxServingEngine(jax_tiny_mistral(), jparams, **kw).run(
        [JaxRequest(input_ids=prompt, max_new_tokens=MAXNEW, request_id="d",
                    doc_cache=jentry, hist_ids=doc)])
    (got,) = _port(tparams, **kw).run([Request(input_ids=prompt, max_new_tokens=MAXNEW,
                                               request_id="d", doc_cache=tentry,
                                               hist_ids=doc)])
    assert got.token_ids == want.token_ids == _oracle(tparams, doc + prompt)


def test_speculative_prefix_sharing(models):
    """Speculation over zero-copy prefix pages: three requests share one
    pinned document's pages, seed their lookup corpus with its tokens, and
    give the JAX engine's tokens and the full-prompt oracle's."""
    jparams, tparams = models
    rng = np.random.default_rng(13)
    doc = rng.integers(3, 512, size=11).tolist()
    prompts = [rng.integers(3, 512, size=n).tolist() for n in (4, 7, 5)]
    jentry, tentry = _doc_entry(jparams, doc)
    kw = dict(max_batch=2, max_len=96, chunk_size=2, prompt_buckets=(16,), paged=True,
              page_size=16, pool_pages=24, speculative=True, spec_ngram=2, spec_k=3)
    jeng = JaxServingEngine(jax_tiny_mistral(), jparams, **kw)
    jeng.register_prefix("doc", jentry)
    want = _tokens(jeng.run([JaxRequest(input_ids=p, max_new_tokens=MAXNEW, request_id=f"p{i}",
                                        prefix="doc", hist_ids=doc)
                             for i, p in enumerate(prompts)]))
    eng = _port(tparams, **kw)
    eng.register_prefix("doc", tentry)
    got = _tokens(eng.run([Request(input_ids=p, max_new_tokens=MAXNEW, request_id=f"p{i}",
                                   prefix="doc", hist_ids=doc)
                           for i, p in enumerate(prompts)]))
    assert got == want
    for i, p in enumerate(prompts):
        assert got[f"p{i}"] == _oracle(tparams, doc + p)


def test_speculative_rejects_sampling_and_reserves_slack(models):
    """Speculative pools are greedy-only, and a request's room includes the
    verify chunk's spec_k slots (in pages too)."""
    _, tparams = models
    with pytest.raises(ValueError, match="greedy-only"):
        _port(tparams, max_batch=1, max_len=64, sampling=True, speculative=True)
    eng = _port(tparams, max_batch=1, max_len=32, prompt_buckets=(16,), speculative=True,
                spec_k=7)
    with pytest.raises(ValueError, match="exceeds pool max_len"):
        eng.submit(Request(input_ids=list(range(3, 15)), max_new_tokens=16))
    paged = _port(tparams, max_batch=1, max_len=64, prompt_buckets=(16,), paged=True,
                  page_size=8, speculative=True, spec_k=7)
    assert paged._pages_needed(Request(input_ids=[3] * 5, max_new_tokens=8)) == 4


# ---------------------------------------------------------------- RAGEngine.serve


@pytest.fixture(scope="module")
def rag(models):
    jparams, tparams = models
    passages = [{"title": "geo", "text": f"fact number {i} about place {i}"} for i in range(6)]
    je = JaxRAGEngine(JaxGritLM(jax_tiny_mistral(), params=jparams), max_new_tokens=6,
                      encode_max_length=64)
    te = RAGEngine(GritLM(tiny_mistral(), params=tparams, device="cpu"), max_new_tokens=6,
                   encode_max_length=64)
    je.build_index(passages, batch_size=4, cache_docs=True)
    te.build_index(passages, batch_size=4, cache_docs=True)
    return je, te


QS = ["what is fact number 2?", "tell me about place 5", "place 3 again"]
RAG_KW = dict(max_new_tokens=6, pool_max_len=512, prompt_buckets=(64, 128, 256))


def test_rag_serve_speculative_matches_jax(rag):
    """RAGEngine.serve(speculative=True), dense and paged, with each
    retrieved passage's tokens as the lookup corpus: the plain serve's
    answers and the JAX speculative serve's."""
    je, te = rag
    want = [r.answer for r in je.serve(QS, slots=2, chunk_size=2, speculative=True, spec_k=3,
                                       **RAG_KW)]
    plain = [r.answer for r in te.serve(QS, slots=2, chunk_size=2, **RAG_KW)]
    for paged in (False, True):
        got = [r.answer for r in te.serve(QS, slots=2, chunk_size=2, speculative=True,
                                          spec_k=3, paged=paged, page_size=64, **RAG_KW)]
        assert got == want == plain, paged


def test_rag_serve_sampling_deterministic(rag):
    """serve(temperature > 0): query i draws with seed + i, so sampled
    answers are fixed by the seed across pool sizes, chunk sizes and pool
    layouts."""
    _, te = rag
    kw = dict(temperature=0.8, top_p=0.9, seed=123, **RAG_KW)
    a = [r.answer for r in te.serve(QS, slots=2, chunk_size=2, **kw)]
    assert a == [r.answer for r in te.serve(QS, slots=1, chunk_size=4, **kw)]
    assert a == [r.answer for r in te.serve(QS, slots=3, chunk_size=1, paged=True,
                                            page_size=64, **kw)]


# ---------------------------------------------------------------- the CLIs


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_serve_cli_speculative_and_sampled_schema(tmp_path):
    """`python -m gritlm_tpu_torch.serve --speculative` takes the JAX CLI's
    request file and writes its output schema (ids, types, keys per line,
    summary keys); a run with sampled requests (temperature, top_k, top_p,
    seed) does too, and the same seeds give the same tokens twice."""
    reqs = tmp_path / "reqs.jsonl"
    rows = [{"id": "g0", "prompt": "<s><|user|>\nHi Hi Hi Hi\n<|assistant|>\n",
             "max_new_tokens": 4},
            {"id": "g1", "prompt": "<s><|user|>\nName a city\n<|assistant|>\n"}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    sampled = tmp_path / "sampled.jsonl"
    srows = [dict(r, temperature=0.8, top_k=20, top_p=0.9, seed=5 + i)
             for i, r in enumerate(rows)]
    sampled.write_text("".join(json.dumps(r) + "\n" for r in srows))
    common = ["--model_preset", "tiny_mistral", "--slots", "2", "--max_len", "128",
              "--prompt_buckets", "64", "--max_new_tokens", "3"]
    spec = ["--speculative", "--spec_k", "3", "--spec_ngram", "2"]
    want_summary = jax_serve.main(common + spec + ["--requests", str(reqs), "--out",
                                                   str(tmp_path / "jax.jsonl")])
    got_tokens = []
    for name, extra, req_file in (("spec", spec, reqs), ("s1", [], sampled),
                                  ("s2", [], sampled)):
        proc = subprocess.run([sys.executable, "-m", "gritlm_tpu_torch.serve", *common, *extra,
                               "--requests", str(req_file), "--device", "cpu", "--out",
                               str(tmp_path / f"{name}.jsonl")],
                              cwd=ROOT, check=True, capture_output=True, text=True, timeout=300)
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert sorted(summary) == sorted(want_summary)
        got = _lines(tmp_path / f"{name}.jsonl")
        want = _lines(tmp_path / "jax.jsonl")
        assert sorted((r["id"], r["type"], sorted(r)) for r in got) == \
               sorted((r["id"], r["type"], sorted(r)) for r in want)
        got_tokens.append({r["id"]: r["token_ids"] for r in got})
    assert got_tokens[1] == got_tokens[2]


def test_rag_eval_cli_speculative_schema(tmp_path):
    """`python -m gritlm_tpu_torch.rag.eval --speculative` writes the JAX
    CLI's files with the same JSON keys, and the predictions of the port's
    run without it (greedy either way; --speculative sets min_new_tokens 0,
    so the plain run is given 0)."""
    passages = tmp_path / "passages.jsonl"
    passages.write_text("".join(json.dumps({"id": str(i), "title": "geo",
                                            "text": f"fact number {i} about place {i}"}) + "\n"
                                for i in range(6)))
    qa = tmp_path / "qa.jsonl"
    qa.write_text("".join(json.dumps({"question": f"what is fact number {i}?",
                                      "answers": [f"place {i}"]}) + "\n" for i in range(3)))
    common = ["--model_preset", "tiny_mistral", "--passages", str(passages), "--eval_data",
              str(qa), "--cache", "doc", "--max_new_tokens", "4", "--max_length", "64",
              "--speculative", "--spec_k", "3", "--spec_ngram", "2", "--min_new_tokens", "2"]
    jax_eval.main(common + ["--save_dir", str(tmp_path / "jax")])
    for name, argv in (("port", common), ("plain", common[:-7] + ["--min_new_tokens", "0"])):
        subprocess.run([sys.executable, "-m", "gritlm_tpu_torch.rag.eval", *argv, "--device",
                        "cpu", "--save_dir", str(tmp_path / name)],
                       cwd=ROOT, check=True, capture_output=True, timeout=300)

    def files(d):
        return {p.name: json.loads(p.read_text()) for p in sorted(d.glob("*.json"))}

    want, got, plain = files(tmp_path / "jax"), files(tmp_path / "port"), files(tmp_path / "plain")
    assert {n: sorted(v) for n, v in got.items()} == {n: sorted(v) for n, v in want.items()}
    assert len(got) == 1 and list(got) == list(plain)
    (metrics,), (plain_metrics,) = got.values(), plain.values()
    assert metrics["predictions"] == plain_metrics["predictions"]
