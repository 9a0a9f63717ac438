"""The port's FlatIndex and K9's plain version against the JAX package.

Inputs are made with numpy from seeds and handed to both packages; the JAX
side runs its Pallas scores+segmax kernel in interpret mode on the CPU.

Tolerances: both sides sum the same exact bf16 products in fp32 in another
order, so scores agree within 1e-5 on unit vectors; with inputs whose sums
are exact in fp32 they agree bit for bit. Search ids are equal (no ties in
random data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.index import FlatIndex as JaxFlatIndex
from gritlm_tpu_torch.index import FlatIndex
from gritlm_tpu_torch.index.flat import load_passages_jsonl
from gritlm_tpu_torch.ops.scores_segmax import scores_segmax, scores_segmax_plain


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _exact(n, d, seed):
    """Multiples of 1/4 in [-0.5, 0.5]: every product and sum of D = 128 of
    them is exact in bf16 inputs and fp32 sums, whatever the order."""
    return np.random.default_rng(seed).integers(-2, 3, size=(n, d)).astype(np.float32) / 4


@pytest.mark.parametrize("values", ["unit", "exact"])
def test_scores_segmax_plain_matches_pallas_interpret(values):
    Q, N, D, n_docs = 16, 2048, 128, 1900
    make = _unit if values == "unit" else _exact
    q, emb = make(Q, D, 1), make(N, D, 2)
    jidx = JaxFlatIndex(D, N)
    js, jm = jidx._pallas_scores_segmax(jnp.asarray(q, jnp.bfloat16),
                                        jnp.asarray(emb, jnp.bfloat16),
                                        jnp.int32(n_docs), interpret=True)
    js, jm = np.asarray(js), np.asarray(jm)
    ts, tm = scores_segmax(torch.from_numpy(q).bfloat16(), torch.from_numpy(emb).bfloat16(),
                           n_docs)
    ts, tm = ts.numpy(), tm.numpy()
    assert ts.shape == js.shape == (Q, N) and tm.shape == jm.shape == (N // 128, Q)
    assert np.isneginf(ts[:, n_docs:]).all() and np.isneginf(js[:, n_docs:]).all()
    if values == "exact":
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
    else:
        np.testing.assert_allclose(ts[:, :n_docs], js[:, :n_docs], atol=1e-5, rtol=0)
        np.testing.assert_allclose(tm, jm, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(
            ts[:, :n_docs].reshape(Q, -1)[:, :1792].reshape(Q, 14, 128).argmax(-1),
            js[:, :n_docs].reshape(Q, -1)[:, :1792].reshape(Q, 14, 128).argmax(-1))


def test_scores_segmax_partial_last_segment():
    """N not a multiple of 128: the last segment's maximum is over its real
    columns; a segment wholly past n_docs is -inf."""
    q, emb = _unit(3, 32, 3), _unit(300, 32, 4)
    s, m = scores_segmax_plain(torch.from_numpy(q), torch.from_numpy(emb), 200)
    assert m.shape == (3, 3)
    want = np.where(np.arange(300) < 200, q @ emb.T, -np.inf)
    np.testing.assert_allclose(s.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(m[:2].numpy(), [want[:, :128].max(1), want[:, 128:256].max(1)],
                               atol=1e-6)
    assert np.isneginf(m[2].numpy()).all()


# (dim, capacity, pad_to, n_docs, Q, k): a tiny corpus (global sort); the
# segment-pruned path; a capacity that is not a segment multiple (the -inf
# pad); Q not a multiple of 8; n_docs < k
SEARCH_CASES = {
    "tiny": (16, 50, 1024, 50, 4, 5),
    "pruned": (32, 2048, 1024, 1900, 8, 5),
    "pad_to_64": (16, 570, 64, 570, 5, 2),
    "odd_q": (32, 1024, 1024, 1000, 3, 4),
    "n_docs_below_k": (16, 3, 1024, 3, 2, 10),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_search_matches_jax(case, mode):
    dim, cap, pad_to, n, Q, k = SEARCH_CASES[case]
    docs, queries = _unit(n, dim, 5), _unit(Q, dim, 6)
    jidx = JaxFlatIndex(dim, cap, pad_to=pad_to)
    # the JAX search takes its Pallas pass (interpreted) where its dispatch
    # allows (capacity % 1024 == 0 and Q % 8 == 0), else its einsum path
    jidx._search_fn, _ = jidx._make_search(interpret_pallas=True)
    tidx = FlatIndex(dim, cap, pad_to=pad_to, device="cpu")
    assert tidx.capacity == jidx.capacity
    for a in range(0, n, 37):  # several adds, written in place
        jidx.add(docs[a:a + 37])
        tidx.add(docs[a:a + 37])
    js, ji = jidx.search(queries, k=k, mode=mode)
    ts, ti = tidx.search(queries, k=k, mode=mode)
    assert ts.shape == ti.shape == (Q, min(k, n)) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    if mode == "approx":  # approx is the exact search, on both sides
        for idx, (s, i) in ((jidx, (js, ji)), (tidx, (ts, ti))):
            es, ei = idx.search(queries, k=k, mode="exact")
            np.testing.assert_array_equal(i, ei)
            np.testing.assert_array_equal(s, es)
    # a torch tensor already on the index's device is taken where it lies
    ts2, ti2 = tidx.search(torch.from_numpy(queries), k=k, mode=mode)
    np.testing.assert_array_equal(ti2, ti)
    np.testing.assert_array_equal(ts2, ts)


def test_search_many_query_blocks():
    """More queries than QUERY_BLOCK: blocks are searched in turn."""
    docs, queries = _unit(300, 16, 7), _unit(21, 16, 8)
    tidx = FlatIndex(16, 300, device="cpu", dtype=torch.float32)
    tidx.QUERY_BLOCK = 8
    tidx.add(docs)
    ts, ti = tidx.search(queries, k=3)
    ref = np.argsort(-(queries @ docs.T), axis=1)[:, :3]
    np.testing.assert_array_equal(ti, ref)
    np.testing.assert_allclose(ts, np.take_along_axis(queries @ docs.T, ref, 1), atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    docs, queries = _unit(60, 16, 9), _unit(4, 16, 10)
    passages = [{"title": f"t{i}", "text": f"d{i}"} for i in range(60)]
    src = (JaxFlatIndex(16, 60) if direction == "jax_to_port"
           else FlatIndex(16, 60, device="cpu"))
    src.add(docs, passages)
    src.save(str(tmp_path), total_shards=3)
    dst = (FlatIndex.load(str(tmp_path), device="cpu") if direction == "jax_to_port"
           else JaxFlatIndex.load(str(tmp_path)))
    assert dst.n_docs == 60 and dst.passages == passages
    s1, i1 = src.search(queries, k=5)
    s2, i2 = dst.search(queries, k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5, rtol=0)


def test_search_passages_and_overflow(tmp_path):
    docs = _unit(50, 16, 11)
    idx = FlatIndex(16, 50, dtype=torch.float32, device="cpu")
    idx.add(docs, [{"text": f"doc {i}", "title": f"t{i}"} for i in range(50)])
    docs_out, scores = idx.search_passages(docs[:2], k=3)
    assert [d[0]["text"] for d in docs_out] == ["doc 0", "doc 1"]
    assert scores.shape == (2, 3)
    small = FlatIndex(8, 10, pad_to=8, device="cpu")
    with pytest.raises(ValueError, match="Index full"):
        small.add(_unit(32, 8, 12))
    with pytest.raises(NotImplementedError):
        FlatIndex(8, 10, mesh=object(), device="cpu")
    path = tmp_path / "p.jsonl"
    path.write_text('{"text": "a"}\n\n{"text": "b"}\n{"text": "c"}\n')
    assert load_passages_jsonl(str(path), max_passages=2) == [{"text": "a"}, {"text": "b"}]


def test_index_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8, 10)
