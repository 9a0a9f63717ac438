"""K9 at fp32: the plain version and FlatIndex(dtype=float32) against the JAX
package's fp32 index, and the wrapper's dispatch by dtype.

The JAX retrieval eval builds an fp32 index, and its search runs the Pallas
scores+segmax kernel on fp32 operands; here the JAX side runs that kernel in
interpret mode on the CPU (or its einsum path where its dispatch takes it).
Inputs are made with numpy from seeds.

Tolerances: both sides sum the same exact fp32 products in another order,
so scores agree within 1e-6 on unit vectors of width 64-128; with inputs
whose sums are exact in fp32 they agree bit for bit. Search ids are equal
(no ties in random data).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.index import FlatIndex as JaxFlatIndex
from gritlm_tpu_torch.index import FlatIndex
from gritlm_tpu_torch.ops import _build, scores_segmax as k9


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
    """Multiples of 1/8 in [-1, 1]: every product and every sum of D = 128
    of them is exact in fp32, whatever the order."""
    return np.random.default_rng(seed).integers(-8, 9, size=(n, d)).astype(np.float32) / 8


@pytest.mark.parametrize("values", ["unit", "exact"])
def test_plain_matches_pallas_interpret_fp32(values):
    """The n_docs tail is -inf on both sides; a segment wholly past n_docs
    has a -inf maximum."""
    Q, N, D, n_docs = 8, 2048, 128, 1700
    make = _unit if values == "unit" else _exact
    q, emb = make(Q, D, 1), make(N, D, 2)
    js, jm = JaxFlatIndex(D, N, dtype=np.float32)._pallas_scores_segmax(
        jnp.asarray(q), jnp.asarray(emb), jnp.int32(n_docs), interpret=True)
    js, jm = np.asarray(js), np.asarray(jm)
    ts, tm = k9.scores_segmax(torch.from_numpy(q), torch.from_numpy(emb), n_docs)
    ts, tm = ts.numpy(), tm.numpy()
    assert ts.dtype == np.float32 and ts.shape == js.shape == (Q, N)
    assert tm.shape == jm.shape == (N // 128, Q)
    assert np.isneginf(ts[:, n_docs:]).all() and np.isneginf(js[:, n_docs:]).all()
    assert np.isneginf(tm[-2:]).all() and np.isneginf(jm[-2:]).all()
    if values == "exact":
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
    else:
        np.testing.assert_allclose(ts[:, :n_docs], js[:, :n_docs], atol=1e-6, rtol=0)
        np.testing.assert_allclose(tm, jm, atol=1e-6, rtol=0)


def test_plain_partial_last_segment_fp32():
    """N not a multiple of 128 (the JAX kernel takes only N % 1024 == 0):
    against numpy, the last segment's maximum over its real columns."""
    q, emb = _exact(5, 64, 3), _exact(300, 64, 4)
    s, m = k9.scores_segmax_plain(torch.from_numpy(q), torch.from_numpy(emb), 250)
    want = np.where(np.arange(300) < 250, q @ emb.T, -np.inf)
    np.testing.assert_array_equal(s.numpy(), want)
    np.testing.assert_array_equal(
        m.numpy(), np.stack([want[:, a:a + 128].max(1) for a in (0, 128, 256)]))


# (dim, capacity, n_docs, Q, k): the tiny-corpus branch (ns <= 2k: a global
# sort), the segment-pruned path with the JAX Pallas pass interpreted
# (capacity % 1024 == 0, Q % 8 == 0), a capacity padded to 1024 with n_docs
# far below it, more queries than a block
F32_CASES = {
    "tiny": (16, 50, 50, 4, 5),
    "pruned_pallas": (64, 2048, 1900, 8, 5),
    "mostly_pad": (32, 1024, 300, 6, 3),
    "two_blocks": (32, 1024, 1000, 20, 4),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_fp32_search_matches_jax(case):
    dim, cap, n, Q, k = F32_CASES[case]
    docs, queries = _unit(n, dim, 5), _unit(Q, dim, 6)
    jidx = JaxFlatIndex(dim, cap, dtype=np.float32)
    jidx._search_fn, _ = jidx._make_search(interpret_pallas=True)
    tidx = FlatIndex(dim, cap, dtype=torch.float32, device="cpu")
    if case == "two_blocks":
        tidx.QUERY_BLOCK = 8  # three query blocks, the last partial
    assert tidx.capacity == jidx.capacity and tidx.embeddings.dtype == torch.float32
    jidx.add(docs)
    tidx.add(docs)
    js, ji = jidx.search(queries, k=k)
    ts, ti = tidx.search(queries, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    ref = np.argsort(-(queries @ docs.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ti, ref)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fp32_save_load_across_packages(tmp_path, direction):
    """An fp32 index saved by either package loads in the other, the
    embeddings bit for bit."""
    docs, queries = _unit(70, 16, 9), _unit(3, 16, 10)
    passages = [{"title": f"t{i}", "text": f"d{i}"} for i in range(70)]
    src = (JaxFlatIndex(16, 70, dtype=np.float32) if direction == "jax_to_port"
           else FlatIndex(16, 70, dtype=torch.float32, device="cpu"))
    src.add(docs, passages)
    src.save(str(tmp_path), total_shards=2)
    dst = (FlatIndex.load(str(tmp_path), dtype=torch.float32, device="cpu")
           if direction == "jax_to_port" else JaxFlatIndex.load(str(tmp_path), dtype=np.float32))
    assert dst.n_docs == 70 and dst.passages == passages
    np.testing.assert_array_equal(np.asarray(dst.embeddings[:70], np.float32), docs)
    s1, i1 = src.search(queries, k=4)
    s2, i2 = dst.search(queries, k=4)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-6, rtol=0)


def _cuda_like(t: torch.Tensor):
    """A CPU tensor that reports a CUDA device (the wrapper's dispatch is
    checked without a card; the library is stubbed)."""
    fake = mock.MagicMock(wraps=t)
    fake.device = torch.device("cuda", 0)
    fake.dtype, fake.shape = t.dtype, t.shape
    fake.dim.return_value = t.dim()
    fake.is_contiguous.return_value = True
    fake.data_ptr.return_value = 4096
    return fake


@pytest.mark.parametrize("dtypes,entry", [
    ((torch.float32, torch.float32), "gritlm_scores_segmax_f32"),
    ((torch.bfloat16, torch.bfloat16), "gritlm_scores_segmax"),
    ((torch.float32, torch.bfloat16), None),
    ((torch.bfloat16, torch.float32), None),
    ((torch.float16, torch.float16), None),
])
def test_dispatch_by_dtype(monkeypatch, dtypes, entry):
    """Both fp32 -> the fp32 entry (f32_launches), both bf16 -> the bf16
    entry (launches); mixed or fp16 raise TypeError before any launch."""
    lib = mock.MagicMock()
    for name in ("gritlm_scores_segmax", "gritlm_scores_segmax_f32"):
        fn = getattr(lib, name)
        fn.argtypes = None
        fn.return_value = 0
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: real_empty(*a, **kw))
    q = _cuda_like(torch.zeros((3, 64), dtype=dtypes[0]))
    emb = _cuda_like(torch.zeros((300, 64), dtype=dtypes[1]))
    before = (k9.scores_segmax.launches, k9.scores_segmax.f32_launches)
    if entry is None:
        with pytest.raises(TypeError, match="both bfloat16 or both float32"):
            k9.scores_segmax(q, emb, 250)
        assert not lib.gritlm_scores_segmax.called and not lib.gritlm_scores_segmax_f32.called
        assert (k9.scores_segmax.launches, k9.scores_segmax.f32_launches) == before
        return
    scores, segmax = k9.scores_segmax(q, emb, 250)
    other = ({"gritlm_scores_segmax", "gritlm_scores_segmax_f32"} - {entry}).pop()
    assert getattr(lib, entry).call_count == 1 and not getattr(lib, other).called
    args = getattr(lib, entry).call_args[0]
    assert args[4:8] == (3, 300, 64, 250)
    assert scores.shape == (3, 300) and segmax.shape == (3, 3)
    f32 = entry.endswith("f32")
    assert k9.scores_segmax.f32_launches == before[1] + f32
    assert k9.scores_segmax.launches == before[0] + (not f32)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 66), (torch.bfloat16, 68)])
def test_dispatch_rejects_depth(monkeypatch, dtype, D):
    """16-byte rows: D % 4 for fp32, D % 8 for bf16."""
    lib = mock.MagicMock()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    q = _cuda_like(torch.zeros((3, D), dtype=dtype))
    emb = _cuda_like(torch.zeros((300, D), dtype=dtype))
    with pytest.raises(NotImplementedError, match="D %"):
        k9.scores_segmax(q, emb, 250)
