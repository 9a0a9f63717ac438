"""K8 (paged decode attention) and the transformer's per-row cache path
against the JAX package.

Inputs are made from a seed with numpy and fed to both sides. The JAX side
runs `paged_decode` as its own tests do on the CPU: its Pallas kernel in
interpret mode at the kernel-legal geometry (Kv*Dh = 128, page 128) and its
gather path at tiny_mistral's Dh 16. The port runs CPU tensors, so
`paged_decode` takes its plain version.

Tolerances: float32 on both sides differs only in the order of sums (5e-5
on values of order 1). bf16 and int8 pages: 2e-2, as the JAX package's own
paged tests hold its kernel (its kernel rounds P, or P times the V scale,
to bf16 before P.V; the port's plain version keeps fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import KVCache as JaxKVCache
from gritlm_tpu.models.transformer import PagedKVCache as JaxPagedKVCache
from gritlm_tpu.models.transformer import forward as jax_forward
from gritlm_tpu.ops.paged_attention import paged_decode as jax_paged_decode
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.models.transformer import (
    KVCache,
    PagedKVCache,
    forward,
    init_paged_cache,
    quantize_kv,
)
from gritlm_tpu_torch.ops import decode_attention, paged_attention

ATOL = 5e-5
LOW_ATOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _paged_from_logical(k_log, v_log, page, rng):
    """Scatter logical [L, B, Smax, KD] K/V over a shuffled physical pool
    with a few spare garbage pages; returns (k_pages, v_pages, page_table)."""
    L, B, Smax, KD = k_log.shape
    maxp = Smax // page
    n_pages = B * maxp + 3
    pt = rng.permutation(n_pages)[: B * maxp].reshape(B, maxp).astype(np.int32)
    k_pages = rng.normal(size=(L, n_pages, page, KD)).astype(np.float32)
    v_pages = rng.normal(size=(L, n_pages, page, KD)).astype(np.float32)
    for b in range(B):
        for i in range(maxp):
            k_pages[:, pt[b, i]] = k_log[:, b, i * page:(i + 1) * page]
            v_pages[:, pt[b, i]] = v_log[:, b, i * page:(i + 1) * page]
    return k_pages, v_pages, pt


def _quantize_pages(pages, kv):
    """int8 pages [L, P, page, KD] and slot-minor bf16 scales [L, P, Kv, page],
    quantized as the write path does (per slot and head)."""
    L, P, page, KD = pages.shape
    q8, sc = quantize_kv(torch.from_numpy(pages).reshape(L * P, page, kv, KD // kv))
    return (q8.reshape(L, P, page, KD),
            sc.reshape(L, P, page, kv).transpose(2, 3).contiguous())


GEOMETRIES = {  # (Dh, Kv, H, page, Smax): the JAX kernel's, and tiny_mistral's (gather)
    "kernel": (64, 2, 4, 128, 512),
    "gather": (16, 2, 4, 16, 64),
}
# the kernel geometry at head dims 64, 96 and 128 (Kv 4 at 96: the JAX kernel
# needs (Kv * Dh) % 128 == 0), beside the gather geometry's 16
HEAD_DIM_CASES = [("gather", 16), ("kernel", 64), ("kernel", 96), ("kernel", 128)]


def _case(geometry, Sq=1, seed=0, Dh=None):
    dh, kv, h, page, Smax = GEOMETRIES[geometry]
    Dh = Dh or dh
    if (kv * Dh) % 128 and geometry == "kernel":
        kv, h = 4, 4 * (h // kv)
    L, B = 2, 4
    rng = np.random.default_rng(seed)
    k_log = rng.normal(size=(L, B, Smax, kv * Dh)).astype(np.float32)
    v_log = rng.normal(size=(L, B, Smax, kv * Dh)).astype(np.float32)
    q = rng.normal(size=(B, Sq, h, Dh)).astype(np.float32)
    mask = np.zeros((B, Smax), np.int32)
    for b, n in enumerate([5, Smax, page + 3, 1]):  # ragged rows
        mask[b, :n] = 1
    mask[1, 7:9] = 0  # a hole
    k_pages, v_pages, pt = _paged_from_logical(k_log, v_log, page, rng)
    return q, k_pages, v_pages, pt, mask, kv, k_log, v_log


@pytest.mark.parametrize("geometry,Dh", HEAD_DIM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_decode_matches_jax(geometry, Dh, dtype):
    q, k_pages, v_pages, pt, mask, kv, _, _ = _case(geometry, Dh=Dh)
    kw = dict(layer=1, num_kv_heads=kv)
    if dtype == "int8":
        k8, ks = _quantize_pages(k_pages, kv)
        v8, vs = _quantize_pages(v_pages, kv)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        got = paged_attention.paged_decode(tq, k8, v8, torch.from_numpy(pt),
                                           torch.from_numpy(mask), k_scale=ks, v_scale=vs, **kw)
        want = jax_paged_decode(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8.numpy()),
                                jnp.asarray(v8.numpy()), jnp.asarray(pt), jnp.asarray(mask),
                                k_scale=jnp.asarray(ks.float().numpy(), jnp.bfloat16),
                                v_scale=jnp.asarray(vs.float().numpy(), jnp.bfloat16), **kw)
        atol = LOW_ATOL
    else:
        jdt, tdt = {"float32": (jnp.float32, torch.float32),
                    "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        got = paged_attention.paged_decode(
            *(torch.from_numpy(a).to(tdt) for a in (q, k_pages, v_pages)),
            torch.from_numpy(pt), torch.from_numpy(mask), **kw)
        want = jax_paged_decode(*(jnp.asarray(a, jdt) for a in (q, k_pages, v_pages)),
                                jnp.asarray(pt), jnp.asarray(mask), **kw)
        atol = ATOL if dtype == "float32" else LOW_ATOL
    assert got.dtype == (torch.bfloat16 if dtype != "float32" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_paged_decode_causal_per_row_offsets_matches_jax(geometry):
    """Sq = 4 (a verify chunk): query j of row b sees logical slots
    <= offset[b] + j, besides its mask."""
    Sq = 4
    q, k_pages, v_pages, pt, mask, kv, _, _ = _case(geometry, Sq=Sq, seed=3)
    Smax = mask.shape[1]
    offs = np.asarray([2, Smax - Sq, GEOMETRIES[geometry][3] + 3, 0], np.int32)
    for b, o in enumerate(offs):
        mask[b, : o + Sq] = 1
    mask[1, 7:9] = 0
    kw = dict(layer=0, num_kv_heads=kv, causal=True)
    got = paged_attention.paged_decode(*(torch.from_numpy(a) for a in (q, k_pages, v_pages,
                                                                        pt, mask)),
                                       offset=torch.from_numpy(offs), **kw)
    want = jax_paged_decode(*(jnp.asarray(a) for a in (q, k_pages, v_pages, pt, mask)),
                            offset=jnp.asarray(offs), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_matches_flash_decode_on_the_same_logical_cache(quant):
    """K8 over a shuffled page pool and K3 over the same logical cache laid
    out dense compute the same attention (mask-bounded, as serving calls
    both); an empty row gives 0."""
    q, k_pages, v_pages, pt, mask, kv, k_log, v_log = _case("kernel", seed=5)
    mask[3] = 0
    kw = dict(layer=1, num_kv_heads=kv)
    tq = torch.from_numpy(q)
    if quant:
        tq = tq.to(torch.bfloat16)
        k8, ks = _quantize_pages(k_pages, kv)
        v8, vs = _quantize_pages(v_pages, kv)
        paged = paged_attention.paged_decode(tq, k8, v8, torch.from_numpy(pt),
                                             torch.from_numpy(mask), k_scale=ks, v_scale=vs,
                                             **kw)
        L, B, Smax, KD = k_log.shape
        page = k_pages.shape[2]
        idx = torch.from_numpy(pt).long()
        dk = k8[:, idx].reshape(L, B, Smax, KD)
        dv = v8[:, idx].reshape(L, B, Smax, KD)

        def dense_scales(s):  # [L, P, Kv, page] -> [L, B, Kv, Smax]
            return s[:, idx].permute(0, 1, 3, 2, 4).reshape(L, B, kv, Smax).contiguous()

        dense = decode_attention.flash_decode(tq, dk, dv, torch.from_numpy(mask), causal=False,
                                              k_scale=dense_scales(ks),
                                              v_scale=dense_scales(vs), **kw)
        assert page == 128
    else:
        paged = paged_attention.paged_decode(tq, *(torch.from_numpy(a) for a in (
            k_pages, v_pages, pt, mask)), **kw)
        dense = decode_attention.flash_decode(tq, torch.from_numpy(k_log),
                                              torch.from_numpy(v_log),
                                              torch.from_numpy(mask), causal=False, **kw)
    np.testing.assert_allclose(paged.float().numpy(), dense.float().numpy(), atol=ATOL)
    assert torch.count_nonzero(paged[3]) == 0


# ------------------------------------------------- the transformer's paths


@pytest.fixture(scope="module")
def tiny():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return jparams, tparams


def _random_pool(rng, quant, L, lead, width, kv, dh):
    """Random K/V (and int8 scales) for a cache with `lead` rows or pages of
    `width` slots."""
    shape = (L, lead, width, kv * dh)
    if quant:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        sc = (L, lead, kv, width)
        ks = (rng.random(sc) * 0.05).astype(np.float32)
        vs = (rng.random(sc) * 0.05).astype(np.float32)
        return k, v, ks, vs
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), None, None)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_per_row_forward_matches_jax(tiny, paged, quant):
    """One serving decode step, forward(row_offsets=...): rows append at
    their own slots (an inactive row among them), RoPE positions differ from
    the slots (a doc-continuation row), over a dense or a paged pool, fp32
    or int8. Hidden states and every written cache entry match the JAX
    package (the paged scratch page 0 excepted: inactive rows write there
    and its content is not defined)."""
    jparams, tparams = tiny
    cfg = tiny_mistral()
    L, kv, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    B, Smax, page = 4, 32, 8
    rng = np.random.default_rng(11)
    offs = np.asarray([5, 17, 9, 31], np.int32)
    pos = offs + np.asarray([0, -4, 0, 0], np.int32)  # row 1 continues a doc bucket
    active = np.asarray([1, 1, 0, 1], np.int32)  # row 2 is inactive
    mask = np.zeros((B, Smax), np.int32)
    for b, o in enumerate(offs):
        mask[b, :o] = 1
    mask[1, 3:6] = 0  # holes
    tok = rng.integers(3, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    if paged:
        maxp = Smax // page
        n_pages = B * maxp + 1
        pt = (1 + rng.permutation(n_pages - 1)[: B * maxp]).reshape(B, maxp).astype(np.int32)
        k, v, ks, vs = _random_pool(rng, quant, L, n_pages, page, kv, dh)
    else:
        k, v, ks, vs = _random_pool(rng, quant, L, B, Smax, kv, dh)
    if quant:  # both packages keep bf16 scales
        ks, vs = _bf16_np(ks), _bf16_np(vs)

    def jcache():
        common = dict(k=jnp.asarray(k), v=jnp.asarray(v), mask=jnp.asarray(mask),
                      length=jnp.zeros((), jnp.int32),
                      k_scale=None if ks is None else jnp.asarray(ks, jnp.bfloat16),
                      v_scale=None if vs is None else jnp.asarray(vs, jnp.bfloat16))
        if paged:
            return JaxPagedKVCache(page_table=jnp.asarray(pt), **common)
        return JaxKVCache(**common)

    def tcache():
        common = dict(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                      mask=torch.from_numpy(mask.copy()),
                      k_scale=None if ks is None else torch.from_numpy(ks).to(torch.bfloat16),
                      v_scale=None if vs is None else torch.from_numpy(vs).to(torch.bfloat16))
        if paged:
            return PagedKVCache(page_table=torch.from_numpy(pt), **common)
        return KVCache(length=0, **common)

    want_h, want_c, _ = jax_forward(jparams, jax_tiny_mistral(), jnp.asarray(tok),
                                    attention_mask=jnp.asarray(active[:, None]),
                                    positions=jnp.asarray(pos[:, None]), cache=jcache(),
                                    row_offsets=jnp.asarray(offs))
    cache = tcache()
    got_h, got_c, _ = forward(tparams, cfg, torch.from_numpy(tok),
                              attention_mask=torch.from_numpy(active[:, None]),
                              positions=torch.from_numpy(pos[:, None]), cache=cache,
                              row_offsets=torch.from_numpy(offs))
    assert got_c is cache and cache.mask[2, 9] == 0  # in place; inactive row set no bit
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL, rtol=ATOL)
    names = ("mask", "k", "v") + (("k_scale", "v_scale") if quant else ())
    for name in names:
        got = getattr(got_c, name).float().numpy()
        want = np.asarray(getattr(want_c, name), np.float32)
        if paged and name != "mask":
            got, want = got[:, 1:], want[:, 1:]  # page 0 is scratch
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=name)


def test_per_row_forward_limits(tiny):
    _, tparams = tiny
    cfg = tiny_mistral()
    paged = init_paged_cache(cfg, 2, 16, 5, page=8, device="cpu")
    with pytest.raises(ValueError, match="decode-only"):
        forward(tparams, cfg, torch.zeros((2, 4), dtype=torch.int32), cache=paged)
    # S > 1 (the speculative verify chunk) writes each row's S slots
    paged.page_table[:] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    forward(tparams, cfg, torch.full((2, 3), 5, dtype=torch.int32), cache=paged,
            row_offsets=torch.tensor([6, 0], dtype=torch.int32))
    assert paged.mask[0, 6:9].tolist() == [1, 1, 1] and paged.mask[1, :3].tolist() == [1, 1, 1]
    assert int(paged.mask.sum()) == 6
    with pytest.raises(ValueError, match="multiple"):
        init_paged_cache(cfg, 2, 20, 5, page=8, device="cpu")
