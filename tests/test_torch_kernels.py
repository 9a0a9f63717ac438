"""The port's kernel functions against the JAX package's kernels.

Inputs are made from a seed with numpy and fed to both sides. The JAX side
runs its Pallas kernels in interpret mode on the CPU (as tests/test_flash.py,
test_decode_attention.py and test_fused_pool.py run them); the port runs on
CPU tensors, so each wrapper takes its plain version, in float32. The CUDA
kernels themselves are held against the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: both sides compute in float32 and differ only in the order of
their sums, so 5e-5 absolute holds with room for values of order 1.

Head dims: the attention tests run at Dh 64, 96 and 128 (HEAD_DIMS). The
JAX flash kernel pads 64 and 96 to 128 lanes (folding the scale into q);
its decode kernel needs (Kv * Dh) % 128 == 0, so at Dh 96 the decode cases
take Kv = 4 (`_kv_for`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gritlm_tpu.ops.fused_pool as jax_fused_pool
from gritlm_tpu.ops.attention import make_attention_bias as jax_bias
from gritlm_tpu.ops.attention import mha_reference as jax_mha
from gritlm_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from gritlm_tpu.models.transformer import quantize_kv as jax_quantize_kv
from gritlm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from gritlm_tpu_torch.models.transformer import quantize_kv
from gritlm_tpu_torch.ops import decode_attention, flash_attention, fused_pool
from gritlm_tpu_torch.ops.attention import (
    cached_attention,
    make_attention_bias,
    mha_reference,
)

ATOL = 5e-5
HEAD_DIMS = [64, 96, 128]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep torch's intra-op pool from competing with XLA and with the other
    test workers for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _attn_inputs(B=2, Sq=256, Sk=256, H=4, Hkv=2, Dh=128, seed=0, pad_row=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, Dh)).astype(np.float32)
    mask = np.ones((B, Sk), np.int32)
    if pad_row:
        mask[-1, Sk - 37:] = 0
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sw", [None, 64])
def test_flash_attention_matches_jax(causal, sw, Dh):
    q, k, v, mask = _attn_inputs(Dh=Dh)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), causal=causal, sliding_window=sw)
    got = flash_attention.flash_attention(*_t(q, k, v, mask), causal=causal,
                                          sliding_window=sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_flash_attention_offset_matches_jax(Dh):
    """Prefill on top of a cache: q row 0 sits at absolute slot 128."""
    q, k, v, mask = _attn_inputs(Sq=128, Sk=384, pad_row=False, Dh=Dh)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), causal=True, offset=128)
    got = flash_attention.flash_attention(*_t(q, k, v, mask), causal=True, offset=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_short_query_matches_reference(causal):
    """The port runs K1 for any query length (the JAX kernel raises below
    128 and its caller takes the einsum path): hold it to the JAX einsum."""
    q, k, v, mask = _attn_inputs(Sq=64, Sk=64)
    bias = jax_bias(jnp.asarray(mask), 64, 64, causal=causal)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias)
    got = flash_attention.flash_attention(*_t(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    ref = mha_reference(*_t(q, k, v), make_attention_bias(_t(mask)[0], 64, 64,
                                                           causal=causal))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=ATOL)


def test_flash_attention_fully_masked_rows_are_zero():
    q, k, v, _ = _attn_inputs(Sq=128, Sk=128, pad_row=False)
    mask = np.zeros((2, 128), np.int32)
    got = flash_attention.flash_attention(*_t(q, k, v, mask), causal=False)
    assert torch.count_nonzero(got) == 0


# ---------------------------------------------------------------- K3


def _kv_for(Hkv, H, Dh):
    """(Hkv, H) with (Hkv * Dh) % 128 == 0, as the JAX decode kernel needs:
    Kv 4 (and the same group) at Dh 96."""
    if (Hkv * Dh) % 128:
        return 4, 4 * (H // Hkv)
    return Hkv, H


def _decode_case(name, Dh=128):
    rng = np.random.default_rng(sum(map(ord, name)))
    # (B, Sq, H, Hkv, Smax, L, layer, causal, window, offset)
    geo = {
        "single_token": (2, 1, 4, 2, 256, 2, 1, True, None, 69),
        "cached_prefill": (2, 7, 4, 2, 384, 1, 0, True, None, 100),
        "holes": (2, 1, 4, 2, 512, 1, 0, True, None, 299),
        "window": (1, 3, 4, 4, 256, 1, 0, True, 64, 197),
        "bidirectional": (1, 3, 4, 4, 256, 1, 0, False, None, 0),
    }[name]
    B, Sq, H, Hkv, Smax, L, layer, causal, window, offset = geo
    Hkv, H = _kv_for(Hkv, H, Dh)
    q = (rng.normal(size=(B, Sq, H, Dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(L, B, Smax, Hkv * Dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(L, B, Smax, Hkv * Dh)) * 0.5).astype(np.float32)
    if name == "holes":
        mask = (rng.uniform(size=(B, Smax)) > 0.4).astype(np.int32)
        mask[:, 300:] = 0
    else:
        valid = offset + Sq if causal else 200
        mask = np.broadcast_to(np.arange(Smax)[None] < valid, (B, Smax)).astype(np.int32)
    kw = dict(causal=causal, sliding_window=window, offset=offset, layer=layer)
    return q, k, v, mask, kw


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("name", ["single_token", "cached_prefill", "holes", "window",
                                  "bidirectional"])
def test_flash_decode_matches_jax(name, Dh):
    q, k, v, mask, kw = _decode_case(name, Dh)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), **kw)
    got = decode_attention.flash_decode(*_t(q, k, v, mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, 2, 128)) * 0.7).astype(np.float32)
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("name", ["single_token", "cached_prefill", "holes"])
def test_flash_decode_int8_matches_jax(name, Dh):
    """int8 cache with slot-minor bf16 scales, quantized as the write path
    does. Against the JAX kernel the tolerance is 5e-3, as the JAX package's
    own test holds its kernel to its dequantize-then-attend oracle: its
    kernel rounds P times the V scale to bf16. Against that oracle (same
    float32 math) it is ATOL."""
    q, k, v, mask, kw = _decode_case(name, Dh)
    L, B, Smax, KD = k.shape
    hkv = KD // Dh
    k8, ks = jax_quantize_kv(jnp.asarray(k.reshape(L * B, Smax, hkv, Dh)))
    v8, vs = jax_quantize_kv(jnp.asarray(v.reshape(L * B, Smax, hkv, Dh)))
    k8 = np.asarray(k8).reshape(L, B, Smax, KD)
    v8 = np.asarray(v8).reshape(L, B, Smax, KD)
    ks_t = np.asarray(ks, np.float32).reshape(L, B, Smax, hkv).transpose(0, 1, 3, 2)
    vs_t = np.asarray(vs, np.float32).reshape(L, B, Smax, hkv).transpose(0, 1, 3, 2)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                            jnp.asarray(mask), k_scale=jnp.asarray(ks_t, jnp.bfloat16),
                            v_scale=jnp.asarray(vs_t, jnp.bfloat16), **kw)
    qt, k8t, v8t, mt = _t(q, k8, v8, mask)
    kst, vst = (torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
                for a in (ks_t, vs_t))
    got = decode_attention.flash_decode(qt, k8t, v8t, mt, k_scale=kst, v_scale=vst, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3)
    layer = kw["layer"]
    kd = k8[layer].reshape(B, Smax, hkv, Dh) * ks_t[layer].transpose(0, 2, 1)[..., None]
    vd = v8[layer].reshape(B, Smax, hkv, Dh) * vs_t[layer].transpose(0, 2, 1)[..., None]
    bias = jax_bias(jnp.asarray(mask), q.shape[1], Smax, causal=kw["causal"],
                    offset=kw["offset"])
    oracle = jax_mha(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


def test_cached_attention_dispatch_agrees():
    """Below 128 queries cached_attention takes K3, above it K1 on the
    layer's view; both compute the same attention."""
    q, k, v, mask, kw = _decode_case("cached_prefill")
    qt, kt, vt, mt = _t(q, k, v, mask)
    got = cached_attention(qt, kt, vt, mt, layer=0, offset=100, causal=True)
    lk = kt[0].view(2, 384, 2, 128)
    lv = vt[0].view(2, 384, 2, 128)
    want = flash_attention.flash_attention(qt, lk, lv, mt, causal=True, offset=100)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


# ---------------------------------------------------------------- K2


def _pool_case(B=3, S=700, D=128, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    gamma = (rng.normal(size=(D,)) * 0.5 + 1.0).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :11] = 0  # instruction prefix masked out
    mask[1, S * 3 // 4:] = 0  # right padding
    if B > 2:
        mask[2, :5] = 0
    return hidden, gamma, mask


def _one_token_case():
    """One pooled token a row, at the first, a middle and the last position
    (S = 300, not a multiple of 128: the JAX kernel pads to 384)."""
    hidden, gamma, _ = _pool_case(S=300, seed=1)
    mask = np.zeros((3, 300), np.int32)
    for row, pos in enumerate((0, 150, 299)):
        mask[row, pos] = 1
    return hidden, gamma, mask


POOL_CASES = {
    "S700": _pool_case,
    "S333": lambda: _pool_case(S=333, seed=2),
    "one-token": _one_token_case,
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("method", ["mean", "weightedmean"])
@pytest.mark.parametrize("normalized", [True, False])
def test_fused_pool_matches_jax(monkeypatch, method, normalized, case):
    """S = 700 spans two of the JAX kernel's 512-row blocks, so the running
    token count of weightedmean crosses a block boundary; S = 333 is no
    multiple of 128 (one padded block); one pooled token a row is the
    weight-1 edge of weightedmean."""
    monkeypatch.setattr(jax_fused_pool, "_FORCE_KERNEL", True)
    hidden, gamma, mask = POOL_CASES[case]()
    want = jax_fused_pool.fused_norm_mean_pool(
        jnp.asarray(hidden), jnp.asarray(gamma), jnp.asarray(mask), eps=1e-5,
        method=method, normalized=normalized)
    got = fused_pool.fused_norm_mean_pool(*_t(hidden, gamma, mask), eps=1e-5,
                                          method=method, normalized=normalized)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_pool_empty_mask_row_is_finite():
    hidden, gamma, _ = _pool_case(B=2, S=64)
    mask = np.zeros((2, 64), np.int32)
    got = fused_pool.fused_norm_mean_pool(*_t(hidden, gamma, mask), eps=1e-5,
                                          normalized=False)
    assert torch.isfinite(got).all()
