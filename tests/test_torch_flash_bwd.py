"""The port's flash attention backward (K4/K5's plain versions, autograd
through `flash_attention`, and `FlashAttentionFn`) against `jax.vjp` of the
JAX package's Pallas flash attention in interpret mode, as
tests/test_flash.py runs it on the CPU; and K1's LSE output against the JAX
forward's `with_lse=True` stripes.

Inputs are seeded numpy arrays in float32 handed to both. Tolerance: atol
1e-4 on the gradients, as tests/test_flash.py holds the JAX backward
against its reference; the two compute the same fp32 sums in another
order.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gritlm_tpu.ops import flash_attention as jfa
from gritlm_tpu_torch.ops import flash_attention as fa

ATOL = 1e-4

# (label, S, causal, sliding_window, offset, padded row, (H, Hkv)); the label
# is the case's test id
CASES = [
    ("causal-S128", 128, True, None, 0, False, (4, 2)),
    ("bidirectional-S256-padded-row", 256, False, None, 0, True, (4, 2)),
    ("causal-S256-window64-padded-row", 256, True, 64, 0, True, (4, 2)),
    ("causal-S128-offset64", 128, True, None, 64, False, (4, 2)),
    # lengths off the kernels' 64-row tiles and 128-row blocks
    ("bidirectional-S129", 129, False, None, 0, False, (4, 2)),
    ("causal-S191-padded-row-H8-Hkv2", 191, True, None, 0, True, (8, 2)),
    ("bidirectional-S191-padded-row-H8-Hkv2", 191, False, None, 0, True, (8, 2)),
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reference64(q, k, v, mask, causal, window, offset):
    """The attention output in float64 (numpy), to tell on a mismatch which
    side moved."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    keep = fa.keep_mask(torch.from_numpy(mask), S, k.shape[1], causal=causal,
                        sliding_window=window if causal else None, offset=offset,
                        device="cpu").numpy()[:, None, None]
    qg = q.astype(np.float64).reshape(B, S, Hkv, H // Hkv, Dh)
    s = np.where(keep, np.einsum("bqhgd,bkhd->bhgqk", qg, k.astype(np.float64)) * Dh ** -0.5,
                 -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(m), m, 0.0))
    p = p / np.maximum(p.sum(-1, keepdims=True), np.finfo(np.float64).tiny)
    return np.einsum("bhgqk,bkhd->bqhgd", p, v.astype(np.float64)).reshape(q.shape)


def _inputs(S, pad_row, B=2, H=4, Hkv=2, Dh=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    do = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    if pad_row:
        mask[-1, S - 37:] = 0
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, window, offset):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), causal=causal,
                                   sliding_window=window, offset=offset)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("label,S,causal,window,offset,pad,heads", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_matches_jax(label, S, causal, window, offset, pad, heads):
    q, k, v, do, mask = _inputs(S, pad, H=heads[0], Hkv=heads[1])
    want_out, want = _jax_grads(q, k, v, do, mask, causal, window, offset)
    kw = dict(causal=causal, sliding_window=window, offset=offset)
    tq, tk, tv, tdo, tmask = (torch.from_numpy(x) for x in (q, k, v, do, mask))

    # the plain backward from the forward's saved output and LSE
    out, lse = fa.flash_attention(tq, tk, tv, tmask, return_lse=True, **kw)
    try:
        np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5)
    except AssertionError as e:
        ref = _reference64(q, k, v, mask, causal, window, offset)
        raise AssertionError(
            f"{e}\nlargest error against a float64 reference: JAX "
            f"{np.abs(want_out - ref).max():.3e}, port {np.abs(out.numpy() - ref).max():.3e}"
        ) from None
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tmask, out, lse, tdo, **kw)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=f"plain d{name}")

    # autograd through flash_attention (attend_plain) and FlashAttentionFn
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    for how in ("autograd", "FlashAttentionFn"):
        if how == "autograd":
            o = fa.flash_attention(*leaves, tmask, **kw)
        else:
            o = fa.FlashAttentionFn.apply(*leaves, tmask, causal, window, offset)
        grads = torch.autograd.grad(o, leaves, grad_outputs=tdo)
        for g, w, name in zip(grads, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=f"{how} d{name}")


@pytest.mark.parametrize("causal,window", [(False, None), (True, 64)])
def test_lse_matches_jax(causal, window):
    """K1's LSE [B, H, Sq] against the JAX forward's [B, H*8, Sq] stripes
    (one row of each 8-row stripe)."""
    q, k, v, _, mask = _inputs(256, True)
    _, jlse = jfa._flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal, window, 0, with_lse=True)
    want = np.asarray(jlse)[:, ::8, :256]
    _, lse = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                causal=causal, sliding_window=window, return_lse=True)
    assert lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-4)


def test_fully_masked_rows_get_zero_gradients():
    """A row whose keys are all masked has LSE NEG_INF, output 0 and exactly
    zero gradients (P and dS are selected to 0, never multiplied)."""
    q, k, v, do, mask = _inputs(128, False)
    mask[0] = 0
    tq, tk, tv, tdo, tmask = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    out, lse = fa.flash_attention(tq, tk, tv, tmask, causal=False, return_lse=True)
    assert float(out[0].abs().max()) == 0.0 and bool((lse[0] == fa.NEG_INF).all())
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, tmask, out, lse, tdo, causal=False)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
        assert float(g[0].abs().max()) == 0.0
    assert float(dq[1].abs().max()) > 0


def test_gqa_group_sum_and_dtypes():
    """dK/dV come out per kv head (the GQA group summed), in the inputs'
    dtypes, from both kernel entry points' plain versions."""
    q, k, v, do, mask = _inputs(128, True, H=8, Hkv=2)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    tmask = torch.from_numpy(mask)
    out, lse = fa.flash_attention(t[0], t[1], t[2], tmask, causal=True, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_bwd(t[0], t[1], t[2], tmask, out, lse, t[3], causal=True)
    assert dq.shape == t[0].shape and dk.shape == t[1].shape and dv.shape == t[2].shape
    assert {dq.dtype, dk.dtype, dv.dtype} == {torch.bfloat16}
    # group sum: the per-query-head contributions in fp32, summed by hand;
    # dv is that sum rounded once to bf16 (8 bits of mantissa: rtol 8e-3)
    delta = fa.attention_delta(out, t[3])
    p, ds, dog = fa._bwd_plain_parts(t[0], t[1], t[2], tmask, t[3], lse, delta, causal=True,
                                     sliding_window=None, offset=0)
    dv_heads = torch.einsum("bhgqk,bqhgd->bkhgd", p, dog)
    torch.testing.assert_close(dv.float(), dv_heads.sum(3), rtol=8e-3, atol=1e-3)


# The first plain call in a fresh process, made from two intra-op threads at
# once: the call that came back up to 1.05e-4 off when MKL's vector math
# picked its kernel in a race between the threads (gritlm_tpu_torch's
# import now makes that first pick on one thread).
_FIRST_CALL = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import test_torch_flash_bwd as t
from gritlm_tpu_torch.ops import flash_attention as fa
torch.set_num_threads(2)
q, k, v, _, mask = t._inputs(128, False)
out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), causal=True)
print(float(np.abs(out.numpy() - t._reference64(q, k, v, mask, True, None, 0)).max()))
"""


def test_first_call_in_fresh_processes_matches_float64():
    """Four fresh processes at once, each making its first plain attention
    call (causal, S 128) on two threads, against the float64 reference
    within the forward check's 2e-5."""
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL, str(tests)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        errs.append(float(out.split()[-1]))
    assert max(errs) <= 2e-5, f"first-call errors against float64: {errs}"
