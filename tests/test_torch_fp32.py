"""The fp32 forms of K1, K2, K3 and K8 and the slice that runs them, on the
CPU: the form chooser, the fp32 forms' launch plans, the cases those forms
take on the card that the other parity tests do not hold against the JAX
package, and GritLM at fp32 activations through `from_pretrained` and the
serve CLI.

Inputs are made from a seed with numpy and fed to both sides; the JAX side
runs its Pallas kernels in interpret mode on the CPU, as its own tests do.
CPU tensors take each wrapper's plain version, so the kernels themselves
are held to those plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: fp32 on both sides, the same sums in another order: 5e-5 on
values of order 1 (as tests/test_torch_kernels.py), 1e-4 on log-sum-exps
(as tests/test_torch_flash_bwd.py). Over an int8 cache the JAX kernel
rounds P times the V scale to bf16 where the port keeps fp32: 5e-3 against
it (the gap tests/test_torch_kernels.py records), ATOL against the same
dequantize-then-attend oracle in fp32.
"""

import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gritlm_tpu.serve as jax_serve
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models.transformer import quantize_kv as jax_quantize_kv
from gritlm_tpu.ops import flash_attention as jfa
from gritlm_tpu.ops.attention import make_attention_bias as jax_bias
from gritlm_tpu.ops.attention import mha_reference as jax_mha
from gritlm_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from gritlm_tpu.ops.paged_attention import paged_decode as jax_paged_decode
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch import serve as port_serve
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models.convert import params_from_jax
from gritlm_tpu_torch.models.loader import save_checkpoint
from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops import decode_attention as da
from gritlm_tpu_torch.ops import flash_attention as fa
from gritlm_tpu_torch.ops import fused_pool as fp
from gritlm_tpu_torch.ops import paged_attention as pa
from gritlm_tpu_torch.training.arguments import RunArguments
from tok_fixtures import make_bpe_tokenizer

ATOL = 5e-5
LSE_ATOL = 1e-4
INT8_ATOL = 5e-3
CSRC = Path(__file__).resolve().parents[1] / "gritlm_tpu_torch" / "csrc"
PKG = CSRC.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- the form chooser


@pytest.mark.parametrize("dtypes,form", [
    ((torch.bfloat16,), "bf16"),
    ((torch.bfloat16, None, torch.bfloat16), "bf16"),
    ((torch.float32,), "f32"),
    ((torch.float32, torch.float32, None), "f32"),
    ((torch.float16,), TypeError),
    ((torch.float16, torch.float16), TypeError),
    ((torch.bfloat16, torch.float32), TypeError),
    ((torch.float32, torch.int8), TypeError),
    ((), TypeError),
])
def test_kernel_form(dtypes, form):
    """All bf16 -> the bf16 form, all fp32 -> the fp32 form (None skipped);
    float16, a mix, or no tensor raise TypeError: no cast, no widening."""
    tensors = [None if d is None else torch.zeros(2, dtype=d) for d in dtypes]
    if form is TypeError:
        with pytest.raises(TypeError, match="all bfloat16 or all float32"):
            _build.kernel_form(*tensors, what="k")
    else:
        assert _build.kernel_form(*tensors) == form


# ---------------------------------------------------------------- the plans


def _csrc_int(path: Path, name: str, after: str = "") -> int:
    """The value of `constexpr int name = N` in a source (the first after
    the line holding `after`)."""
    text = path.read_text()
    text = text[text.index(after):] if after else text
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("head_dim", [64, 96, 128])
def test_f32_decode_rings_fit(head_dim, quant):
    """The fp32 form of K3/K8 takes 4-byte cache rows (1-byte over int8)
    in the same rings (4 warps x 3 stages x K and V x 16 rows padded by 16
    bytes), plus the unit's fp32 query rows and a P^T tile a warp: the
    blocks an SM holds are as many as its shared memory takes, at most 4;
    at Dh 128 one block over an fp32 cache, three over int8. The Python
    mirror matches the source's PT_LD."""
    assert da.F32_PT_LD == _csrc_int(CSRC / "decode_mma.cuh", "PT_LD")
    ring = da.ring_bytes(head_dim, quant, f32=True)
    assert ring == 4 * 3 * 2 * 16 * (head_dim * (1 if quant else 4) + 16)
    block = da.block_bytes(head_dim, quant, f32=True)
    assert block == ring + 8 * head_dim * 4 + 4 * 16 * da.F32_PT_LD * 4
    blocks = da.blocks_per_sm(quant, head_dim, f32=True)
    assert 1 <= blocks <= da.MAX_BLOCKS_PER_SM and blocks * block <= da.SMEM_PER_SM
    assert blocks == da.MAX_BLOCKS_PER_SM or (blocks + 1) * block > da.SMEM_PER_SM
    if head_dim == 128:
        assert blocks == da.F32_BLOCKS_PER_SM[quant] == (3 if quant else 1)
    # the bf16 form's plan is unchanged by the fp32 one
    assert da.block_bytes(head_dim, quant) == da.ring_bytes(head_dim, quant)


def _unit_tiles(row, lo, hi):
    """(first tile, tile count) of the valid slots of row in [lo, hi), as
    the kernel's mask scan finds them."""
    idx = np.flatnonzero(row[lo:hi]) + lo
    if idx.size == 0:
        return 0, 0
    return idx[0] // da.SLOT_TILE, idx[-1] // da.SLOT_TILE + 1 - idx[0] // da.SLOT_TILE


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,Sq,H,Hkv,Smax,causal,offset,window", [
    (4, 1, 32, 8, 2048, True, 1499, None),  # the decode step
    (8, 1, 32, 8, 4096, False, 0, None),  # the serving call, mask-bounded
    (8, 8, 32, 8, 4096, False, 0, None),  # the verify chunk (planned over Smax)
    (2, 64, 16, 8, 1024, True, 900, 128),  # a prefill chunk with a window
])
def test_f32_decode_plan_covers_the_valid_slots(B, Sq, H, Hkv, Smax, causal, offset, window,
                                                quant):
    """The fp32 form's plan: one wave of its blocks or one split, and every
    slot a unit's rows can see in exactly one split and one warp's run;
    K8's plan is K3's."""
    sms = 132
    n_split, n_rg = da.decode_plan(B, Sq, H, Hkv, Smax, sms, causal=causal, offset=offset,
                                   window=window, quant=quant, f32=True)
    if window is None:  # K8 takes no window
        assert (n_split, n_rg) == pa.paged_plan(B, Sq, H, Hkv, Smax, sms, causal=causal,
                                                offset=offset, quant=quant, f32=True)
    units = B * Hkv * n_rg
    assert 1 <= n_split <= da.MAX_SPLITS
    assert n_split * units <= max(units, da.blocks_per_sm(quant, f32=True) * sms)
    group, R = H // Hkv, Sq * (H // Hkv)
    rng = np.random.default_rng(Smax + Sq)
    for b in range(B):
        row = np.zeros(Smax, dtype=np.int32)
        row[:int(rng.integers(0, Smax + 1))] = 1
        row[rng.random(Smax) < 0.2] = 0
        for rg in range(n_rg):
            r0, r1 = rg * da.ROW_GROUP, min(R, (rg + 1) * da.ROW_GROUP) - 1
            lo, hi = da.slot_range(r0 // group, r1 // group, Smax, causal=causal,
                                   offset=offset, window=window)
            t0, nt = _unit_tiles(row, lo, hi)
            n_used = da.used_splits(nt, n_split)
            owner = np.zeros(Smax, dtype=int)
            for s in range(n_used):
                a, e = da.split_tiles(nt, s, n_used)
                for w in range(da.DECODE_WARPS):
                    w0, w1 = da.split_tiles(e - a, w, da.DECODE_WARPS)
                    owner[(t0 + a + w0) * da.SLOT_TILE:(t0 + a + w1) * da.SLOT_TILE] += 1
            visible = np.zeros(Smax, dtype=bool)
            visible[lo:hi] = row[lo:hi] != 0
            assert (owner[visible] == 1).all() and owner.max(initial=0) <= 1, (b, rg)


@pytest.mark.parametrize("B,S", [(1, 1), (1, 4096), (8, 512), (64, 128), (3, 700),
                                 (2, 1 << 19)])
def test_f32_pool_plan(B, S):
    """K2's fp32 form: n_split blocks a row, at least one, at most one per
    F32_MIN_ROWS positions, about F32_BLOCKS_PER_SM blocks an SM over the
    rows; the blocks' ranges cut the row's positions in order, each once.
    Its dim limit is the source's THREADS x 4 x MAX_VECS floats a row."""
    src = CSRC / "fused_pool.cu"
    assert fp.F32_THREADS == _csrc_int(src, "THREADS", "namespace f32 {")
    assert fp.F32_MAX_DIM == fp.F32_THREADS * 4 * _csrc_int(src, "MAX_VECS", "namespace f32 {")
    n = fp.f32_pool_plan(B, S, 132)
    assert 1 <= n <= max(1, -(-S // fp.F32_MIN_ROWS))
    assert B * n <= max(B, fp.F32_BLOCKS_PER_SM * 132)
    cuts = [fp.f32_split(S, s, n) for s in range(n)]
    assert cuts[0][0] == 0 and cuts[-1][1] == S
    assert all(cuts[i][1] == cuts[i + 1][0] for i in range(n - 1))
    assert all(e >= a for a, e in cuts)


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("Dh", [64, 96])
@pytest.mark.parametrize("causal,window", [(False, None), (True, 64)])
def test_lse_below_128_matches_jax(Dh, causal, window):
    """K1's fp32 LSE at Dh 64 and 96 (which the card's form runs at 64 and
    zero-padded to 128) against the JAX forward's `with_lse` stripes, its
    q, k and v padded to 128 lanes with sqrt(128 / Dh) folded into q as the
    JAX wrapper pads them; the outputs against the JAX wrapper's."""
    rng = np.random.default_rng(Dh)
    B, S, H, Hkv = 2, 256, 4, 2
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[-1, S - 37:] = 0
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - Dh))
    qc = np.pad(q, pad) * np.float32((128 / Dh) ** 0.5)
    _, jlse = jfa._flash_call(jnp.asarray(qc), jnp.asarray(np.pad(k, pad)),
                              jnp.asarray(np.pad(v, pad)), jnp.asarray(mask), causal, window, 0,
                              with_lse=True)
    want_out = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v, mask)), causal=causal,
                                   sliding_window=window)
    out, lse = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                  causal=causal, sliding_window=window, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, ::8, :S], atol=LSE_ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)


def _int8(x, L, B, S, Kv, Dh):
    """x [L, B, S, Kv*Dh] quantized as the JAX write path does: int8 values
    and slot-minor scales [L, B, Kv, S] (bf16 values, as float32)."""
    x8, sc = jax_quantize_kv(jnp.asarray(x.reshape(L * B, S, Kv, Dh)))
    return (np.array(x8).reshape(L, B, S, Kv * Dh),
            np.asarray(sc, np.float32).reshape(L, B, S, Kv).transpose(0, 1, 3, 2).copy())


@pytest.mark.parametrize("Dh", [64, 96, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_verify_chunk_per_row_offsets_matches_jax(Dh, quant):
    """K3 at the verify chunk's form, Sq 8 with a [B] tensor of offsets,
    fp32 q over an fp32 or an int8 cache, at Dh 64, 96 (Kv 4: the JAX decode
    kernel needs (Kv * Dh) % 128 == 0) and 128: against the JAX flash_decode
    with [B] offsets in interpret mode, and (int8) against the fp32
    dequantize-then-attend oracle with the per-row causal bias."""
    B, Sq, H, Kv, Smax = 3, 8, 8, (4 if Dh == 96 else 2), 256
    rng = np.random.default_rng(Dh + 7 * quant)
    q = (rng.normal(size=(B, Sq, H, Dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(1, B, Smax, Kv * Dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(1, B, Smax, Kv * Dh)) * 0.5).astype(np.float32)
    mask = (rng.uniform(size=(B, Smax)) > 0.2).astype(np.int32)
    offs = np.asarray([17, 120, Smax - Sq], np.int32)
    kw = dict(causal=True, layer=0)
    if quant:
        k8, ks = _int8(k, 1, B, Smax, Kv, Dh)
        v8, vs = _int8(v, 1, B, Smax, Kv, Dh)
        want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                jnp.asarray(mask), offset=jnp.asarray(offs),
                                k_scale=jnp.asarray(ks, jnp.bfloat16),
                                v_scale=jnp.asarray(vs, jnp.bfloat16), **kw)
        got = da.flash_decode(*(torch.from_numpy(x) for x in (q, k8, v8, mask)),
                              offset=torch.from_numpy(offs),
                              k_scale=torch.from_numpy(ks).to(torch.bfloat16),
                              v_scale=torch.from_numpy(vs).to(torch.bfloat16), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_ATOL,
                                   rtol=INT8_ATOL)
        kd = k8[0].reshape(B, Smax, Kv, Dh) * ks[0].transpose(0, 2, 1)[..., None]
        vd = v8[0].reshape(B, Smax, Kv, Dh) * vs[0].transpose(0, 2, 1)[..., None]
        bias = jax_bias(jnp.asarray(mask), Sq, Smax, causal=True, offset=jnp.asarray(offs))
        oracle = jax_mha(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), bias)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)
    else:
        want = jax_flash_decode(*(jnp.asarray(x) for x in (q, k, v, mask)),
                                offset=jnp.asarray(offs), **kw)
        got = da.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                              offset=torch.from_numpy(offs), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("Sq,causal", [(1, False), (4, True)])
def test_paged_int8_under_fp32_q_matches_jax(Sq, causal):
    """K8 over int8 pages with bf16 scales under fp32 q, pages of 128 slots
    shuffled over the pool, ragged rows and a hole, Sq 1 (mask-bounded) and
    a causal chunk at per-row offsets: against the JAX paged_decode in
    interpret mode (INT8_ATOL), and against the fp32 dequantize-then-attend
    oracle over the rows laid out dense (ATOL)."""
    Dh, Kv, H, page, Smax, B = 64, 2, 4, 128, 512, 4
    maxp = Smax // page
    rng = np.random.default_rng(11 + Sq)
    k_log = rng.normal(size=(1, B, Smax, Kv * Dh)).astype(np.float32)
    v_log = rng.normal(size=(1, B, Smax, Kv * Dh)).astype(np.float32)
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    mask = np.zeros((B, Smax), np.int32)
    for b, n in enumerate([5, Smax, page + 3, 1]):
        mask[b, :n] = 1
    mask[1, 7:9] = 0
    offs = np.asarray([2, Smax - Sq, page, 0], np.int32)
    k8, ks = _int8(k_log, 1, B, Smax, Kv, Dh)
    v8, vs = _int8(v_log, 1, B, Smax, Kv, Dh)
    P = B * maxp + 3
    pt = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    kp, vp = (np.zeros((1, P, page, Kv * Dh), np.int8) for _ in range(2))
    ksp, vsp = (np.ones((1, P, Kv, page), np.float32) for _ in range(2))
    for b in range(B):
        for i in range(maxp):
            sl = slice(i * page, (i + 1) * page)
            kp[0, pt[b, i]], vp[0, pt[b, i]] = k8[0, b, sl], v8[0, b, sl]
            ksp[0, pt[b, i]], vsp[0, pt[b, i]] = ks[0, b, :, sl], vs[0, b, :, sl]
    kw = dict(layer=0, num_kv_heads=Kv, causal=causal)
    if causal:
        kw["offset"] = offs
    want = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                            jnp.asarray(mask), k_scale=jnp.asarray(ksp, jnp.bfloat16),
                            v_scale=jnp.asarray(vsp, jnp.bfloat16),
                            **{**kw, "offset": jnp.asarray(offs) if causal else 0})
    got = pa.paged_decode(*(torch.from_numpy(x) for x in (q, kp, vp, pt, mask)),
                          k_scale=torch.from_numpy(ksp).to(torch.bfloat16),
                          v_scale=torch.from_numpy(vsp).to(torch.bfloat16),
                          **{**kw, "offset": torch.from_numpy(offs) if causal else 0})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_ATOL, rtol=INT8_ATOL)
    kd = k8[0].reshape(B, Smax, Kv, Dh) * ks[0].transpose(0, 2, 1)[..., None]
    vd = v8[0].reshape(B, Smax, Kv, Dh) * vs[0].transpose(0, 2, 1)[..., None]
    bias = jax_bias(jnp.asarray(mask), Sq, Smax, causal=causal,
                    offset=jnp.asarray(offs) if causal else 0)
    oracle = jax_mha(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


# ---------------------------------------------------------------- the slice


SENTS = ["A cat sat on the mat.", "Bitcoin is a peer-to-peer currency.", "zeta"]
PROMPTS = ["<|user|>\nSay a word\n<|assistant|>\n", "<|user|>\nHi\n<|assistant|>\n"]


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory):
    """tiny_mistral's JAX weights rounded to bf16 and written by the port's
    save_checkpoint as a bf16 checkpoint, with a BPE tokenizer.json."""
    jparams = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)),
        jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(tiny_mistral(), dtype="bfloat16")
    path = tmp_path_factory.mktemp("bf16_ckpt")
    save_checkpoint(str(path), cfg, params_from_jax(jparams, cfg, device="cpu"))
    make_bpe_tokenizer()._tok.save(str(path / "tokenizer.json"))
    return path


def test_from_pretrained_float32_matches_jax(bf16_checkpoint):
    """GritLM.from_pretrained(dtype="float32") on a bf16 checkpoint: fp32
    weights and activations (K1, K2, K3 at fp32), the JAX from_pretrained's
    (dtype="float32") embeddings within ATOL and its greedy tokens."""
    jm = JaxGritLM.from_pretrained(str(bf16_checkpoint), dtype="float32")
    pm = GritLM.from_pretrained(str(bf16_checkpoint), dtype="float32", device="cpu")
    assert pm.config.dtype == "float32"
    assert pm.params["embed"]["embedding"].dtype == torch.float32
    a, b = np.asarray(jm.encode(SENTS)), pm.encode(SENTS)
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=ATOL)
    enc = jm.tokenizer(PROMPTS)
    want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    got = pm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("flags", [[], ["--paged", "--page_size", "64"], ["--kv_quant"]],
                         ids=["dense", "paged", "kv_quant"])
def test_serve_cli_float32_matches_jax(tmp_path, bf16_checkpoint, flags):
    """`serve --model_name_or_path <bf16 checkpoint> --dtype float32 --device
    cpu` (dense, paged and int8-KV pools): the JAX CLI's summary and line
    schema at --dtype float32 and its greedy tokens; the embedding within
    ATOL of the JAX model's fp32 encode. (Not of the JAX CLI's: it passes
    its engine embed_causal=(attn[:2] == "bb"), the opposite of its model's
    embed_causal, and embeds with causal attention; the port's CLI takes
    the model's.)"""
    reqs = tmp_path / "reqs.jsonl"
    rows = [{"id": "g0", "prompt": "<s><|user|>\nHi\n<|assistant|>\n", "max_new_tokens": 5},
            {"id": "g1", "prompt": "<s><|user|>\nName a city\n<|assistant|>\n"},
            {"id": "e0", "type": "embed", "text": "a passage to embed"}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model_name_or_path", str(bf16_checkpoint), "--dtype", "float32",
              "--requests", str(reqs), "--slots", "2", "--max_len", "128", "--prompt_buckets",
              "64", "--max_new_tokens", "4", *flags]
    want_summary = jax_serve.main(common + ["--out", str(tmp_path / "jax.jsonl")])
    got_summary = port_serve.main(common + ["--device", "cpu", "--out",
                                            str(tmp_path / "port.jsonl")])
    assert sorted(got_summary) == sorted(want_summary)
    for key in ("requests", "completions", "embeddings"):
        assert got_summary[key] == want_summary[key]

    def lines(path):
        return {r["id"]: r for r in map(json.loads, path.read_text().splitlines())}

    want, got = lines(tmp_path / "jax.jsonl"), lines(tmp_path / "port.jsonl")
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    for rid in ("g0", "g1"):
        assert got[rid]["token_ids"] == want[rid]["token_ids"], rid
    jm = JaxGritLM.from_pretrained(str(bf16_checkpoint), dtype="float32")
    np.testing.assert_allclose(got["e0"]["embedding"],
                               np.asarray(jm.encode(["a passage to embed"]))[0], atol=ATOL)


# ---------------------------------------------------------------- what stays out


@pytest.mark.parametrize("dtype,device,raises", [
    ("float32", "cuda", True), ("float32", "cuda:1", True), ("float32", "cpu", False),
    ("bfloat16", "cuda", False), (None, "cuda", False), ("float32", "cpu", True),
    ("bfloat16", "cuda:1", True),
])
def test_fp32_training_on_cuda_is_not_ported(dtype, device, raises):
    """`training.run --dtype float32` on CUDA passes `check_ported` (K4 and
    K5 have their fp32 forms), as every dtype does on every device; what
    is still not ported, a mesh of more than one device (`raises`: the run
    asks for mesh_data 2), raises NotImplementedError citing Queue 1 item
    12 whatever the dtype and device."""
    RunArguments(dtype=dtype, device=device).check_ported()
    args = RunArguments(dtype=dtype, device=device, mesh_data=2 if raises else 1)
    if raises:
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            args.check_ported()
    else:
        args.check_ported()


def test_no_entry_point_enables_tf32():
    """No module of the port turns TF32 on: an fp32 path's torch.matmul
    products stay true fp32 (torch's default, allow_tf32 False)."""
    pattern = re.compile(r"allow_tf32\s*=\s*True|set_float32_matmul_precision|"
                         r"allow_fp16_reduced_precision_reduction\s*=\s*True")
    hits = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert hits == []
