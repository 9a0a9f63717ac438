"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: a CUDA kernel has no CPU mode, so these skip on a machine
without a CUDA device (the CPU suite holds the plain versions against the
JAX package in tests/test_torch_kernels.py). On a GPU machine (where
tests/conftest.py cannot import jax):

    python -m pytest tests/test_torch_gpu.py --noconftest

Tolerances are for bf16: the kernels round probabilities to bf16 before
P.V (K1) and outputs to bf16, where the plain versions keep fp32 until the
last cast; attention outputs here are of order 0.1-1.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.ops import decode_attention, flash_attention, fused_pool

pytestmark = pytest.mark.gpu
ATTN_ATOL = 2e-2
LSE_ATOL = 1e-3  # fp32 log-sum-exp of the same bf16 scores, summed in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.parametrize("causal,window,offset,Sq", [
    (False, None, 0, 200), (True, None, 0, 200), (True, 64, 0, 200), (True, None, 128, 77),
])
def test_flash_attention_kernel(cuda, causal, window, offset, Sq):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, Sk, H, Hkv = 2, 333, 8, 2
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    k = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    v = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[1, 290:] = 0
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, mask, causal=causal,
                                          sliding_window=window, offset=offset)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_plain(q, k, v, mask, causal=causal,
                                                 sliding_window=window, offset=offset)
    assert flash_attention.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)


def test_flash_attention_kernel_on_cache_view(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    k_all = _randn(gen, 2, 2, 384, 256, device=cuda)
    v_all = _randn(gen, 2, 2, 384, 256, device=cuda)
    q = _randn(gen, 2, 130, 8, 128, device=cuda)
    mask = (torch.arange(384, device=cuda) < 250).int()[None].repeat(2, 1)
    lk, lv = k_all[1].view(2, 384, 2, 128), v_all[1].view(2, 384, 2, 128)
    got = flash_attention.flash_attention(q, lk, lv, mask, causal=True, offset=120)
    want = flash_attention.flash_attention_plain(q, lk, lv, mask, causal=True, offset=120)
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)


def _k1_against_plain(q, k, v, mask, **kw):
    """K1 (output and LSE) against its plain version, a rerun bit-equal;
    returns the kernel's (output, LSE)."""
    out, lse = flash_attention.flash_attention(q, k, v, mask, return_lse=True, **kw)
    out2, lse2 = flash_attention.flash_attention(q, k, v, mask, return_lse=True, **kw)
    torch.cuda.synchronize()
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, mask, return_lse=True, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=ATTN_ATOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    return out, lse


# query lengths off the 128-row blocks against key lengths off the 128-key
# tiles; causal rows sit at the end of the keys (a prefill over a cache)
@pytest.mark.parametrize("Sq", [1, 77, 129, 200])
@pytest.mark.parametrize("Sk", [64, 333, 2048])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 64)])
def test_flash_attention_kernel_edges(cuda, Sq, Sk, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, H, Hkv = 2, 8, 2
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    k = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    v = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[1, Sk * 3 // 4:] = 0
    _k1_against_plain(q, k, v, mask, causal=causal, sliding_window=window,
                      offset=max(0, Sk - Sq) if causal else 0)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_hole_and_empty_row(cuda, group, causal):
    """GQA groups 1 and 4, an interior hole in the keys (concatenated RAG
    caches) and a row whose keys are all masked: output 0, LSE NEG_INF."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, H = 2, 300, 8
    q = _randn(gen, B, S, H, 128, device=cuda)
    k = _randn(gen, B, S, H // group, 128, device=cuda)
    v = _randn(gen, B, S, H // group, 128, device=cuda)
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[0, 100:190] = 0
    mask[1] = 0
    out, lse = _k1_against_plain(q, k, v, mask, causal=causal)
    assert torch.count_nonzero(out[1]) == 0 and bool((lse[1] == flash_attention.NEG_INF).all())


def test_flash_attention_kernel_rows_with_and_without_keys(cuda):
    """A 32-key window at offset 256 over keys 200-399 masked: in one block
    some rows see keys and others none (output 0, LSE NEG_INF), and a row
    with no key never turns into exp(0) = 1."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, Sq, Sk, H, Hkv = 2, 256, 512, 8, 2
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    k = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    v = _randn(gen, B, Sk, Hkv, 128, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[:, 200:400] = 0
    out, lse = _k1_against_plain(q, k, v, mask, causal=True, sliding_window=32, offset=256)
    empty = slice(0, 400 - 256)  # rows at positions 256-399 see only masked keys
    assert torch.count_nonzero(out[:, empty]) == 0
    assert bool((lse[:, :, empty] == flash_attention.NEG_INF).all())
    assert bool((lse[:, :, 400 - 256 + 31:] > flash_attention.NEG_INF).all())


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Sq,offset,window", [(1, 299, None), (7, 290, None), (3, 250, 64)])
def test_flash_decode_kernel(cuda, Sq, offset, window, quant):
    from gritlm_tpu_torch.models.transformer import quantize_kv

    gen = torch.Generator(device=cuda).manual_seed(2)
    L, B, Smax, H, Hkv = 2, 3, 512, 8, 2
    k_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    v_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    scales = {}
    if quant:
        k8, ks = quantize_kv(k_all.view(L * B, Smax, Hkv, 128))
        v8, vs = quantize_kv(v_all.view(L * B, Smax, Hkv, 128))
        k_all, v_all = k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1)
        scales = {"k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
                  "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()}
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    mask = (torch.rand((B, Smax), generator=gen, device=cuda) > 0.3).int()
    mask[:, offset + Sq:] = 0
    mask[2] = 0  # an empty row stays finite (zero)
    got = decode_attention.flash_decode(q, k_all, v_all, mask, causal=True, offset=offset,
                                        layer=1, sliding_window=window, **scales)
    torch.cuda.synchronize()
    want = decode_attention.flash_decode_plain(q, k_all, v_all, mask, causal=True,
                                               offset=offset, layer=1, sliding_window=window,
                                               **scales)
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)
    assert torch.count_nonzero(got[2]) == 0


def _int8_cache(k_all, v_all, Hkv, Dh=128):
    """The bf16 cache as int8 with slot-minor bf16 scales [L, B, Kv, Smax]."""
    from gritlm_tpu_torch.models.transformer import quantize_kv

    L, B, Smax, _ = k_all.shape
    k8, ks = quantize_kv(k_all.view(L * B, Smax, Hkv, Dh))
    v8, vs = quantize_kv(v_all.view(L * B, Smax, Hkv, Dh))
    return k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1), {
        "k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
        "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()}


def _k3_against_plain(q, k_all, v_all, mask, **kw):
    """K3 against its plain version, one launch a call, a rerun bit-equal;
    returns the kernel's output."""
    before = decode_attention.flash_decode.launches
    got = decode_attention.flash_decode(q, k_all, v_all, mask, **kw)
    again = decode_attention.flash_decode(q, k_all, v_all, mask, **kw)
    torch.cuda.synchronize()
    want = decode_attention.flash_decode_plain(q, k_all, v_all, mask, **kw)
    assert decode_attention.flash_decode.launches == before + 2
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_kernel_serving_shape(cuda, quant):
    """The serving decode chunk's call: B 8, Smax 4096, mask-bounded
    (causal False, offset 0), rows of 0, 1, 31, 33 and 4096 valid slots and
    three with interior holes; the empty row gives zeros."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    L, B, Smax, H, Hkv = 2, 8, 4096, 32, 8
    k_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    v_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    scales = {}
    if quant:
        k_all, v_all, scales = _int8_cache(k_all, v_all, Hkv)
    lens = torch.tensor([0, 1, 31, 33, 4096, 300, 1900, 17], device=cuda)
    mask = (torch.arange(Smax, device=cuda)[None] < lens[:, None]).int()
    mask[5, 100:180] = 0  # interior holes, one a whole 16-slot tile or more
    mask[6, 16:1500] = 0
    mask[7, 3:9] = 0
    q = _randn(gen, B, 1, H, 128, device=cuda)
    got = _k3_against_plain(q, k_all, v_all, mask, causal=False, layer=1, num_kv_heads=Hkv,
                            **scales)
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("Sq", [1, 7, 64])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_flash_decode_kernel_groups_and_rows(cuda, group, Sq, window, quant):
    """GQA groups 1, 4 and 8 (one to eight query rows a unit and several
    units at Sq 64), causal at an offset with and without a window, holes,
    a row with no valid slot (zeros), bf16 and int8 caches."""
    gen = torch.Generator(device=cuda).manual_seed(10 + group + Sq)
    L, B, Smax, Hkv = 2, 3, 1000, 2
    H = group * Hkv
    k_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    v_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    scales = {}
    if quant:
        k_all, v_all, scales = _int8_cache(k_all, v_all, Hkv)
    offset = 700 - Sq
    mask = (torch.rand((B, Smax), generator=gen, device=cuda) > 0.25).int()
    mask[:, offset + Sq:] = 0
    mask[1, :40] = 0  # left padding
    mask[2] = 0
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    got = _k3_against_plain(q, k_all, v_all, mask, causal=True, offset=offset, layer=1,
                            sliding_window=window, num_kv_heads=Hkv, **scales)
    assert torch.count_nonzero(got[2]) == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("Sq", [1, 8, 64])
def test_flash_decode_kernel_per_row_offsets(cuda, Sq, window, quant):
    """K3 with a [B] tensor of offsets (the speculative verify chunk): each
    row's causal bound and window from its own offset, rows at offsets 0,
    near the end and in between over holes, a row with no valid slot
    (zeros); one launch a call, counted as a per-row-offset launch, bit-equal
    reruns; each row equals its own call at an int offset."""
    gen = torch.Generator(device=cuda).manual_seed(30 + Sq)
    L, B, Smax, H, Hkv = 2, 5, 1024, 16, 4
    k_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    v_all = _randn(gen, L, B, Smax, Hkv * 128, device=cuda)
    scales = {}
    if quant:
        k_all, v_all, scales = _int8_cache(k_all, v_all, Hkv)
    offs = torch.tensor([0, 1024 - Sq, 300, 777, 50], dtype=torch.int32, device=cuda)
    mask = (torch.rand((B, Smax), generator=gen, device=cuda) > 0.2).int()
    mask[4] = 0
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    kw = dict(causal=True, layer=1, sliding_window=window, num_kv_heads=Hkv, **scales)
    rows_before = decode_attention.flash_decode.row_offset_launches
    got = _k3_against_plain(q, k_all, v_all, mask, offset=offs, **kw)
    assert decode_attention.flash_decode.row_offset_launches == rows_before + 2
    assert torch.count_nonzero(got[4]) == 0
    for b in range(B):
        row = {n: s[:, b:b + 1].contiguous() for n, s in scales.items()}
        alone = decode_attention.flash_decode(
            q[b:b + 1].contiguous(), k_all[:, b:b + 1].contiguous(),
            v_all[:, b:b + 1].contiguous(), mask[b:b + 1].contiguous(), offset=int(offs[b]),
            **{**kw, **row})
        torch.testing.assert_close(alone.float(), got[b:b + 1].float(), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_per_row_offsets_bit_equal_to_paged(cuda, quant):
    """K3 with per-row offsets and K8 at the causal Sq 8 verify chunk on the
    same logical cache (the pool gathered dense): one kernel body and one
    plan over the logical width, so bit-equal."""
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=cuda).manual_seed(22)
    L, B, H, Hkv, page, maxp, Sq = 2, 8, 32, 8, 256, 16, 8
    P = B * maxp + 1
    k = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    v = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(2))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(cuda)
    lens = torch.tensor([37, 1900, 256, 700, 1333, 3000, 8, 512], device=cuda)
    mask = (torch.arange(maxp * page, device=cuda)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0
    offs = (lens - Sq).to(torch.int32)
    k_d = torch.stack([paged_attention.gather_pages(k, pt, i) for i in range(L)])
    v_d = torch.stack([paged_attention.gather_pages(v, pt, i) for i in range(L)])
    scales, dense_scales = {}, {}
    if quant:
        k_d, v_d, dense_scales = _int8_cache(k_d, v_d, Hkv)
        inv = torch.empty(P, dtype=torch.long, device=cuda)
        inv[pt.long().reshape(-1)] = torch.arange(B * maxp, device=cuda)
        inv[0] = 0
        k = k_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
        v = v_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
        scales = {n: s.view(L, B, Hkv, maxp, page).transpose(2, 3).reshape(
            L, B * maxp, Hkv, page)[:, inv].contiguous() for n, s in dense_scales.items()}
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    got = paged_attention.paged_decode(q, k, v, pt, mask, layer=1, num_kv_heads=Hkv,
                                       causal=True, offset=offs, **scales)
    want = decode_attention.flash_decode(q, k_d, v_d, mask, causal=True, offset=offs, layer=1,
                                         num_kv_heads=Hkv, **dense_scales)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_speculative_and_sampling_serving_on_cuda(cuda):
    """Speculative pools (dense: K3 with per-row offsets in the verify
    chunks; paged: K8 at causal Sq k + 1) serve every request, each token
    within TIE of its position's largest logit in one teacher-forced forward
    (the LM head scaled so logits spread over a few units: bf16 routes that
    sum attention in another order may flip only near ties); a sampling
    pool's streams are equal between a dense and a paged pool and across
    two runs."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.models.transformer import forward, logits_from_hidden
    from gritlm_tpu_torch.ops import paged_attention
    from gritlm_tpu_torch.serving import Request, ServingEngine

    TIE = 0.1
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    m = GritLM(cfg)
    m.params["lm_head"]["kernel"].mul_(4)
    prompts = {str(n): [3 + (i * 7) % 11 for i in range(n)] for n in (5, 40, 70, 9, 130)}
    kw = dict(max_batch=3, max_len=512, chunk_size=4, prompt_buckets=(128, 256), page_size=128)

    def run(**extra):
        reqs = [Request(input_ids=ids, max_new_tokens=12, request_id=rid,
                        temperature=0.8 if extra.get("sampling") else 0.0, top_p=0.9,
                        seed=len(ids)) for rid, ids in prompts.items()]
        done = ServingEngine(cfg, m.params, **kw, **extra).run(reqs)
        assert sorted(c.request_id for c in done) == sorted(prompts)
        assert all(0 < len(c.token_ids) <= 12 for c in done)
        return {c.request_id: c.token_ids for c in done}

    for paged in (False, True):
        before = (decode_attention.flash_decode.row_offset_launches,
                  paged_attention.paged_decode.launches)
        spec = run(speculative=True, spec_k=7, spec_ngram=2, paged=paged)
        if paged:
            assert paged_attention.paged_decode.launches > before[1]
        else:
            assert decode_attention.flash_decode.row_offset_launches > before[0]
        for rid, toks in spec.items():
            ids = prompts[rid]
            x = torch.tensor([ids + toks], dtype=torch.int32, device=cuda)
            with torch.inference_mode():
                hidden, _, _ = forward(m.params, cfg, x, causal=True)
                logits = logits_from_hidden(m.params, cfg, hidden)[0, len(ids) - 1:-1].float()
            chosen = logits.gather(1, torch.tensor(toks, device=cuda)[:, None])[:, 0]
            assert float((logits.max(1).values - chosen).max()) <= TIE, rid
    sampled = run(sampling=True)
    assert sampled == run(sampling=True, paged=True) == run(sampling=True)


# (B, S, D, strided): a ragged batch, one long row over the whole card, many
# short rows, the Qwen2-7B width (D 3584, no multiple of 256), rows that are
# views into wider ones (a [B, S, 2D] buffer's first half), D 8192
POOL_SHAPES = [(3, 700, 4096, False), (1, 4096, 4096, False), (64, 128, 4096, False),
               (8, 512, 3584, False), (8, 300, 4096, True), (2, 1000, 8192, False),
               (3, 40, 256, False)]


@pytest.mark.parametrize("method", ["mean", "weightedmean"])
@pytest.mark.parametrize("B,S,D,strided", POOL_SHAPES)
def test_fused_pool_kernel(cuda, method, B, S, D, strided):
    """K2 against its plain version: ragged masks (a masked prefix,
    padding, one row of a single token, one empty row that must come out
    zero), normalized and not, one launch a call, and a rerun bit-equal
    (the merges sum in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(B * S + D)
    base = _randn(gen, B, S, 2 * D if strided else D, device=cuda)
    hidden = base[..., :D] if strided else base
    gamma = (1 + 0.5 * torch.randn(D, generator=gen, device=cuda)).to(torch.bfloat16)
    mask = (torch.rand((B, S), generator=gen, device=cuda) < 0.9).int()
    mask[0, : S // 7] = 0
    mask[0, S * 5 // 7:] = 0
    if B > 1:
        mask[1] = 0
        mask[1, S // 2] = 1
    if B > 2:
        mask[2] = 0
    for normalized in (True, False):
        kw = dict(eps=1e-5, method=method, normalized=normalized)
        before = fused_pool.fused_norm_mean_pool.launches
        got = fused_pool.fused_norm_mean_pool(hidden, gamma, mask, **kw)
        again = fused_pool.fused_norm_mean_pool(hidden, gamma, mask, **kw)
        torch.cuda.synchronize()
        assert fused_pool.fused_norm_mean_pool.launches == before + 2
        want = fused_pool.fused_norm_mean_pool_plain(hidden, gamma, mask, **kw)
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
        if B > 2:
            assert torch.count_nonzero(got[2]) == 0


def _unit_rows(gen, n, d, device):
    x = torch.randn((n, d), generator=gen, device=device)
    return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


# the chip_smoke shapes: a masked tail; Q not a multiple of 8; a partial
# last segment (N not a multiple of 128)
@pytest.mark.parametrize("Q,N,n_docs", [(256, 65536, 65000), (3, 65536, 65536),
                                        (5, 65536 + 300, 65536 + 250)])
def test_scores_segmax_kernel(cuda, Q, N, n_docs):
    """fp32 sums of the same bf16 products in another order: 1e-3 absolute
    on unit vectors. Each segment maximum is exactly the largest of the
    kernel's own scores in its segment, -inf where every column is masked."""
    from gritlm_tpu_torch.ops import scores_segmax as k9

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, emb = _unit_rows(gen, Q, 4096, cuda), _unit_rows(gen, N, 4096, cuda)
    before = k9.scores_segmax.launches
    got_s, got_m = k9.scores_segmax(q, emb, n_docs)
    torch.cuda.synchronize()
    want_s, want_m = k9.scores_segmax_plain(q, emb, n_docs)
    assert k9.scores_segmax.launches == before + 1
    assert got_m.shape == want_m.shape == (-(-N // 128), Q)
    assert torch.isinf(got_s[:, n_docs:]).all() and (got_s[:, n_docs:] < 0).all()
    torch.testing.assert_close(got_s[:, :n_docs], want_s[:, :n_docs], atol=1e-3, rtol=0)
    ns = -(-N // 128)
    own = torch.nn.functional.pad(got_s, (0, ns * 128 - N), value=float("-inf"))
    assert torch.equal(got_m, own.view(Q, ns, 128).amax(-1).T)
    finite = torch.isfinite(want_m)
    assert torch.equal(finite, torch.isfinite(got_m))
    torch.testing.assert_close(got_m[finite], want_m[finite], atol=1e-3, rtol=0)


# K9's edges: one row, the RAG path's 4, a query block of 65 rows, a full
# block and more than a block (two launches' worth of query blocks); a
# partial last segment, and n_docs inside a segment
@pytest.mark.parametrize("Q", [1, 4, 65, 256, 300])
@pytest.mark.parametrize("N,n_docs", [(65536 + 300, 65536 + 250), (65536, 65037)])
def test_scores_segmax_kernel_edges(cuda, Q, N, n_docs):
    from gritlm_tpu_torch.ops import scores_segmax as k9

    gen = torch.Generator(device=cuda).manual_seed(9)
    q, emb = _unit_rows(gen, Q, 4096, cuda), _unit_rows(gen, N, 4096, cuda)
    got_s, got_m = k9.scores_segmax(q, emb, n_docs)
    again_s, again_m = k9.scores_segmax(q, emb, n_docs)
    torch.cuda.synchronize()
    want_s, want_m = k9.scores_segmax_plain(q, emb, n_docs)
    assert torch.equal(got_s, again_s) and torch.equal(got_m, again_m)
    assert torch.isinf(got_s[:, n_docs:]).all() and (got_s[:, n_docs:] < 0).all()
    torch.testing.assert_close(got_s[:, :n_docs], want_s[:, :n_docs], atol=1e-3, rtol=0)
    ns = -(-N // 128)
    own = torch.nn.functional.pad(got_s, (0, ns * 128 - N), value=float("-inf"))
    assert torch.equal(got_m, own.view(Q, ns, 128).amax(-1).T)
    finite = torch.isfinite(want_m)
    assert torch.equal(finite, torch.isfinite(got_m))
    torch.testing.assert_close(got_m[finite], want_m[finite], atol=1e-3, rtol=0)


# K9 [f32] at chip_smoke's phase-2 shapes, plus a depth that is not a
# multiple of the 32-deep stage and a query block past 64 rows
@pytest.mark.parametrize("Q,N,D,n_docs", [(256, 65536, 4096, 65000), (3, 65536, 4096, 65536),
                                          (256, 65536 + 300, 4096, 65536 + 250),
                                          (65, 1000, 100, 990)])
def test_scores_segmax_f32_kernel(cuda, Q, N, D, n_docs):
    """Exact fp32 products summed in another order: 1e-5 absolute on unit
    vectors; an exact -inf tail; each segment maximum the largest of the
    kernel's own scores in its segment; a rerun bit-equal; the fp32 kernel
    counted in f32_launches, not in the bf16 kernel's launches."""
    from gritlm_tpu_torch.ops import scores_segmax as k9

    gen = torch.Generator(device=cuda).manual_seed(6)

    def unit(n):
        x = torch.randn((n, D), generator=gen, device=cuda)
        return x / x.norm(dim=-1, keepdim=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    q, emb = unit(Q), unit(N)
    before = (k9.scores_segmax.launches, k9.scores_segmax.f32_launches)
    got_s, got_m = k9.scores_segmax(q, emb, n_docs)
    again_s, again_m = k9.scores_segmax(q, emb, n_docs)
    torch.cuda.synchronize()
    want_s, want_m = k9.scores_segmax_plain(q, emb, n_docs)
    assert (k9.scores_segmax.launches, k9.scores_segmax.f32_launches) == (before[0],
                                                                          before[1] + 2)
    assert torch.equal(got_s, again_s) and torch.equal(got_m, again_m)
    assert torch.isneginf(got_s[:, n_docs:]).all()
    torch.testing.assert_close(got_s[:, :n_docs], want_s[:, :n_docs], atol=1e-5, rtol=0)
    ns = -(-N // 128)
    own = torch.nn.functional.pad(got_s, (0, ns * 128 - N), value=float("-inf"))
    assert torch.equal(got_m, own.view(Q, ns, 128).amax(-1).T)
    finite = torch.isfinite(want_m)
    assert torch.equal(finite, torch.isfinite(got_m))
    torch.testing.assert_close(got_m[finite], want_m[finite], atol=1e-5, rtol=0)


def test_scores_segmax_rejects_on_cuda(cuda):
    """Mixed or fp16 operands raise TypeError; an fp32 depth off 16-byte
    rows raises NotImplementedError."""
    from gritlm_tpu_torch.ops import scores_segmax as k9

    q32, e32 = torch.zeros((4, 64), device=cuda), torch.zeros((300, 64), device=cuda)
    for q, e in ((q32, e32.bfloat16()), (q32.half(), e32.half())):
        with pytest.raises(TypeError):
            k9.scores_segmax(q, e, 300)
    with pytest.raises(NotImplementedError):
        k9.scores_segmax(q32[:, :62], e32[:, :62].contiguous(), 300)


def _narrow_model(**kw):
    from gritlm_tpu_torch import GritLM

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    return GritLM(cfg, **kw)


def test_evaluate_retrieval_on_cuda(cuda):
    """The retrieval eval on the card: an fp32 index searched by K9 [f32]
    (the bf16 kernel not launched), self-retrieval of planted queries, the
    reranker's forward through K1 and its head above the tail."""
    from gritlm_tpu_torch.eval.rerank import GenerativeReranker
    from gritlm_tpu_torch.eval.retrieval import evaluate_retrieval
    from gritlm_tpu_torch.ops import scores_segmax as k9

    m = _narrow_model()
    corpus = {f"d{i}": {"title": f"t{i}", "text": f"passage {i} " + "word " * (2 + 3 * i)}
              for i in range(40)}
    queries = {f"q{i}": corpus[f"d{i}"]["title"] + " " + corpus[f"d{i}"]["text"]
               for i in range(8)}
    qrels = {f"q{i}": {f"d{i}": 1} for i in range(8)}
    before = (k9.scores_segmax.launches, k9.scores_segmax.f32_launches,
              flash_attention.flash_attention.launches, fused_pool.fused_norm_mean_pool.launches)
    metrics = evaluate_retrieval(m, corpus, queries, qrels, max_length=128, top_k=10,
                                 k_values=(1, 10),
                                 reranker=GenerativeReranker(m, max_length=256), rerank_depth=4)
    after = (k9.scores_segmax.launches, k9.scores_segmax.f32_launches,
             flash_attention.flash_attention.launches, fused_pool.fused_norm_mean_pool.launches)
    assert after[0] == before[0] and after[1] > before[1]
    assert after[2] > before[2] and after[3] > before[3]
    assert metrics["recall_at_1"] == 1.0 and metrics["rerank_recall_at_10"] == 1.0


def test_verify_checkpoint_on_cuda(cuda, tmp_path, capsys):
    """verify-checkpoint on a narrow bf16 checkpoint on the card: a verdict
    whose transformers leg (where installed) is within the bf16 tolerance
    chip_smoke uses, fixture cosines in [-1, 1], the retrieval smoke run."""
    import json

    from gritlm_tpu_torch import tools
    from gritlm_tpu_torch.models.loader import save_checkpoint

    m = _narrow_model()
    cfg = dataclasses.replace(m.config, dtype="bfloat16")
    save_checkpoint(str(tmp_path), cfg, m.params)
    before = fused_pool.fused_norm_mean_pool.launches
    tools.main(["verify-checkpoint", "--model", str(tmp_path), "--parity_tol", "0.05"])
    v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert v["ok"] and v["load"]["ok"] and v["load"]["dtype"] == "bfloat16"
    assert all(-1.0 <= x <= 1.0 for x in v["cosine_fixture"]["sims"])
    assert v["retrieval_smoke"]["n_docs"] == 18
    assert fused_pool.fused_norm_mean_pool.launches > before


@pytest.mark.parametrize("n_docs,Q,k", [(70000, 256, 100), (300, 3, 5)])
def test_flat_index_search_on_cuda(cuda, n_docs, Q, k):
    """FlatIndex.search on the card goes through K9 and returns the values
    of a plain top-k of the kernel's inputs (pruned path; tiny corpus)."""
    from gritlm_tpu_torch.index import FlatIndex
    from gritlm_tpu_torch.ops import scores_segmax as k9

    gen = torch.Generator(device=cuda).manual_seed(5)
    docs, q = _unit_rows(gen, n_docs, 4096, cuda), _unit_rows(gen, Q, 4096, cuda)
    idx = FlatIndex(4096, n_docs, device=cuda)
    idx.add(docs[: n_docs // 2])
    idx.add(docs[n_docs // 2:])
    before = k9.scores_segmax.launches
    scores, ids = idx.search(q, k=k)
    assert k9.scores_segmax.launches == before + 1
    want = torch.topk(q.float() @ docs.float().T, k, dim=1)
    torch.testing.assert_close(torch.from_numpy(scores), want.values.cpu(), atol=1e-3, rtol=0)
    got_vals = (q.float() @ docs.float().T).gather(1, torch.from_numpy(ids).long().to(cuda))
    torch.testing.assert_close(got_vals.cpu(), want.values.cpu(), atol=1e-3, rtol=0)


def test_gritlm_runs_its_kernels(cuda):
    from gritlm_tpu_torch import GritLM

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    m = GritLM(cfg, kv_quant=True)
    counts = [f.launches for f in (flash_attention.flash_attention,
                                   decode_attention.flash_decode,
                                   fused_pool.fused_norm_mean_pool)]
    emb = m.encode(["hello world", "a longer sentence to embed"], instruction="<|embed|>\n")
    out = m.generate(["Hi"], max_new_tokens=4)  # int8 cache through K3
    after = [f.launches for f in (flash_attention.flash_attention,
                                  decode_attention.flash_decode,
                                  fused_pool.fused_norm_mean_pool)]
    assert emb.shape == (2, 256) and isinstance(out, list)
    assert all(a > b for a, b in zip(after, counts))


def test_rag_engine_on_cuda(cuda):
    """The RAG path on the card: every cache mode answers, search goes
    through K9 and generation through K3, and the device pool gives the
    host fetch's greedy answers."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.ops import scores_segmax as k9
    from gritlm_tpu_torch.rag import CacheMode, RAGEngine

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    m = GritLM(cfg)
    docs = [{"title": f"t{i}", "text": f"passage {i} " + "word " * (2 + 3 * i)}
            for i in range(6)]
    eng = RAGEngine(m, max_new_tokens=4, encode_max_length=128)
    eng.build_index(docs, batch_size=4, cache_docs=True)
    assert eng._device_pool[False] is not None
    before = (k9.scores_segmax.launches, decode_attention.flash_decode.launches)
    queries = [docs[2]["title"] + " " + docs[2]["text"], "what is passage 4?"]
    for mode in CacheMode:
        res = eng.answer_batch(queries, mode=mode)
        assert len(res) == 2 and all(isinstance(r.answer, str) for r in res)
    assert k9.scores_segmax.launches > before[0]
    assert decode_attention.flash_decode.launches > before[1]
    host = RAGEngine(m, max_new_tokens=4, encode_max_length=128, doc_pool_bytes=0)
    host.index, host._doc_store = eng.index, eng._doc_store
    got = [r.answer for r in eng.answer_batch(queries, mode="doc")]
    assert [r.answer for r in host.answer_batch(queries, mode="doc")] == got


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page", [32, 256])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("Sq,causal", [(1, False), (7, True), (8, True), (64, True)])
def test_paged_decode_kernel(cuda, quant, page, group, Sq, causal):
    """K8 over a shuffled page pool: GQA groups 1, 4 and 8, ragged rows, a
    hole, a page shared by two rows, an empty row (0), causal chunks of 7,
    8 and 64 queries at per-row offsets, pages of 32 and 256 slots, bf16
    and int8 pages; one launch a call, a rerun bit-equal."""
    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=cuda).manual_seed(6 + page + group + Sq)
    L, B, Hkv, maxp = 2, 4, 2, 1024 // page
    H = group * Hkv
    P = B * maxp + 2
    k = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    v = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    scales = {}
    if quant:
        k8, ks = quantize_kv(k.view(L * P, page, Hkv, 128))
        v8, vs = quantize_kv(v.view(L * P, page, Hkv, 128))
        k, v = k8.view(L, P, page, -1), v8.view(L, P, page, -1)
        scales = {"k_scale": ks.view(L, P, page, Hkv).transpose(2, 3).contiguous(),
                  "v_scale": vs.view(L, P, page, Hkv).transpose(2, 3).contiguous()}
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(cuda)
    pt[2, 0] = pt[0, 0]  # a shared prefix page
    lens = torch.tensor([5, maxp * page, 131, 0], device=cuda)
    mask = (torch.arange(maxp * page, device=cuda)[None] < lens[:, None]).int()
    mask[1, 7:40] = 0  # a hole
    mask[1, 300:333] = 0
    offs = (lens - Sq).clamp_min(0).to(torch.int32)
    q = _randn(gen, B, Sq, H, 128, device=cuda)
    kw = dict(layer=1, num_kv_heads=Hkv, causal=causal, offset=offs, **scales)
    before = paged_attention.paged_decode.launches
    got = paged_attention.paged_decode(q, k, v, pt, mask, **kw)
    again = paged_attention.paged_decode(q, k, v, pt, mask, **kw)
    torch.cuda.synchronize()
    want = paged_attention.paged_decode_plain(q, k, v, pt, mask, **kw)
    assert paged_attention.paged_decode.launches == before + 2
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)
    assert torch.equal(got, again)  # the split merge in split order: bit-equal reruns
    assert torch.count_nonzero(got[3]) == 0


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_matches_flash_decode(cuda, quant):
    """K8 and K3 on the same logical cache (the pool gathered dense), the
    serving step's call (Sq 1, mask-bounded): one kernel body, so the same
    folds; within ATTN_ATOL of each other."""
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=cuda).manual_seed(21)
    L, B, H, Hkv, page, maxp = 2, 8, 32, 8, 256, 16
    P = B * maxp + 1
    k = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    v = _randn(gen, L, P, page, Hkv * 128, device=cuda)
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(1))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(cuda)
    lens = torch.tensor([37, 1900, 256, 700, 1333, 3000, 1, 512], device=cuda)
    mask = (torch.arange(maxp * page, device=cuda)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0
    scales, dense_scales = {}, {}
    if quant:
        k_d = torch.stack([paged_attention.gather_pages(k, pt, i) for i in range(L)])
        v_d = torch.stack([paged_attention.gather_pages(v, pt, i) for i in range(L)])
        k_d, v_d, dense_scales = _int8_cache(k_d, v_d, Hkv)
        # the same int8 values and scales, laid out as pages again
        inv = torch.empty(P, dtype=torch.long, device=cuda)
        inv[pt.long().reshape(-1)] = torch.arange(B * maxp, device=cuda)
        inv[0] = 0
        k = k_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
        v = v_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
        scales = {n: s.view(L, B, Hkv, maxp, page).transpose(2, 3).reshape(
            L, B * maxp, Hkv, page)[:, inv].contiguous() for n, s in dense_scales.items()}
    else:
        k_d = torch.stack([paged_attention.gather_pages(k, pt, i) for i in range(L)])
        v_d = torch.stack([paged_attention.gather_pages(v, pt, i) for i in range(L)])
    q = _randn(gen, B, 1, H, 128, device=cuda)
    got = paged_attention.paged_decode(q, k, v, pt, mask, layer=1, num_kv_heads=Hkv, **scales)
    want = decode_attention.flash_decode(q, k_d, v_d, mask, causal=False, layer=1,
                                         num_kv_heads=Hkv, **dense_scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)


def test_serving_engine_runs_its_kernels(cuda):
    """Dense and paged pools on the card: every request completes, K3
    serves the dense decode and K8 the paged one."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.ops import paged_attention
    from gritlm_tpu_torch.serving import Request, ServingEngine

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    m = GritLM(cfg)
    reqs = [Request(input_ids=list(range(3, 3 + n)), max_new_tokens=6, request_id=str(n))
            for n in (5, 40, 70, 9, 130)]
    for paged in (False, True):
        before = (decode_attention.flash_decode.launches, paged_attention.paged_decode.launches)
        eng = ServingEngine(cfg, m.params, max_batch=3, max_len=512, chunk_size=4,
                            prompt_buckets=(128, 256), paged=paged, page_size=128)
        done = eng.run(reqs)
        assert sorted(c.request_id for c in done) == sorted(r.request_id for r in reqs)
        assert all(0 < len(c.token_ids) <= 6 for c in done)
        k3 = decode_attention.flash_decode.launches - before[0]
        k8 = paged_attention.paged_decode.launches - before[1]
        assert (k8 > 0 and k3 == 0) if paged else (k3 > 0 and k8 == 0)


# (Sq, Sk, causal, window, offset, fully masked row 0, (H, Hkv), q/k/v as strided views)
BWD_CASES = [(300, 300, True, None, 0, False, (8, 2), False),
             (300, 300, False, None, 0, False, (8, 2), False),
             (256, 256, True, 64, 0, False, (8, 2), False),
             (200, 333, True, None, 100, False, (8, 2), False),
             (256, 256, False, None, 0, True, (8, 2), False),
             # the edges of the kernels' 64-row ring tiles and 128-row blocks (one
             # query row; with one key, dq and dk would be 0 up to rounding)
             (1, 65, False, None, 0, False, (8, 2), False),
             (1, 129, True, None, 128, False, (8, 2), False),
             (63, 63, True, None, 0, False, (8, 2), False),
             (65, 65, False, None, 0, False, (8, 2), False),
             (127, 127, True, None, 0, False, (8, 2), False),
             (129, 129, False, None, 0, False, (8, 2), False),
             (65, 127, False, None, 0, False, (8, 2), False),
             (129, 63, True, None, 0, False, (8, 2), False),
             (200, 333, False, None, 100, False, (8, 2), False),
             (200, 333, True, 64, 100, False, (8, 2), False),
             # the 7B head layout, views into a fused projection, a masked row
             (320, 320, False, None, 0, False, (32, 8), False),
             (320, 320, True, None, 0, False, (32, 8), True),
             (300, 300, True, 64, 0, False, (8, 2), True),
             (129, 129, True, 64, 0, True, (8, 2), False)]


def _bwd_inputs(gen, cuda, Sq, Sk, heads, strided, B=2, rand=_randn, Dh=128):
    H, Hkv = heads
    if strided:  # q, k, v as head slices of one [B, S, H + 2 Hkv, Dh] projection
        assert Sq == Sk
        fused = rand(gen, B, Sq, H + 2 * Hkv, Dh, device=cuda)
        q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    else:
        q = rand(gen, B, Sq, H, Dh, device=cuda)
        k, v = rand(gen, B, Sk, Hkv, Dh, device=cuda), rand(gen, B, Sk, Hkv, Dh, device=cuda)
    do = rand(gen, B, Sq, H, Dh, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[1, Sk - min(40, Sk // 3):] = 0
    return q, k, v, do, mask


@pytest.mark.parametrize("Sq,Sk,causal,window,offset,empty_row,heads,strided", BWD_CASES)
def test_flash_backward_kernels(cuda, Sq, Sk, causal, window, offset, empty_row, heads,
                                strided):
    """K4 and K5 against their plain versions from the same saved LSE, one
    launch each. Tolerance: 2% of the largest gradient (bf16 inputs and
    outputs, P and dS rounded to bf16 before their products); a row with
    no valid key gets exactly zero gradients."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do, mask = _bwd_inputs(gen, cuda, Sq, Sk, heads, strided)
    if empty_row:
        mask[0] = 0
    kw = dict(causal=causal, sliding_window=window, offset=offset)
    out, lse = flash_attention.flash_attention(q, k, v, mask, return_lse=True, **kw)
    before = (flash_attention.flash_attention_bwd_dq.launches,
              flash_attention.flash_attention_bwd_dkv.launches)
    got = flash_attention.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_bwd_dq.launches,
            flash_attention.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.isfinite(g).all()
        tol = 2e-2 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
        if empty_row:
            assert float(g[0].abs().max()) == 0.0


def test_flash_backward_deterministic(cuda):
    """Two launches of K4 and K5 on the same inputs give bit-equal dQ, dK
    and dV (the GQA group is summed inside K5's block, in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do, mask = _bwd_inputs(gen, cuda, 300, 300, (32, 8), False)
    out, lse = flash_attention.flash_attention(q, k, v, mask, causal=True, return_lse=True)
    first = flash_attention.flash_attention_bwd(q, k, v, mask, out, lse, do, causal=True)
    second = flash_attention.flash_attention_bwd(q, k, v, mask, out, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_fn_on_cuda(cuda):
    """Training attention on the card: multi_head_attention under grad goes
    through FlashAttentionFn (K1 with LSE, then K4 and K5), and its
    gradients follow autograd through the plain forward."""
    from gritlm_tpu_torch.ops.attention import multi_head_attention

    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (x.requires_grad_(True) for x in (_randn(gen, 2, 256, 8, 128, device=cuda),
                                                 _randn(gen, 2, 256, 2, 128, device=cuda),
                                                 _randn(gen, 2, 256, 2, 128, device=cuda)))
    mask = torch.ones((2, 256), dtype=torch.int32, device=cuda)
    mask[0, 200:] = 0
    w = _randn(gen, 2, 256, 8, 128, device=cuda).float()
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq,
                flash_attention.flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    out = multi_head_attention(q, k, v, mask, causal=True)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1]
    ref = flash_attention.flash_attention_plain(q, k, v, mask, causal=True)
    want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
    for g, r in zip(got, want):
        torch.testing.assert_close(g.float(), r.float(), rtol=0,
                                   atol=2e-2 * float(r.float().abs().max()))


def test_train_step_runs_its_kernels(cuda):
    """A LoRA train step on the card (bf16, Dh 128, remat): finite losses,
    attention forward and backward through K1, K4 and K5 (K1 twice a layer
    with remat), and the adapters move from step 2 on."""
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training.data import GritCollator
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    coll = GritCollator(ByteTokenizer(), query_max_len=64, passage_max_len=128,
                        generative_max_len=128)
    batch = coll([(("find", f"query {i}"), [("find", f"passage {i}"), ("find", f"junk {i}")],
                   [f"what is {i}?", f"it is {i}"]) for i in range(4)])
    tc = TrainConfig(total_steps=4, warmup_ratio=0.25, learning_rate=1e-3, gc_chunks=2)
    run_step, state, _, _ = make_lora_train_state(cfg, tc, init_params(cfg, 0, device=cuda),
                                                  r=4, alpha=8, device=cuda)
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq,
                flash_attention.flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    for _ in range(2):
        state, m = run_step(state, batch)
    assert all(torch.isfinite(x) for x in (m.loss, m.loss_emb, m.loss_gen, m.grad_norm))
    n = [f.launches - b for f, b in zip(wrappers, before)]
    assert n[1] > 0 and n[1] == n[2] and n[0] >= 2 * n[1]
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


# Mistral-7B's projections: (K, N) of wq/wo, wk/wv, gate/up, down and the LM head
QUANT_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000)]
QUANT_RTOL = 5e-3  # relative Frobenius error, the JAX package's bound for its kernels


def _quant_node(bits, K, N, gen, device, layers=None):
    from gritlm_tpu_torch.training import quant

    shape = (K, N) if layers is None else (layers, K, N)
    w = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    return quant.quantize_kernel(w) if bits == 8 else quant.quantize_kernel_int4(w)


def _rel_err(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", QUANT_SHAPES)
def test_quant_matmul_kernel(cuda, bits, K, N):
    """K6 (w8a16) and K7 (w4a16) against their plain versions at the
    Mistral-7B projections, at decode rows and prefill-chunk rows: K6 at M
    1-17 (its rows kernel and the first row past it) and 64-512 (the staged
    template), K7 at M 1-128; reruns bit-equal."""
    from gritlm_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=cuda).manual_seed(K + N + bits)
    node = _quant_node(bits, K, N, gen, cuda)
    kernel, plain = ((qm.w8a16_matmul, qm.w8a16_matmul_plain) if bits == 8
                     else (qm.w4a16_matmul, qm.w4a16_matmul_plain))
    rows = ((tuple(range(1, 18)) + (64, 128, 256, 512)) if bits == 8
            else (1, 3, 8, 16, 2, 7, 9, 17, 64, 128))
    for M in rows:
        x = _randn(gen, M, K, device=cuda)
        before = kernel.launches
        got = kernel(x, node)
        again = kernel(x, node)
        torch.cuda.synchronize()
        want = plain(x, node)
        assert kernel.launches == before + 2
        assert got.shape == (M, N) and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= QUANT_RTOL, (M, _rel_err(got, want))
        assert torch.equal(got, again), M  # split-K sums in split order: bit-equal reruns


def _one_hot_rows(M, K, device):
    """x rows that pick single contracting rows: both halves' first and last
    rows, group edges and a spread of others (x @ W is then W's rows)."""
    picks = [0, K // 2 - 1, K // 2, K - 1, 31, 32, K // 2 + 33, 1000 % K]
    picks = (picks + list(range(7, K, max(1, K // M))))[:M]
    x = torch.zeros((M, K), dtype=torch.bfloat16, device=device)
    x[torch.arange(M), torch.tensor(picks)] = 1
    return x


@pytest.mark.parametrize("K,N", QUANT_SHAPES + [(4096, 1040)])
def test_w4a16_one_hot_rows_exact(cuda, K, N):
    """K7 against its plain version bit for bit on one-hot x rows: each
    output row is one dequantized weight row, (nibble - 8) * scale rounded
    to bf16. This holds the register fragments' row and column maps and the
    per-weight rounding; N = 1040 leaves a partial column tile."""
    from gritlm_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=cuda).manual_seed(K + N)
    node = _quant_node(4, K, N, gen, cuda)
    for M in (1, 2, 8, 9, 16, 64):
        x = _one_hot_rows(M, K, cuda)
        got = qm.w4a16_matmul(x, node)
        torch.cuda.synchronize()
        assert torch.equal(got, qm.w4a16_matmul_plain(x, node)), M


@pytest.mark.parametrize("K,N", QUANT_SHAPES + [(4096, 1040), (4112, 1040)])
def test_w8a16_one_hot_rows_exact(cuda, K, N):
    """K6 against its plain version bit for bit on one-hot x rows: each
    output row is one int8 weight row times the per-channel scale, rounded
    to bf16. This holds the register fragments' row and column maps, the
    exact int8 -> bf16 conversion and the scale applied once at the end, in
    every routed row range; N = 1040 leaves a partial column tile and
    K = 4112 a short last stage."""
    from gritlm_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=cuda).manual_seed(K + N + 8)
    node = _quant_node(8, K, N, gen, cuda)
    for M in (1, 2, 8, 9, 16, 17, 64, 512):
        x = _one_hot_rows(M, K, cuda)
        got = qm.w8a16_matmul(x, node)
        torch.cuda.synchronize()
        assert torch.equal(got, qm.w8a16_matmul_plain(x, node)), M


@pytest.mark.parametrize("group", [16, 32, 64, 128])
def test_w4a16_groups(cuda, group):
    """Scale groups of 16, 32, 64 and 128 contracting rows: one-hot rows
    exact, random rows within QUANT_RTOL, at decode rows and above."""
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.training import quant

    gen = torch.Generator(device=cuda).manual_seed(group)
    K, N = 4096, 1024
    node = quant.quantize_kernel_int4(
        torch.randn((K, N), generator=gen, device=cuda).to(torch.bfloat16), group)
    assert node["scale"].shape[0] == K // group
    for M in (1, 8, 16, 17):
        x = _one_hot_rows(M, K, cuda)
        assert torch.equal(qm.w4a16_matmul(x, node), qm.w4a16_matmul_plain(x, node)), M
        x = _randn(gen, M, K, device=cuda)
        assert _rel_err(qm.w4a16_matmul(x, node), qm.w4a16_matmul_plain(x, node)) <= QUANT_RTOL


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_layer_view(cuda, bits):
    """A layer's view of a [3, K, N] stack goes to the kernel in place (no
    copy: the pointer is the stack's plus the layer offset) and gives the
    same result as a contiguous copy of that layer."""
    from gritlm_tpu_torch.models.transformer import _unstack
    from gritlm_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=cuda).manual_seed(7)
    K, N = 4096, 1024
    stack = _quant_node(bits, K, N, gen, cuda, layers=3)
    view = _unstack({"w": stack}, 3)[1]["w"]
    key = "q8" if bits == 8 else "q4"
    assert view[key].data_ptr() == stack[key].data_ptr() + stack[key][0].numel()
    copy = {k: v.clone() for k, v in view.items()}
    kernel = qm.w8a16_matmul if bits == 8 else qm.w4a16_matmul
    x = _randn(gen, 8, K, device=cuda)
    got, want = kernel(x, view), kernel(x, copy)
    assert torch.equal(got, want)
    assert not torch.equal(got, kernel(x, _unstack({"w": stack}, 3)[0]["w"]))


def test_quant_matmul_rejects_geometry(cuda):
    """A CUDA tensor whose geometry the kernel does not take raises; it is
    never computed by the plain version. fp32 activations are taken as the
    JAX wrapper takes them (x cast to bf16 for the kernel, the result cast
    to fp32: the bf16 call's output exactly, for an x that bf16 holds);
    float16 activations raise."""
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.training import quant

    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, 4, 256, device=cuda)
    w = torch.randn((256, 24), generator=gen, device=cuda)
    with pytest.raises(NotImplementedError):
        qm.w8a16_matmul(x, quant.quantize_kernel(w))  # N % 16
    with pytest.raises(NotImplementedError):  # a group of 8 rows
        qm.w4a16_matmul(x, quant.quantize_kernel_int4(torch.randn((256, 128), device=cuda), 8))
    node = quant.quantize_kernel(torch.randn((256, 128), device=cuda))
    got = qm.w8a16_matmul(x.float(), node)  # fp32 activations
    assert got.dtype == torch.float32
    assert torch.equal(got, qm.w8a16_matmul(x, node).float())
    with pytest.raises(TypeError):
        qm.w8a16_matmul(x.half(), node)  # float16 activations
    with pytest.raises(ValueError):  # a weight that is not contiguous
        qm.w8a16_matmul(x, {"q8": node["q8"].t().contiguous().t(), "scale": node["scale"]})


def test_quantized_gritlm_runs_its_kernels(cuda):
    """GritLM(weight_quant=8|4) on the card: encode and generate run, decode
    goes through K6 / K7, and the greedy tokens of a w8 generate stay within
    the logits' ties of a teacher-forced forward (decode rows through K6,
    the forward's rows through the dequantizing matmul)."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.models.transformer import forward, logits_from_hidden
    from gritlm_tpu_torch.ops import quant_matmul as qm

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    base = GritLM(cfg)
    for bits, kernel in ((8, qm.w8a16_matmul), (4, qm.w4a16_matmul)):
        m = GritLM(cfg, params=base.params, weight_quant=bits)
        enc = m.tokenizer(["Hi there"])
        before = kernel.launches
        emb = m.encode(["hello world", "a longer sentence to embed"])
        res = m.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=6)
        assert emb.shape == (2, 256) and res.tokens.shape == (1, 6)
        assert kernel.launches > before
        n = int(res.num_valid[0])
        toks = res.tokens[0, :n].long()
        prompt = enc["input_ids"][0].tolist()
        with torch.inference_mode():
            x = torch.tensor([prompt + toks.tolist()], device=cuda)
            hidden, _, _ = forward(m.params, cfg, x, causal=True)
            logits = logits_from_hidden(m.params, cfg, hidden)[0].float()
        logits = logits[len(prompt) - 1:len(prompt) - 1 + n]
        chosen = logits.gather(1, toks[:, None])[:, 0]
        assert float((logits.max(1).values - chosen).max()) <= 0.25


# ------------------------------------------------------------ Mixtral MoE

MOE_SENTS = ["Bitcoin is a decentralized digital currency.", "The cell's powerhouse.",
             "A transformer layer applies attention and then a mixture of experts."]


def _moe_model(impl="dense"):
    """A 2-layer model at Mixtral-8x7B's widths but the experts' (D 4096,
    32/8 heads of 128, 8 experts, top-2), with experts of width 256; random
    bf16 weights."""
    from gritlm_tpu_torch import GritLM

    cfg = ModelConfig(vocab_size=512, intermediate_size=256, num_hidden_layers=2,
                      num_local_experts=8, num_experts_per_tok=2, model_type="mixtral",
                      moe_impl=impl)
    return GritLM(cfg, seed=0)


def _cosine_min(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def test_moe_dense_and_dropless_agree(cuda):
    """The dense all-experts pass and the dropless grouped products
    (torch._grouped_mm) on one MoE layer at the same input: the same router
    logits, outputs within bf16 rounding of each other (dense combines in
    bf16, dropless in fp32); encode embeddings through each at cosine >=
    0.999."""
    import dataclasses

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.models import transformer as tr

    m = _moe_model()
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(gen, 3, 70, 4096, device=cuda)
    lp = {k: v[1] for k, v in m.params["layers"]["moe"].items()}
    with torch.inference_mode():
        dense, dropless = tr._moe_mlp_dense(lp, x, m.config), tr._moe_mlp_dropless(lp, x, m.config)
    assert torch.equal(dense[1], dropless[1])
    assert torch.isfinite(dropless[0]).all()
    rel = (dense[0].float() - dropless[0].float()).norm() / dense[0].float().norm()
    assert float(rel) < 1e-2, float(rel)
    other = GritLM(dataclasses.replace(m.config, moe_impl="dropless"), params=m.params)
    assert _cosine_min(m.encode(MOE_SENTS), other.encode(MOE_SENTS)) >= 0.999


@pytest.mark.parametrize("impl", ["dense", "auto", "dropless"])
def test_moe_serving_decode_chunk_has_no_host_sync(cuda, impl):
    """One serving decode chunk over a MoE trunk queues without a host sync
    (torch.cuda.set_sync_debug_mode("error") raises on one), through K3."""
    from gritlm_tpu_torch import serving

    m = _moe_model(impl)
    eng = serving.ServingEngine(m.config, m.params, max_batch=3, max_len=256, chunk_size=4,
                                prompt_buckets=(64,))
    for n in (5, 40, 20):
        eng.submit(serving.Request(input_ids=list(range(3, 3 + n)), max_new_tokens=32,
                                   request_id=str(n)))
    eng.step()  # admits all three and dispatches a first chunk
    torch.cuda.synchronize()
    before = decode_attention.flash_decode.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = serving._decode_chunk_program(eng.params, eng.cfg, eng.carry, steps=4,
                                                      eos_id=eng.eos_id, pad_id=eng.pad_id)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == emitted.shape == (4, 3)
    assert decode_attention.flash_decode.launches > before


def test_moe_paths_run_their_kernels(cuda, monkeypatch):
    """On a MoE trunk, encode goes through K1 and K2 and generate through
    K3; K2's and K3's calls there (captured with their inputs) agree with
    the plain versions, and encode through the plain K1 and K2 gives the
    kernels' embeddings at cosine >= 0.999."""
    m = _moe_model()
    calls = {}

    def capture(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kw):
            if name not in calls:
                calls[name] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                               {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
            return fn(*args, **kw)

        # a kernel wrapper adds its launches to the function its module's
        # name holds, so while this one stands in, the counts land here
        wrapper.launches = wrapper.row_offset_launches = 0
        monkeypatch.setattr(mod, name, wrapper)
        return fn

    k1 = flash_attention.flash_attention.launches
    k2 = capture(fused_pool, "fused_norm_mean_pool")
    k3 = capture(decode_attention, "flash_decode")
    emb = m.encode(MOE_SENTS)
    res = m.generate(["Hi", "Name a city."], max_new_tokens=6)
    assert isinstance(res, list) and flash_attention.flash_attention.launches > k1
    assert fused_pool.fused_norm_mean_pool.launches > 0
    assert decode_attention.flash_decode.launches > 0
    for name, kernel, plain, atol in (
            ("fused_norm_mean_pool", k2, fused_pool.fused_norm_mean_pool_plain, 1e-4),
            ("flash_decode", k3, decode_attention.flash_decode_plain, ATTN_ATOL)):
        args, kw = calls[name]
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    monkeypatch.setattr(fused_pool, "fused_norm_mean_pool", fused_pool.fused_norm_mean_pool_plain)
    monkeypatch.setattr(flash_attention, "flash_attention", flash_attention.flash_attention_plain)
    assert _cosine_min(emb, m.encode(MOE_SENTS)) >= 0.999


def _adapter_model(cuda, n_adapters=3):
    """A bf16 model of Dh 128 on the card (the LM head scaled so logits
    spread over a few units) and LoRA adapters with nonzero B factors."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.training.lora import init_lora

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    m = GritLM(cfg, device=cuda)
    m.params["lm_head"]["kernel"].mul_(4)
    gen = torch.Generator(device=cuda).manual_seed(7)
    adapters = {}
    for i in range(n_adapters):
        tree, scale = init_lora(m.params, i, r=4, alpha=8)
        for node in (v for layer in tree["layers"].values() for v in layer.values()):
            node["B"].normal_(0.0, 0.05, generator=gen)
        adapters[chr(ord("a") + i)] = tree
    return m, adapters, scale


@pytest.mark.parametrize("paged", [False, True])
def test_adapter_pool_on_cuda(cuda, paged):
    """Per-request adapters on the card (K1 prefills, K3 or K8 decode):
    every request completes, each token within TIE of its position's
    largest logit in one teacher-forced forward over its adapter merged into
    the base (bf16: xW + (xA)B and x(W + AB) round differently, so only near
    ties may flip; tests/test_torch_adapters.py holds the tokens exact in
    float32), and each adapter moves some request off the base's tokens."""
    from gritlm_tpu_torch.models.transformer import forward, logits_from_hidden
    from gritlm_tpu_torch.ops import paged_attention
    from gritlm_tpu_torch.serving import Request, ServingEngine
    from gritlm_tpu_torch.training.lora import merge

    TIE = 0.1
    m, adapters, scale = _adapter_model(cuda)
    names = [None, "a", "b", "c", "a", None, "b"]
    prompts = {f"r{i}": [3 + (i * 7 + j * 5) % 101 for j in range(n)]
               for i, n in enumerate((5, 40, 70, 9, 130, 17, 60))}
    kw = dict(max_batch=3, max_len=512, chunk_size=4, prompt_buckets=(128, 256), paged=paged,
              page_size=128, device=cuda)

    def run(on, **extra):
        done = ServingEngine(m.config, m.params, **kw, **extra).run(
            [Request(input_ids=ids, max_new_tokens=12, request_id=rid, adapter=a)
             for (rid, ids), a in zip(prompts.items(), on)])
        assert sorted(c.request_id for c in done) == sorted(prompts)
        assert all(0 < len(c.token_ids) <= 12 for c in done)
        return {c.request_id: c.token_ids for c in done}

    before = (decode_attention.flash_decode.launches, paged_attention.paged_decode.launches)
    got = run(names, adapters=adapters, lora_scale=scale)
    k3 = decode_attention.flash_decode.launches - before[0]
    k8 = paged_attention.paged_decode.launches - before[1]
    assert (k8 > 0 and k3 == 0) if paged else (k3 > 0 and k8 == 0)
    merged = {None: m.params, **{n: merge(m.params, t, scale) for n, t in adapters.items()}}
    for (rid, ids), a in zip(prompts.items(), names):
        toks = got[rid]
        x = torch.tensor([ids + toks], dtype=torch.int32, device=cuda)
        with torch.inference_mode():
            hidden, _, _ = forward(merged[a], m.config, x, causal=True)
            logits = logits_from_hidden(merged[a], m.config, hidden)[0, len(ids) - 1:-1].float()
        chosen = logits.gather(1, torch.tensor(toks, device=cuda)[:, None])[:, 0]
        assert float((logits.max(1).values - chosen).max()) <= TIE, (rid, a)
    base = run([None] * len(names))  # the same requests on the base model
    for name in adapters:
        assert any(got[rid] != base[rid] for rid, a in zip(prompts, names) if a == name), name


@pytest.mark.parametrize("paged", [False, True])
def test_adapter_decode_chunk_has_no_host_sync(cuda, paged):
    """A decode chunk of an adapter pool, every row on another adapter,
    queues without a host sync (set_sync_debug_mode("error") raises on
    one): the rows' ids live on the device and index there."""
    from gritlm_tpu_torch import serving

    m, adapters, scale = _adapter_model(cuda)
    eng = serving.ServingEngine(m.config, m.params, max_batch=3, max_len=256, chunk_size=4,
                                prompt_buckets=(64,), paged=paged, page_size=64,
                                adapters=adapters, lora_scale=scale, device=cuda)
    for n, a in zip((5, 40, 20), adapters):
        eng.submit(serving.Request(input_ids=list(range(3, 3 + n)), max_new_tokens=32,
                                   request_id=str(n), adapter=a))
    eng.step()  # admits all three and dispatches a first chunk
    torch.cuda.synchronize()
    assert eng.carry.aid.tolist() == [1, 2, 3]
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = serving._decode_chunk_program(eng.params, eng.cfg, eng.carry, steps=4,
                                                      eos_id=eng.eos_id, pad_id=eng.pad_id)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == emitted.shape == (4, 3) and bool(emitted.all())


def test_lora_step_remat_policies_bit_equal(cuda):
    """A LoRA train step on the card under each remat policy: losses and
    adapters after two steps bit-equal to the full recompute's (the same
    kernels on the same inputs), K1 relaunched by every policy's recompute
    (two K1 launches for each K4 one)."""
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training.data import GritCollator
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig, leaves

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1)
    coll = GritCollator(ByteTokenizer(), query_max_len=64, passage_max_len=128,
                        generative_max_len=128)
    batch = coll([(("find", f"query {i}"), [("find", f"passage {i}"), ("find", f"junk {i}")],
                   [f"what is {i}?", f"it is {i}"]) for i in range(4)])
    base = init_params(cfg, 0, device=cuda)
    runs = {}
    for policy in (None, "dots", "dots_no_batch"):
        tc = TrainConfig(total_steps=4, warmup_ratio=0.25, learning_rate=1e-3,
                         remat_policy=policy)
        run_step, state, _, _ = make_lora_train_state(cfg, tc, base, r=4, alpha=8, device=cuda)
        k1, k4 = flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq
        before = (k1.launches, k4.launches)
        losses = []
        for _ in range(2):
            state, m = run_step(state, batch)
            losses.append(m.loss)
        n1, n4 = k1.launches - before[0], k4.launches - before[1]
        assert n4 > 0 and n1 == 2 * n4, (policy, n1, n4)
        runs[policy] = (torch.stack(losses), [t.detach().clone() for t in leaves(state.params)])
    for policy in ("dots", "dots_no_batch"):
        assert torch.equal(runs[policy][0], runs[None][0]), policy
        assert all(torch.equal(a, b) for a, b in zip(runs[policy][1], runs[None][1])), policy


def _moe_layer_impls(cuda, T=(2, 512)):
    """One MoE layer at Mixtral-8x7B's full width (D 4096, F 14336, 8
    experts top-2; random bf16 weights) under dense, dropless and gshard at
    capacity E/k (exact): for each, (out, dx, the expert stacks' grads, the
    router logits) of sum(out * w) for a fixed random w."""
    from gritlm_tpu_torch.config import mixtral_8x7b
    from gritlm_tpu_torch.models import transformer as tr

    cfg = mixtral_8x7b()
    gen = torch.Generator(device=cuda).manual_seed(5)
    E, D, Fd = cfg.num_local_experts, cfg.hidden_size, cfg.intermediate_size
    lp = {"router": 0.02 * _randn(gen, D, E, device=cuda),
          "gate": 0.02 * _randn(gen, E, D, Fd, device=cuda),
          "up": 0.02 * _randn(gen, E, D, Fd, device=cuda),
          "down": 0.02 * _randn(gen, E, Fd, D, device=cuda)}
    x = _randn(gen, *T, D, device=cuda)
    w = _randn(gen, *T, D, device=cuda).float()
    out = {}
    for impl, kw in (("dense", {}), ("dropless", {}),
                     ("gshard", dict(capacity_factor=E / cfg.num_experts_per_tok))):
        c = dataclasses.replace(cfg, moe_impl=impl, **kw)
        xi = x.clone().requires_grad_(True)
        experts = {k: lp[k].clone().requires_grad_(True) for k in ("gate", "up", "down")}
        y, logits, drop = tr._moe_mlp({**lp, **experts}, xi, c)
        grads = torch.autograd.grad((y.float() * w).sum(), [xi, *experts.values()])
        assert float(drop) == 0.0
        out[impl] = (y.detach(), grads, logits.detach())
    return out


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_moe_layer_impls_agree_at_full_width(cuda):
    """Dense, dropless and gshard (capacity E/k) on one full-width layer:
    the same router logits (one _router call on the same input, so the
    routes cannot differ), and the output, its input gradient and the
    expert stacks' gradients within 1e-2 relative (Frobenius) of the dense
    impl's: dense combines in bf16, the other two in fp32."""
    runs = _moe_layer_impls(cuda)
    y0, g0, l0 = runs["dense"]
    for impl in ("dropless", "gshard"):
        y, g, logits = runs[impl]
        assert torch.equal(logits, l0), impl
        assert torch.isfinite(y).all() and all(torch.isfinite(t).all() for t in g)
        assert _rel(y, y0) < 1e-2, (impl, _rel(y, y0))
        for name, a, b in zip(("x", "gate", "up", "down"), g, g0):
            assert float(b.abs().max()) > 0, (impl, name)
            assert _rel(a, b) < 1e-2, (impl, name, _rel(a, b))


def test_moe_lora_step_runs_its_kernels(cuda):
    """A LoRA step on a 2-layer Mixtral-shaped trunk (Dh 128, 8 experts
    top-2, dropless: torch._grouped_mm forward and backward in bf16) with
    remat: finite losses, the aux term in loss_gen, no drop, K1, K4 and K5
    launched (K1 twice a layer: the recompute), the adapters moving."""
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training import train
    from gritlm_tpu_torch.training.data import GritCollator
    from gritlm_tpu_torch.training.lora import make_lora_train_state

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                      num_local_experts=8, num_experts_per_tok=2, model_type="mixtral",
                      moe_impl="dropless")
    coll = GritCollator(ByteTokenizer(), query_max_len=64, passage_max_len=128,
                        generative_max_len=128)
    batch = coll([(("find", f"query {i}"), [("find", f"passage {i}"), ("find", f"junk {i}")],
                   [f"what is {i}?", f"it is {i}"]) for i in range(4)])
    aux = []
    lbl = train.load_balancing_loss

    def recording(logits, c, mask):
        out = lbl(logits, c, mask)
        aux.append(float(out.detach()))
        return out

    tc = train.TrainConfig(total_steps=4, warmup_ratio=0.25, learning_rate=1e-3)
    run_step, state, _, _ = make_lora_train_state(cfg, tc, init_params(cfg, 0, device=cuda),
                                                  r=4, alpha=8, device=cuda)
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq,
                flash_attention.flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    train.load_balancing_loss = recording
    try:
        for _ in range(2):
            state, m = run_step(state, batch)
    finally:
        train.load_balancing_loss = lbl
    assert all(torch.isfinite(x) for x in (m.loss, m.loss_emb, m.loss_gen, m.grad_norm))
    assert len(aux) == 2 and aux[-1] > 0 and float(m.moe_dropped_frac) == 0.0
    n = [f.launches - b for f, b in zip(wrappers, before)]
    assert n[1] > 0 and n[1] == n[2] and n[0] >= 2 * n[1], n
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


# ------------------------------------------------------------ head dims 64 and 96

# (Dh, H, Hkv): Llama-3.2-1B, the Qwen2-0.5B geometry (group 7, Kv * Dh 128),
# and Dh 96 (K1 through the zero-pad to 128)
HEAD_DIM_GEOMETRIES = [(64, 32, 8), (64, 14, 2), (96, 16, 8)]


@pytest.mark.parametrize("causal,window,offset,Sq", [
    (False, None, 0, 300), (True, 64, 0, 300), (True, None, 256, 77), (True, None, 0, 1),
])
@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_attention_kernel_head_dims(cuda, Dh, H, Hkv, causal, window, offset, Sq):
    """K1 at Dh 64 (its own instance) and 96 (zero-padded to 128 with the
    true scale): output and LSE against the plain version, a rerun
    bit-equal, one launch a call, a padded tail and an empty row."""
    gen = torch.Generator(device=cuda).manual_seed(40 + Dh)
    B, Sk = 3, 333
    q = _randn(gen, B, Sq, H, Dh, device=cuda)
    k = _randn(gen, B, Sk, Hkv, Dh, device=cuda)
    v = _randn(gen, B, Sk, Hkv, Dh, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[1, 290:] = 0
    mask[2] = 0
    before = flash_attention.flash_attention.launches
    out, lse = _k1_against_plain(q, k, v, mask, causal=causal, sliding_window=window,
                                 offset=offset)
    assert flash_attention.flash_attention.launches == before + 2
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.count_nonzero(out[2]) == 0


@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_attention_kernel_head_dims_on_cache_view(cuda, Dh, H, Hkv):
    """K1 over a cache layer's view (strided K/V) at an offset: prefill on
    top of a cache."""
    gen = torch.Generator(device=cuda).manual_seed(45)
    k_all = _randn(gen, 2, 2, 640, Hkv * Dh, device=cuda)
    v_all = _randn(gen, 2, 2, 640, Hkv * Dh, device=cuda)
    q = _randn(gen, 2, 200, H, Dh, device=cuda)
    mask = (torch.arange(640, device=cuda) < 520).int()[None].repeat(2, 1)
    lk, lv = k_all[1].view(2, 640, Hkv, Dh), v_all[1].view(2, 640, Hkv, Dh)
    _k1_against_plain(q, lk, lv, mask, causal=True, offset=320)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Sq,per_row", [(1, False), (8, True), (64, False)])
@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_decode_kernel_head_dims(cuda, Dh, H, Hkv, Sq, per_row, quant):
    """K3 at Dh 64 and 96: bf16 and int8 caches, one int offset or a [B]
    tensor of per-row offsets (the verify chunk), holes, an empty row
    (zeros), against the plain version; a rerun bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(50 + Dh + Sq)
    L, B, Smax = 2, 4, 2048
    k_all = _randn(gen, L, B, Smax, Hkv * Dh, device=cuda)
    v_all = _randn(gen, L, B, Smax, Hkv * Dh, device=cuda)
    scales = {}
    if quant:
        k_all, v_all, scales = _int8_cache(k_all, v_all, Hkv, Dh)
    mask = (torch.rand((B, Smax), generator=gen, device=cuda) > 0.2).int()
    mask[3] = 0
    if per_row:
        offset = torch.tensor([5, 1500, 2048 - Sq, 700], dtype=torch.int32, device=cuda)
    else:
        offset = 1400 - Sq
        mask[:, 1400:] = 0
    q = _randn(gen, B, Sq, H, Dh, device=cuda)
    got = _k3_against_plain(q, k_all, v_all, mask, causal=True, offset=offset, layer=1,
                            num_kv_heads=Hkv, **scales)
    assert torch.count_nonzero(got[3]) == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Sq", [1, 8])
@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_paged_decode_kernel_head_dims(cuda, Dh, H, Hkv, Sq, quant):
    """K8 at Dh 64 and 96 over a shuffled pool of 256-slot pages, bf16 and
    int8 pages, mask-bounded at Sq 1 and causal at per-row offsets at Sq 8:
    against the plain version, and bit-equal to K3 on the same logical
    cache laid out dense."""
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=cuda).manual_seed(60 + Dh + Sq)
    L, B, page, maxp = 2, 8, 256, 16
    P = B * maxp + 1
    k_d = _randn(gen, L, B, maxp * page, Hkv * Dh, device=cuda)
    v_d = _randn(gen, L, B, maxp * page, Hkv * Dh, device=cuda)
    dense_scales = {}
    if quant:
        k_d, v_d, dense_scales = _int8_cache(k_d, v_d, Hkv, Dh)
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(cuda)
    inv = torch.zeros(P, dtype=torch.long, device=cuda)
    inv[pt.long().reshape(-1)] = torch.arange(B * maxp, device=cuda)
    k = k_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
    v = v_d.view(L, B * maxp, page, -1)[:, inv].contiguous()
    scales = {n: s.view(L, B, Hkv, maxp, page).transpose(2, 3).reshape(
        L, B * maxp, Hkv, page)[:, inv].contiguous() for n, s in dense_scales.items()}
    lens = torch.tensor([37, 1900, 256, 700, 1333, 3000, 8, 512], device=cuda)
    mask = (torch.arange(maxp * page, device=cuda)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0
    kw = dict(layer=1, num_kv_heads=Hkv, causal=Sq > 1,
              offset=(lens - Sq).to(torch.int32) if Sq > 1 else 0)
    q = _randn(gen, B, Sq, H, Dh, device=cuda)
    before = paged_attention.paged_decode.launches
    got = paged_attention.paged_decode(q, k, v, pt, mask, **kw, **scales)
    want_k3 = decode_attention.flash_decode(q, k_d, v_d, mask, **kw, **dense_scales)
    torch.cuda.synchronize()
    want = paged_attention.paged_decode_plain(q, k, v, pt, mask, **kw, **scales)
    assert paged_attention.paged_decode.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=ATTN_ATOL, rtol=0)
    assert torch.equal(got, want_k3)


def test_head_dims_without_an_instance_raise(cuda):
    """A CUDA tensor at a head dim no kernel takes raises (no plain or
    library fallback): K1 at Dh 256, K3 and K8 at Dh 80; FlashAttentionFn at
    Dh 256 raises before its forward launches K1."""
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=cuda).manual_seed(70)
    q = _randn(gen, 1, 8, 4, 256, device=cuda)
    k = _randn(gen, 1, 8, 2, 256, device=cuda)
    with pytest.raises(NotImplementedError):
        flash_attention.flash_attention(q, k, k, None, causal=True)
    q80 = _randn(gen, 2, 1, 4, 80, device=cuda)
    cache = _randn(gen, 1, 2, 256, 2 * 80, device=cuda)
    with pytest.raises(NotImplementedError):
        decode_attention.flash_decode(q80, cache, cache, None, causal=False)
    pages = _randn(gen, 1, 3, 256, 2 * 80, device=cuda)
    pt = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        paged_attention.paged_decode(q80, pages, pages, pt, mask)
    q.requires_grad_()
    before = flash_attention.flash_attention.launches
    with pytest.raises(NotImplementedError):
        flash_attention.FlashAttentionFn.apply(q, k, k, None, True, None, 0)
    assert flash_attention.flash_attention.launches == before


@pytest.mark.parametrize("causal,window,offset,Sq,Sk,empty_row", [
    (True, None, 0, 300, 300, False), (False, None, 0, 300, 300, True),
    (True, 64, 0, 300, 300, False), (True, None, 100, 200, 333, False)])
@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_backward_kernels_head_dims(cuda, Dh, H, Hkv, causal, window, offset, Sq, Sk,
                                          empty_row):
    """K4 and K5 at Dh 64 (their own instances) and 96 (flash_attention_bwd
    zero-pads q, k, v and dO to 128 and passes the scale 96^-0.5) against
    the plain backward from the same saved LSE, one launch each; a padded
    tail, a window, an offset; a row with no valid key gets exactly zero
    gradients; a rerun bit-equal. Tolerance: 2% of the largest gradient, as
    test_flash_backward_kernels."""
    gen = torch.Generator(device=cuda).manual_seed(80 + Dh)
    B = 2
    q = _randn(gen, B, Sq, H, Dh, device=cuda)
    k, v = _randn(gen, B, Sk, Hkv, Dh, device=cuda), _randn(gen, B, Sk, Hkv, Dh, device=cuda)
    do = _randn(gen, B, Sq, H, Dh, device=cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=cuda)
    mask[1, Sk - 40:] = 0
    if empty_row:
        mask[0] = 0
    kw = dict(causal=causal, sliding_window=window, offset=offset)
    out, lse = flash_attention.flash_attention(q, k, v, mask, return_lse=True, **kw)
    before = (flash_attention.flash_attention_bwd_dq.launches,
              flash_attention.flash_attention_bwd_dkv.launches)
    got = flash_attention.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    again = flash_attention.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_bwd_dq.launches,
            flash_attention.flash_attention_bwd_dkv.launches) == (before[0] + 2, before[1] + 2)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, **kw)
    for g, w, a in zip(got, want, again):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.isfinite(g).all()
        tol = 2e-2 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
        assert torch.equal(g, a)
        if empty_row:
            assert float(g[0].abs().max()) == 0.0


@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_attention_fn_head_dims_on_cuda(cuda, Dh, H, Hkv):
    """Training attention at Dh 64 and 96: multi_head_attention under grad
    goes through FlashAttentionFn (K1 with LSE, K4, K5, one launch each),
    its gradients follow autograd through the plain forward (2% of the
    largest) and have the inputs' shapes."""
    from gritlm_tpu_torch.ops.attention import multi_head_attention

    gen = torch.Generator(device=cuda).manual_seed(90 + Dh)
    q, k, v = (x.requires_grad_(True) for x in (_randn(gen, 2, 256, H, Dh, device=cuda),
                                                 _randn(gen, 2, 256, Hkv, Dh, device=cuda),
                                                 _randn(gen, 2, 256, Hkv, Dh, device=cuda)))
    mask = torch.ones((2, 256), dtype=torch.int32, device=cuda)
    mask[0, 200:] = 0
    w = _randn(gen, 2, 256, H, Dh, device=cuda).float()
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq,
                flash_attention.flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    out = multi_head_attention(q, k, v, mask, causal=True)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1]
    ref = flash_attention.flash_attention_plain(q, k, v, mask, causal=True)
    want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
    for g, r, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape
        torch.testing.assert_close(g.float(), r.float(), rtol=0,
                                   atol=2e-2 * float(r.float().abs().max()))


@pytest.mark.parametrize("head_dim", [64, 96])
def test_llama_lora_step_on_cuda(cuda, head_dim):
    """A narrow Llama-3.2-1B-shaped model (tied embeddings, llama3 RoPE) at
    head dims 64 and 96: two LoRA steps on the card with finite losses,
    attention forward and backward through K1, K4 and K5 (K1 twice a layer
    with remat), and the adapters move from step 2 on."""
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training.data import GritCollator
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig

    cfg = ModelConfig.from_hf_config(dict(
        model_type="llama", hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=head_dim, vocab_size=512,
        max_position_embeddings=4096, rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling=dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192)),
        dtype="bfloat16")
    coll = GritCollator(ByteTokenizer(), query_max_len=64, passage_max_len=128,
                        generative_max_len=128)
    batch = coll([(("find", f"query {i}"), [("find", f"passage {i}"), ("find", f"junk {i}")],
                   [f"what is {i}?", f"it is {i}"]) for i in range(4)])
    tc = TrainConfig(total_steps=4, warmup_ratio=0.25, learning_rate=1e-3)
    run_step, state, _, _ = make_lora_train_state(cfg, tc, init_params(cfg, 0, device=cuda),
                                                  r=4, alpha=8, device=cuda)
    wrappers = (flash_attention.flash_attention, flash_attention.flash_attention_bwd_dq,
                flash_attention.flash_attention_bwd_dkv)
    before = [f.launches for f in wrappers]
    for _ in range(2):
        state, m = run_step(state, batch)
    assert all(torch.isfinite(x) for x in (m.loss, m.loss_emb, m.loss_gen, m.grad_norm))
    n = [f.launches - b for f, b in zip(wrappers, before)]
    assert n[1] > 0 and n[1] == n[2] and n[0] >= 2 * n[1]
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


def test_llama_head_dim_64_serving_path_on_cuda(cuda):
    """A narrow Llama-3.2-1B-shaped model (head dim 64, tied embeddings,
    llama3 RoPE scaling) on the card: encode through K1 and K2 at cosine
    >= 0.999 to the same model through the plain versions, greedy generate
    through K3, and a dense and a paged serving pool through K3 and K8, every
    request complete."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.ops import fused_pool as fp
    from gritlm_tpu_torch.ops import paged_attention
    from gritlm_tpu_torch.serving import Request, ServingEngine

    cfg = ModelConfig.from_hf_config(dict(
        model_type="llama", hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=512,
        max_position_embeddings=4096, rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling=dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192)),
        dtype="bfloat16")
    model = GritLM(cfg, seed=0, device=cuda)
    docs = ["a b c d e f", "the cache of keys and values " * 30]
    wrappers = (flash_attention.flash_attention, fp.fused_norm_mean_pool)
    before = [w.launches for w in wrappers]
    emb = torch.from_numpy(model.encode(docs))
    assert all(w.launches > b for w, b in zip(wrappers, before))
    saved = (flash_attention.flash_attention, fp.fused_norm_mean_pool)
    flash_attention.flash_attention = flash_attention.flash_attention_plain
    fp.fused_norm_mean_pool = fp.fused_norm_mean_pool_plain
    try:
        plain = torch.from_numpy(model.encode(docs))
    finally:
        flash_attention.flash_attention, fp.fused_norm_mean_pool = saved
    assert float(torch.nn.functional.cosine_similarity(emb, plain, dim=-1).min()) >= 0.999
    enc = model.tokenizer(["<s><|user|>\nHi\n<|assistant|>\n", docs[1]])
    k3 = decode_attention.flash_decode.launches
    res = model.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    assert decode_attention.flash_decode.launches > k3
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    rng = torch.Generator().manual_seed(0)
    specs = [(f"r{i}", torch.randint(3, 512, (n,), generator=rng).tolist())
             for i, n in enumerate([5, 300, 40, 129])]
    for paged in (False, True):
        eng = ServingEngine(cfg, model.params, max_batch=2, max_len=1024, chunk_size=4,
                            prompt_buckets=(64, 128, 256, 512), eos_id=-1, pad_id=0,
                            device=cuda, **(dict(paged=True, page_size=256) if paged else {}))
        kernel = paged_attention.paged_decode if paged else decode_attention.flash_decode
        n = kernel.launches
        done = eng.run([Request(input_ids=ids, max_new_tokens=6, request_id=rid)
                        for rid, ids in specs])
        assert sorted(c.request_id for c in done) == [rid for rid, _ in specs]
        assert all(len(c.token_ids) == 6 for c in done)
        assert kernel.launches > n


# ---------------------------------------------------------------- fp32 forms
# K1, K2, K3 and K8 on fp32 activations against their plain versions (fp32
# einsums and softmax on the card, TF32 off). Both sides take fp32 products
# and sum them in fp32, in other orders, and the kernels' exp2 is the
# hardware's approximation (2^-22 relative): at unit-scale inputs a score
# moves by about sqrt(Dh) x 2^-24 and an output or LSE by less than 1e-6,
# so F32_ATOL = 1e-5 (chip_smoke.F32_ATOL) holds with room.
F32_ATOL = 1e-5


@pytest.fixture
def fp32_cuda(cuda):
    """The card with fp32 matrix products in full fp32 for the plain
    versions (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = prev


def _randf(gen, *shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _f32_against_plain(wrapper, plain, *args, **kw):
    """An fp32 form against its plain version: one fp32 launch a call and no
    bf16 launch, a rerun bit-equal, within F32_ATOL; returns the kernel's
    result (a tensor or a tuple)."""
    before = (wrapper.f32_launches, wrapper.launches)
    got = wrapper(*args, **kw)
    again = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.f32_launches, wrapper.launches) == (before[0] + 2, before[1])
    want = plain(*args, **kw)
    got_t, again_t, want_t = ((x,) if torch.is_tensor(x) else x for x in (got, again, want))
    for g, a, w in zip(got_t, again_t, want_t):
        assert g.dtype == torch.float32 and torch.equal(g, a)
        torch.testing.assert_close(g, w.float(), atol=F32_ATOL, rtol=0)
    return got


@pytest.mark.parametrize("Dh", [64, 96, 128])
@pytest.mark.parametrize("causal,window,offset,Sq", [
    (False, None, 0, 200), (True, None, 0, 200), (True, 64, 0, 200), (True, None, 128, 77),
])
def test_flash_attention_f32_kernel(fp32_cuda, Dh, causal, window, offset, Sq):
    """K1 [f32] with its LSE at Dh 64, 128 and 96 (zero-padded to 128 at the
    true scale): bidirectional, causal, a window, an offset; a padded row
    and a row with no key (output 0, LSE NEG_INF)."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(40 + Dh)
    B, Sk, H, Hkv = 3, 333, 8, 2
    q = _randf(gen, B, Sq, H, Dh, device=fp32_cuda)
    k = _randf(gen, B, Sk, Hkv, Dh, device=fp32_cuda)
    v = _randf(gen, B, Sk, Hkv, Dh, device=fp32_cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=fp32_cuda)
    mask[1, 290:] = 0
    mask[2] = 0
    out, lse = _f32_against_plain(
        flash_attention.flash_attention, flash_attention.flash_attention_plain, q, k, v, mask,
        causal=causal, sliding_window=window, offset=offset, return_lse=True)
    assert torch.count_nonzero(out[2]) == 0
    assert bool((lse[2] == flash_attention.NEG_INF).all())


@pytest.mark.parametrize("Sq,Sk", [(1, 64), (129, 2048), (512, 512)])
def test_flash_attention_f32_kernel_shapes(fp32_cuda, Sq, Sk):
    """K1 [f32] off the 64-row blocks and 32-key tiles, causal at the end of
    the keys (a prefill over a cache) and bidirectional, GQA group 4."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(Sq + Sk)
    B, H, Hkv = 2, 8, 2
    q = _randf(gen, B, Sq, H, 128, device=fp32_cuda)
    k = _randf(gen, B, Sk, Hkv, 128, device=fp32_cuda)
    v = _randf(gen, B, Sk, Hkv, 128, device=fp32_cuda)
    mask = torch.ones((B, Sk), dtype=torch.int32, device=fp32_cuda)
    mask[1, Sk * 3 // 4:] = 0
    for causal in (False, True):
        _f32_against_plain(flash_attention.flash_attention, flash_attention.flash_attention_plain,
                           q, k, v, mask, causal=causal, offset=Sk - Sq if causal else 0)


def test_kernels_reject_other_dtypes(cuda):
    """float16, and a mix of bf16 and fp32, raise TypeError on the card
    before any launch, in all four wrappers and in the backward's two."""
    from gritlm_tpu_torch.ops import paged_attention

    x = torch.zeros((1, 64, 2, 128), device=cuda)
    mask = torch.ones((1, 64), dtype=torch.int32, device=cuda)
    for dt in ((torch.float16,) * 3, (torch.float32, torch.bfloat16, torch.bfloat16)):
        with pytest.raises(TypeError):
            flash_attention.flash_attention(*(x.to(d) for d in dt), mask, causal=False)
    with pytest.raises(TypeError):
        fused_pool.fused_norm_mean_pool(x[0].half(), x[0, 0, 0].half(), mask[:, :64], eps=1e-5)
    with pytest.raises(TypeError):
        fused_pool.fused_norm_mean_pool(x[0], x[0, 0, 0].bfloat16(), mask, eps=1e-5)
    cache = torch.zeros((1, 1, 64, 256), device=cuda)
    q = torch.zeros((1, 1, 2, 128), device=cuda)
    for qd, cd in ((torch.float16, torch.float16), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError):
            decode_attention.flash_decode(q.to(qd), cache.to(cd), cache.to(cd), mask,
                                          causal=False)
        with pytest.raises(TypeError):
            paged_attention.paged_decode(q.to(qd), cache.to(cd), cache.to(cd),
                                         torch.zeros((1, 2), dtype=torch.int32, device=cuda),
                                         torch.ones((1, 64), dtype=torch.int32, device=cuda))
    lse = torch.zeros((1, 2, 64), device=cuda)
    for dt in ((torch.float16,) * 4, (torch.float32,) * 3 + (torch.bfloat16,)):
        q_, k_, v_, do_ = (x.to(d) for d in dt)
        for bwd in (flash_attention.flash_attention_bwd_dq,
                    flash_attention.flash_attention_bwd_dkv):
            with pytest.raises(TypeError):
                bwd(q_, k_, v_, mask, do_, lse, lse, causal=False)


# (B, S, D, strided): a ragged batch with an empty row, a long row, many
# short rows, D 3584, rows that are views into wider ones, D 8192
F32_POOL_SHAPES = [(3, 700, 4096, False), (1, 4096, 4096, False), (64, 128, 4096, False),
                   (8, 512, 3584, False), (8, 300, 4096, True), (2, 1000, 8192, False)]


@pytest.mark.parametrize("method", ["mean", "weightedmean"])
@pytest.mark.parametrize("B,S,D,strided", F32_POOL_SHAPES)
def test_fused_pool_f32_kernel(fp32_cuda, method, B, S, D, strided):
    """K2 [f32]: mean and weightedmean, normalized and not, a masked prefix
    and tail, a one-token row, an empty row (zeros)."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(B * S + D + 1)
    base = _randf(gen, B, S, 2 * D if strided else D, device=fp32_cuda)
    hidden = base[..., :D] if strided else base
    gamma = 1 + 0.5 * torch.randn(D, generator=gen, device=fp32_cuda)
    mask = (torch.rand((B, S), generator=gen, device=fp32_cuda) < 0.9).int()
    mask[0, : S // 7] = 0
    mask[0, S * 5 // 7:] = 0
    if B > 1:
        mask[1] = 0
        mask[1, S // 2] = 1
    if B > 2:
        mask[2] = 0
    for normalized in (True, False):
        got = _f32_against_plain(fused_pool.fused_norm_mean_pool,
                                 fused_pool.fused_norm_mean_pool_plain, hidden, gamma, mask,
                                 eps=1e-5, method=method, normalized=normalized)
        if B > 2:
            assert torch.count_nonzero(got[2]) == 0


def _f32_cache(gen, L, B, Smax, Hkv, Dh, quant, device):
    """An fp32 cache [L, B, Smax, Kv*Dh], or its int8 quantization with
    slot-minor bf16 scales (as the write path quantizes it)."""
    from gritlm_tpu_torch.models.transformer import quantize_kv

    k = _randf(gen, L, B, Smax, Hkv * Dh, device=device)
    v = _randf(gen, L, B, Smax, Hkv * Dh, device=device)
    if not quant:
        return k, v, {}
    k8, ks = quantize_kv(k.view(L * B, Smax, Hkv, Dh))
    v8, vs = quantize_kv(v.view(L * B, Smax, Hkv, Dh))
    return k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1), {
        "k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
        "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("Dh", [64, 96, 128])
@pytest.mark.parametrize("Sq,window", [(1, None), (7, None), (3, 64)])
def test_flash_decode_f32_kernel(fp32_cuda, quant, Dh, Sq, window):
    """K3 [f32] over an fp32 and an int8 cache: causal at an int offset,
    holes, a window, an empty row (zeros)."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(50 + Dh + Sq)
    L, B, Smax, H, Hkv, offset = 2, 3, 512, 8, 2, 290
    k, v, scales = _f32_cache(gen, L, B, Smax, Hkv, Dh, quant, fp32_cuda)
    q = _randf(gen, B, Sq, H, Dh, device=fp32_cuda)
    mask = (torch.rand((B, Smax), generator=gen, device=fp32_cuda) > 0.3).int()
    mask[:, offset + Sq:] = 0
    mask[2] = 0
    got = _f32_against_plain(decode_attention.flash_decode, decode_attention.flash_decode_plain,
                             q, k, v, mask, causal=True, offset=offset, layer=1,
                             sliding_window=window, num_kv_heads=Hkv, **scales)
    assert torch.count_nonzero(got[2]) == 0


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_f32_serving_and_verify(fp32_cuda, quant):
    """K3 [f32] at the serving decode chunk's call (B 8, Smax 4096,
    mask-bounded, ragged rows with holes, an empty row) and at the verify
    chunk's (Sq 8, [B] offsets), bit-equal to K8 [f32] on the same logical
    cache in both."""
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=fp32_cuda).manual_seed(60)
    L, B, H, Hkv, page, maxp = 2, 8, 32, 8, 256, 16
    Smax = page * maxp
    k, v, scales = _f32_cache(gen, L, B, Smax, Hkv, 128, quant, fp32_cuda)
    lens = torch.tensor([0, 1900, 256, 700, 1333, 3000, 9, 4096], device=fp32_cuda)
    mask = (torch.arange(Smax, device=fp32_cuda)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0
    mask[4, 16:1000] = 0
    # the same cache as a shuffled page pool
    P = B * maxp + 1
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(fp32_cuda)
    inv = torch.zeros(P, dtype=torch.long, device=fp32_cuda)
    inv[pt.long().reshape(-1)] = torch.arange(B * maxp, device=fp32_cuda)
    kp = k.view(L, B * maxp, page, -1)[:, inv].contiguous()
    vp = v.view(L, B * maxp, page, -1)[:, inv].contiguous()
    pscales = {n: s.view(L, B, Hkv, maxp, page).transpose(2, 3).reshape(
        L, B * maxp, Hkv, page)[:, inv].contiguous() for n, s in scales.items()}
    for Sq in (1, 8):
        q = _randf(gen, B, Sq, H, 128, device=fp32_cuda)
        kw = dict(causal=False) if Sq == 1 else dict(
            causal=True, offset=(lens - Sq).clamp_min(0).to(torch.int32))
        got = _f32_against_plain(decode_attention.flash_decode,
                                 decode_attention.flash_decode_plain, q, k, v, mask, layer=1,
                                 num_kv_heads=Hkv, **kw, **scales)
        paged = _f32_against_plain(paged_attention.paged_decode,
                                   paged_attention.paged_decode_plain, q, kp, vp, pt, mask,
                                   layer=1, num_kv_heads=Hkv, **kw, **pscales)
        assert torch.equal(got, paged)
        assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page", [32, 256])
@pytest.mark.parametrize("Sq,causal", [(1, False), (8, True)])
def test_paged_decode_f32_kernel(fp32_cuda, quant, page, Sq, causal):
    """K8 [f32] over a shuffled pool of fp32 or int8 pages: ragged rows, a
    hole, a shared page, an empty row (0), per-row offsets at Sq 8."""
    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=fp32_cuda).manual_seed(70 + page + Sq)
    L, B, Hkv, H, maxp = 2, 4, 2, 8, 1024 // page
    P = B * maxp + 2
    k = _randf(gen, L, P, page, Hkv * 128, device=fp32_cuda)
    v = _randf(gen, L, P, page, Hkv * 128, device=fp32_cuda)
    scales = {}
    if quant:
        k8, ks = quantize_kv(k.view(L * P, page, Hkv, 128))
        v8, vs = quantize_kv(v.view(L * P, page, Hkv, 128))
        k, v = k8.view(L, P, page, -1), v8.view(L, P, page, -1)
        scales = {"k_scale": ks.view(L, P, page, Hkv).transpose(2, 3).contiguous(),
                  "v_scale": vs.view(L, P, page, Hkv).transpose(2, 3).contiguous()}
    pt = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))[:B * maxp] + 1)
    pt = pt.view(B, maxp).to(torch.int32).to(fp32_cuda)
    pt[2, 0] = pt[0, 0]
    lens = torch.tensor([5, maxp * page, 131, 0], device=fp32_cuda)
    mask = (torch.arange(maxp * page, device=fp32_cuda)[None] < lens[:, None]).int()
    mask[1, 7:40] = 0
    offs = (lens - Sq).clamp_min(0).to(torch.int32)
    q = _randf(gen, B, Sq, H, 128, device=fp32_cuda)
    got = _f32_against_plain(paged_attention.paged_decode, paged_attention.paged_decode_plain,
                             q, k, v, pt, mask, layer=1, num_kv_heads=Hkv, causal=causal,
                             offset=offs, **scales)
    assert torch.count_nonzero(got[3]) == 0


def test_bf16_forms_unchanged(cuda):
    """The bf16 forms of K1, K2, K3 and K8 on fixed seeded inputs give the
    bits they gave before the fp32 forms were added (the sha256 of each
    output, taken on an NVIDIA H100 80GB HBM3 from the parent commit's
    kernels by scripts/bf16_ab.py, which also compares the SASS)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bf16_ab", str(Path(__file__).resolve().parents[1] / "scripts" / "bf16_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.digests(cuda) == ab.BF16_DIGESTS


def test_gritlm_f32_runs_its_fp32_kernels(fp32_cuda):
    """GritLM at dtype float32 on the card: encode, generate (K1 prefill,
    K3 decode) and dense, paged and int8-KV pools go through the fp32
    forms only, and agree with the same model's plain versions."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.ops import paged_attention
    from gritlm_tpu_torch.serving import Request, ServingEngine

    wrappers = (flash_attention.flash_attention, fused_pool.fused_norm_mean_pool,
                decode_attention.flash_decode, paged_attention.paged_decode)
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                      dtype="float32")
    model = GritLM(cfg)
    bf16_before = [w.launches for w in wrappers]
    f32_before = [w.f32_launches for w in wrappers]
    docs = ["a passage about bitcoin " * 9, "the mitochondria", "x " * 150]
    emb = torch.from_numpy(model.encode(docs))
    enc = model.tokenizer(["<s><|user|>\nHi\n<|assistant|>\n", docs[0]])
    res = model.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    rng = torch.Generator().manual_seed(0)
    specs = [(f"r{i}", torch.randint(3, 512, (n,), generator=rng).tolist())
             for i, n in enumerate([5, 300, 40])]
    for extra in (dict(), dict(paged=True, page_size=256), dict(kv_quant=True)):
        eng = ServingEngine(cfg, model.params, max_batch=2, max_len=1024, chunk_size=4,
                            prompt_buckets=(64, 128, 256, 512), eos_id=-1, pad_id=0,
                            device=fp32_cuda, **extra)
        done = eng.run([Request(input_ids=ids, max_new_tokens=5, request_id=rid)
                        for rid, ids in specs])
        assert sorted(c.request_id for c in done) == [rid for rid, _ in specs]
    assert [w.launches for w in wrappers] == bf16_before
    assert all(w.f32_launches > b for w, b in zip(wrappers, f32_before))
    saved = (flash_attention.flash_attention, fused_pool.fused_norm_mean_pool)
    flash_attention.flash_attention = flash_attention.flash_attention_plain
    fused_pool.fused_norm_mean_pool = fused_pool.fused_norm_mean_pool_plain
    try:
        plain = torch.from_numpy(model.encode(docs))
    finally:
        flash_attention.flash_attention, fused_pool.fused_norm_mean_pool = saved
    torch.testing.assert_close(emb, plain, atol=F32_ATOL, rtol=0)


def test_verify_checkpoint_fp32_on_cuda(fp32_cuda, tmp_path, capsys):
    """verify-checkpoint --fp32 on the card at its default --parity_tol
    (2e-3): the load in fp32, the transformers leg (where installed), K1
    and K2's fp32 forms and K9 [f32] launched, no bf16 attention launch."""
    import json

    from gritlm_tpu_torch import tools
    from gritlm_tpu_torch.models.loader import save_checkpoint
    from gritlm_tpu_torch.ops import scores_segmax as k9

    m = _narrow_model()
    save_checkpoint(str(tmp_path), dataclasses.replace(m.config, dtype="bfloat16"), m.params)
    before = (flash_attention.flash_attention.f32_launches,
              fused_pool.fused_norm_mean_pool.f32_launches, k9.scores_segmax.f32_launches,
              flash_attention.flash_attention.launches)
    tools.main(["verify-checkpoint", "--model", str(tmp_path), "--fp32"])
    v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert v["ok"] and v["load"]["dtype"] == "float32"
    after = (flash_attention.flash_attention.f32_launches,
             fused_pool.fused_norm_mean_pool.f32_launches, k9.scores_segmax.f32_launches,
             flash_attention.flash_attention.launches)
    assert all(a > b for a, b in zip(after[:3], before[:3])) and after[3] == before[3]


# ------------------------------------------------- K4 and K5 [f32]

# K4 [f32] and K5 [f32] against the plain backward on the same fp32 inputs.
# Both sum fp32 products in fp32 in other orders (a gradient entry sums up
# to a few hundred terms of P or dS times an input of order 1), and the
# kernels' exp2 is the hardware's approximation (2^-22 relative): about
# sqrt(n) x 2^-24 of the entries' scale, under 1e-6 of the largest
# gradient, so 1e-5 of it (chip_smoke.BWD_F32_RTOL) holds with room.
BWD_F32_RTOL = 1e-5


def _bwd_f32_against_plain(q, k, v, do, mask, empty_row, **kw):
    """K4 [f32] and K5 [f32] through flash_attention_bwd against the plain
    backward from the same saved LSE (K1 [f32]'s): one fp32 launch each a
    call and no bf16 launch, a rerun bit-equal, within BWD_F32_RTOL of the
    largest gradient; a row with no valid key gets exactly zero."""
    fa = flash_attention
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(w.f32_launches, w.launches) for w in wrappers]
    got = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert [(w.f32_launches, w.launches) for w in wrappers] == [(f + 2, b) for f, b in before]
    want = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, **kw)
    for g, w, a in zip(got, want, again):
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, a)
        tol = BWD_F32_RTOL * float(w.abs().max())
        torch.testing.assert_close(g, w, atol=tol, rtol=0)
        if empty_row:
            assert float(g[0].abs().max()) == 0.0


@pytest.mark.parametrize("Sq,Sk,causal,window,offset,empty_row,heads,strided", BWD_CASES)
def test_flash_backward_f32_kernels(fp32_cuda, Sq, Sk, causal, window, offset, empty_row,
                                    heads, strided):
    """K4 [f32] and K5 [f32] over the bf16 forms' grid at Dh 128: causal,
    bidirectional, a window, an offset, a fully masked row, the edges of
    their 64-row blocks and 32-row tiles, the 7B head layout, views into a
    fused projection."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(70)
    q, k, v, do, mask = _bwd_inputs(gen, fp32_cuda, Sq, Sk, heads, strided, rand=_randf)
    if empty_row:
        mask[0] = 0
    _bwd_f32_against_plain(q, k, v, do, mask, empty_row, causal=causal, sliding_window=window,
                           offset=offset)


@pytest.mark.parametrize("causal,window,offset,Sq,Sk,empty_row", [
    (True, None, 0, 300, 300, False), (False, None, 0, 300, 300, True),
    (True, 64, 0, 300, 300, False), (True, None, 100, 200, 333, False)])
@pytest.mark.parametrize("Dh,H,Hkv", HEAD_DIM_GEOMETRIES)
def test_flash_backward_f32_kernels_head_dims(fp32_cuda, Dh, H, Hkv, causal, window, offset,
                                              Sq, Sk, empty_row):
    """K4 [f32] and K5 [f32] at Dh 64 (their own instances) and 96
    (flash_attention_bwd zero-pads to 128, scale 96^-0.5)."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(90 + Dh)
    q, k, v, do, mask = _bwd_inputs(gen, fp32_cuda, Sq, Sk, (H, Hkv), False, rand=_randf,
                                     Dh=Dh)
    if empty_row:
        mask[0] = 0
    _bwd_f32_against_plain(q, k, v, do, mask, empty_row, causal=causal, sliding_window=window,
                           offset=offset)


def test_flash_backward_f32_deterministic(fp32_cuda):
    """Two launches of K4 [f32] and K5 [f32] on the same inputs give
    bit-equal dQ, dK and dV (the 7B head layout: K5 sums the group of 4
    query heads inside its block, in a fixed order)."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(91)
    q, k, v, do, mask = _bwd_inputs(gen, fp32_cuda, 300, 300, (32, 8), False, rand=_randf)
    fa = flash_attention
    out, lse = fa.flash_attention(q, k, v, mask, causal=True, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal=True)
    second = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_flash_backward_f32_plan_matches_kernels(cuda):
    """The shared memory `f32_bwd_plan` computes for a Dh-128 block is the
    kernels' own (csrc/flash_attention_bwd.cu)."""
    from gritlm_tpu_torch.ops import _build

    lib = _build.load("flash_attention_bwd")
    for kind, fn in (("dq", lib.gritlm_flash_bwd_dq_f32_smem),
                     ("dkv", lib.gritlm_flash_bwd_dkv_f32_smem)):
        assert flash_attention.f32_bwd_plan(kind, 1, 64, 64, 1, 1, 128)[1] == fn(), kind


def test_flash_attention_fn_f32_on_cuda(fp32_cuda):
    """Training attention at fp32 on the card: FlashAttentionFn runs K1
    [f32] with its LSE, then K4 [f32] and K5 [f32], and its gradients follow
    autograd through the plain forward within BWD_F32_RTOL."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(92)
    leaves = [x.requires_grad_(True) for x in (_randf(gen, 2, 256, 8, 64, device=fp32_cuda),
                                               _randf(gen, 2, 256, 2, 64, device=fp32_cuda),
                                               _randf(gen, 2, 256, 2, 64, device=fp32_cuda))]
    mask = torch.ones((2, 256), dtype=torch.int32, device=fp32_cuda)
    mask[0, 200:] = 0
    do = _randf(gen, 2, 256, 8, 64, device=fp32_cuda)
    fa = flash_attention
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(w.f32_launches, w.launches) for w in wrappers]
    out = fa.FlashAttentionFn.apply(*leaves, mask, True, None, 0)
    got = torch.autograd.grad(out, leaves, do)
    assert [(w.f32_launches, w.launches) for w in wrappers] == [(f + 1, b) for f, b in before]
    ref = fa.flash_attention_plain(*leaves, mask, causal=True)
    want = torch.autograd.grad(ref, leaves, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=BWD_F32_RTOL * float(w.abs().max()), rtol=0)


@pytest.mark.parametrize("bits,rows", [(8, (1, 8, 256, 257, 512, 513)), (4, (1, 8, 128, 129))])
def test_quant_matmul_f32_activations(fp32_cuda, bits, rows):
    """fp32 x through K6 / K7 at both row routes, as the JAX wrappers take
    it: at the kernel's rows (K6 up to 512: its rows kernel and its staged
    template; K7 up to 128) one launch on x cast to bf16, the result the
    bf16 call's cast to fp32, bit for bit; above them no launch, and the
    fp32 product of x and the weight dequantized to fp32."""
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.training import quant

    gen = torch.Generator(device=fp32_cuda).manual_seed(93 + bits)
    K, N = 1024, 512
    node = _quant_node(bits, K, N, gen, fp32_cuda)
    kernel = qm.w8a16_matmul if bits == 8 else qm.w4a16_matmul
    for M in rows:
        x = _randf(gen, M, K, device=fp32_cuda)
        before = kernel.launches
        got = kernel(x, node)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (M, N)
        if qm.kernel_rows(M, bits):
            assert kernel.launches == before + 1, M
            assert torch.equal(got, kernel(x.to(torch.bfloat16), node).float()), M
        else:
            assert kernel.launches == before, M
            want = x @ quant.dequantize_kernel(node, torch.float32)
            assert torch.equal(got, want), M


def test_training_run_f32_on_cuda(fp32_cuda, tmp_path):
    """`training.run --dtype float32` on the card: two LoRA steps on the toy
    data with finite losses, every attention call through the fp32 forms of
    K1, K4 and K5 (tiny_mistral's head dim 16 zero-padded to 128), no bf16
    attention launch."""
    import math

    from gritlm_tpu_torch.training.run import main

    fa = flash_attention
    wrappers = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(w.f32_launches, w.launches) for w in wrappers]
    r = main(["--train_data", str(Path(__file__).resolve().parent / "toy_data"),
              "--model_preset", "tiny_mistral", "--dtype", "float32", "--lora",
              "--per_device_train_batch_size", "2", "--max_steps", "2", "--save_steps", "0",
              "--query_max_len", "128", "--passage_max_len", "128",
              "--generative_max_len", "64", "--output_dir", str(tmp_path / "run")])
    assert r["steps"] == 2 and all(math.isfinite(x) for x in r["final"].values())
    after = [(w.f32_launches, w.launches) for w in wrappers]
    assert all(a[0] > b[0] and a[1] == b[1] for a, b in zip(after, before))
