"""fp32 GRIT training and fp32 activations through the quantized products,
on the CPU, against the JAX package.

- K4's and K5's fp32 launch plans (pure Python, the plans the card's
  kernels take): one block per 64 rows of its own side and head, shared
  memory under the card's 227 KiB, and tiles that hold every (query, key)
  pair the forward keeps under causal, window and offset.
- `w8a16_matmul` / `w4a16_matmul` on fp32 x against the JAX wrappers: the
  result (both sides' reference product off the TPU), the row route as a
  pure function on both sides of 512 (K6) and 128 (K7) rows, and the
  kernel route's function (x cast to bf16, the kernel's bf16 output cast
  back) against the JAX Pallas kernel on fp32 x in interpret mode, with
  the port's launch stubbed by its plain version.
- `GritLM(weight_quant=8|4)` at fp32: encode and greedy generate against
  the JAX model.
- One fp32 QLoRA step and one fp32 GradCache step (each followed by two
  more, so that an update shows) at head dims 64 and 128, against the JAX
  step with its Pallas flash kernels in interpret mode.

The models are narrow Llama-3.2-1B-shaped configs (tests/test_torch_headdim.py's
keys: tied embeddings, llama3 RoPE scaling; hidden 256, 2 layers, vocab
512), float32, at head dim 64 (4 heads over 2 KV heads) and 128 (2 over
1); every sequence of the training batch is 128 long, the JAX flash
kernel's query block, and the JAX transformer's attention is
monkeypatched to `impl="flash"` (no JAX file is edited). Inputs come from
numpy seeds.

Tolerances, all fp32 on both sides with the same sums in other orders:
products 1e-5 relative (plus 1e-4 absolute at outputs of about 20);
the kernel route within one bf16 ulp of the JAX kernel's fp32 output (the
port's kernel writes bf16, the JAX kernel fp32 from the same fp32 sums);
embeddings 1e-4; greedy tokens equal; losses 1e-5 relative where both
packages hold the same adapters, 1e-3 after QLoRA's first bf16 Adam
update (tests/test_torch_quant.py: the bf16 adapters round in another
order in each package), grad norms 1e-4 (GradCache) and 1e-2 (QLoRA:
optax sums the bf16 adapters' squares in bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gritlm_tpu.ops.quant_matmul as jqm
from gritlm_tpu.config import ModelConfig as JaxModelConfig
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import transformer as jax_transformer
from gritlm_tpu.ops.attention import multi_head_attention as jax_mha
from gritlm_tpu.parallel.mesh import single_device_mesh
from gritlm_tpu.training import quant as jq
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import make_lora_train_state as jax_make_lora_train_state
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax
from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops import flash_attention as fa
from gritlm_tpu_torch.ops import quant_matmul as qm
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import quant as pq
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import make_lora_train_state

PROD_RTOL, PROD_ATOL = 1e-5, 1e-4
EMB_ATOL = 1e-4
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
SMEM_MAX = 227 * 1024  # the H100's dynamic shared memory a block
OPT = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05, remat=False)
LEN = 128  # every training sequence at the JAX flash kernel's query block
HEADS = {64: (4, 2), 128: (2, 1)}  # head dim: (heads, KV heads)
PROMPTS = ["<s><|user|>\nWhat is a cache?\n<|assistant|>\n", "abc"]
DOCS = ["Bitcoin is a digital currency.", "A KV cache stores keys and values."]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------- K4/K5 [f32] plans


@pytest.mark.parametrize("Sq,Sk,causal,window,offset", [
    (1, 1, False, 0, 0), (64, 64, True, 0, 0), (65, 97, False, 0, 0),
    (200, 333, True, 0, 100), (300, 300, True, 64, 0), (129, 700, True, 40, 500),
    (77, 333, True, 0, 128), (2048, 2048, True, 512, 0), (33, 1000, True, 1, 900),
    (256, 256, False, 0, 0)])
@pytest.mark.parametrize("Dh", [64, 128])
def test_f32_bwd_plan_covers_the_kept_pairs(Sq, Sk, causal, window, offset, Dh):
    """K4 [f32]: one block per (64 query rows, head, batch row), whose key
    tiles hold every key its rows keep; K5 [f32]: one block per (64 keys,
    kv head, batch row), whose query tiles hold every query row that keeps
    one of its keys; every tile starts inside the sequence, and a block's
    shared memory fits the card's."""
    B, H, Hkv = 2, 8, 2
    for kind, rows, heads in (("dq", Sq, H), ("dkv", Sk, Hkv)):
        grid, smem = fa.f32_bwd_plan(kind, B, Sq, Sk, H, Hkv, Dh)
        assert grid == (-(-rows // fa.F32_BWD_ROWS), heads, B)
        assert 0 < smem <= SMEM_MAX
    keep = fa.keep_mask(None, Sq, Sk, causal=causal, sliding_window=window or None,
                        offset=offset, device="cpu")[0].numpy()
    kw = dict(causal=causal, window=window, offset=offset)
    step = fa.F32_BWD_TILE
    for q0 in range(0, Sq, fa.F32_BWD_ROWS):
        seen = np.zeros(Sk, dtype=bool)
        for t in fa.f32_dq_key_tiles(q0, Sq, Sk, **kw):
            assert 0 <= t < Sk
            seen[t:t + step] = True
        need = keep[q0:q0 + fa.F32_BWD_ROWS].any(0)
        assert not (need & ~seen).any(), q0
    for k0 in range(0, Sk, fa.F32_BWD_ROWS):
        seen = np.zeros(Sq, dtype=bool)
        for t in fa.f32_dkv_query_tiles(k0, Sq, Sk, **kw):
            assert 0 <= t < Sq
            seen[t:t + step] = True
        need = keep[:, k0:k0 + fa.F32_BWD_ROWS].any(1)
        assert not (need & ~seen).any(), k0


# ---------------------------------------------------- K6/K7 on fp32 x

K, N = 512, 256


def _nodes(bits: int, seed: int):
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    if bits == 8:
        return jq.quantize_kernel(jnp.asarray(w)), pq.quantize_kernel(torch.from_numpy(w))
    return jq.quantize_kernel_int4(jnp.asarray(w)), pq.quantize_kernel_int4(torch.from_numpy(w))


def _wrappers(bits: int):
    return ((jqm.w8a16_matmul, qm.w8a16_matmul) if bits == 8
            else (jqm.w4a16_matmul, qm.w4a16_matmul))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 127, 128, 129, 511, 512, 513])
def test_quant_matmul_f32_matches_jax(bits, M):
    """fp32 x [M, K] through the port's wrapper on the CPU against the JAX
    wrapper off the TPU: fp32 out, the same product on both sides of the
    row ceilings."""
    jnode, pnode = _nodes(bits, 10 + bits)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    jfn, pfn = _wrappers(bits)
    want = np.asarray(jfn(jnp.asarray(x), jnode))
    got = pfn(torch.from_numpy(x), pnode)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=PROD_RTOL, atol=PROD_ATOL)


@pytest.mark.parametrize("bits,M", [(8, 1), (8, 511), (8, 512), (8, 513), (8, 4096),
                                    (4, 1), (4, 127), (4, 128), (4, 129), (4, 512)])
def test_quant_row_route_matches_jax(monkeypatch, bits, M):
    """`kernel_rows` names the JAX wrapper's route: its Pallas call is
    reached (kernels forced on, as its tests force them) exactly where the
    port's kernel route is taken, on both sides of 512 (K6) and 128 (K7)."""
    monkeypatch.setattr(jqm, "_FORCE_KERNEL", True)
    called = []

    def fake_call(x2, w, *args, out_dtype, **kw):
        called.append(x2.shape)
        return jnp.zeros((x2.shape[0], w.shape[-1]), out_dtype)

    monkeypatch.setattr(jqm, "_w8_call" if bits == 8 else "_w4_call", fake_call)
    jnode, _ = _nodes(bits, 20 + bits)
    jfn, _ = _wrappers(bits)
    jfn(jnp.zeros((M, K), jnp.float32), jnode)
    assert bool(called) == qm.kernel_rows(M, bits)
    assert qm.kernel_rows(M, bits) == (M <= (512 if bits == 8 else 128))


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors down the wrapper's kernel route: `plain_path` says False
    and the launch runs the kernel's plain version on the bf16 rows the
    wrapper hands it, returning bf16 as the kernel writes."""
    monkeypatch.setattr(_build, "plain_path", lambda *ts: False)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(qm, "_fn", lambda name: name)
    launched = []

    def launch(fn, what, x2, q, scale, M, K, N, planned, *group):
        assert x2.dtype == torch.bfloat16 and x2.is_contiguous() and x2.shape == (M, K)
        launched.append(fn)
        if fn == "gritlm_w8a16_matmul":
            return qm.w8a16_matmul_plain(x2, {"q8": q, "scale": scale})
        return qm.w4a16_matmul_plain(x2, {"q4": q, "scale": scale})

    monkeypatch.setattr(qm, "_launch", launch)
    return launched


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 17])
def test_kernel_route_f32_matches_jax_kernel(kernel_route, monkeypatch, bits, M):
    """fp32 x at the kernel's rows: the port's wrapper hands the kernel x
    cast to bf16 and returns its output in fp32, one launch; against the
    JAX wrapper forced through its Pallas kernel (interpret mode: x cast to
    bf16, fp32 sums, fp32 out) within one bf16 ulp of each output."""
    monkeypatch.setattr(jqm, "_FORCE_KERNEL", True)
    jnode, pnode = _nodes(bits, 30 + bits)
    x = np.random.default_rng(M + 40).standard_normal((M, K)).astype(np.float32)
    jfn, pfn = _wrappers(bits)
    want = np.asarray(jfn(jnp.asarray(x), jnode))
    got = pfn(torch.from_numpy(x), pnode)
    assert len(kernel_route) == 1 and got.dtype == torch.float32
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.numpy() - want) <= ulp).all()


# ---------------------------------------------------- the fp32 models


def llama_dict(head_dim: int) -> dict:
    """The published Llama-3.2-1B config.json keys, narrowed: 2 layers,
    hidden 256, vocab 512, `head_dim` with HEADS' head counts, float32."""
    heads, kv = HEADS[head_dim]
    return {
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": heads, "num_key_value_heads": kv,
        "head_dim": head_dim, "vocab_size": 512, "max_position_embeddings": 131072,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        "torch_dtype": "float32",
    }


@functools.lru_cache(maxsize=None)
def _setup(head_dim: int):
    """(JAX config, port config, JAX params, numpy params, batch of 4)."""
    jcfg = JaxModelConfig.from_hf_config(llama_dict(head_dim))
    tcfg = ModelConfig.from_hf_config(llama_dict(head_dim))
    assert jcfg.head_dim_ == tcfg.head_dim_ == head_dim and tcfg.dtype == "float32"
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(head_dim))
    coll = GritCollator(ByteTokenizer(), query_max_len=LEN, passage_max_len=LEN,
                        generative_max_len=LEN)
    feats = [(("find it", f"query number {i}"),
              [("find it", f"matching passage {i}"), ("find it", f"junk {i}")],
              [f"what is {i}?", f"it is {i}, " * (4 + 3 * i)]) for i in range(4)]
    return jcfg, tcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), coll(feats)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_weight_quant_f32_matches_jax(head_dim, bits):
    """GritLM(weight_quant=8|4) at fp32 activations: encode within EMB_ATOL
    and greedy tokens (decode rows through the quantized products' kernel
    route, prefill above it for K7) equal to the JAX model's."""
    jcfg, tcfg, jparams, np_params, _ = _setup(head_dim)
    jm = JaxGritLM(jcfg, params=jparams, weight_quant=bits)
    pm = GritLM(tcfg, params=params_from_jax(np_params, tcfg, device="cpu"), device="cpu",
                weight_quant=bits)
    np.testing.assert_allclose(pm.encode(DOCS), np.asarray(jm.encode(DOCS)), atol=EMB_ATOL)
    enc = jm.tokenizer(PROMPTS)
    want = np.asarray(jm.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                           max_new_tokens=8).tokens)
    got = pm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX transformer's attention through its Pallas flash kernel."""
    monkeypatch.setattr(jax_transformer, "multi_head_attention",
                        functools.partial(jax_mha, impl="flash"))


def _assert_metrics(m, jm, step, loss_rtol, norm_rtol):
    for name in ("loss", "loss_emb", "loss_gen"):
        np.testing.assert_allclose(float(getattr(m, name)), float(getattr(jm, name)),
                                   rtol=loss_rtol, atol=1e-6, err_msg=f"step {step} {name}")
    np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm), rtol=norm_rtol,
                               err_msg=f"step {step} grad_norm")


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_qlora_f32_step_matches_jax(head_dim, jax_flash):
    """fp32 QLoRA: the int8 base (bytes equal to the JAX package's),
    bf16 adapters over it (both packages' choice over an int8 base), the
    base dequantized to the fp32 activations' dtype in each layer. Steps 1
    and 2 from the same adapters (the first update's learning rate is 0)
    within LOSS_RTOL; step 3 after the first Adam update within 1e-3."""
    jcfg, tcfg, jparams, np_params, batch = _setup(head_dim)
    jrun, jstate, jbase, _ = jax_make_lora_train_state(
        single_device_mesh(), jcfg, jt.TrainConfig(mode="unified", **OPT), jparams, r=4,
        alpha=8, quantize=True, seed=3)
    tc = pt.TrainConfig(mode="unified", **OPT)
    run, state, base, _ = make_lora_train_state(
        tcfg, tc, params_from_jax(np_params, tcfg, device="cpu"), r=4, alpha=8,
        quantize=True, device="cpu")
    np.testing.assert_array_equal(base["layers"]["attn"]["wq"]["q8"].numpy(),
                                  np.asarray(jbase["layers"]["attn"]["wq"]["q8"]))
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu")
    with torch.no_grad():  # the JAX package's adapters in the port's state
        for name, node in state.params["layers"].items():
            for w, ab in node.items():
                for x in ("A", "B"):
                    assert ab[x].dtype == torch.bfloat16
                    ab[x].copy_(start["layers"][name][w][x])
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    for step in (1, 2, 3):
        jstate, jm = jrun(jstate, jbatch)
        state, m = run(state, batch)
        _assert_metrics(m, jm, step, LOSS_RTOL if step < 3 else 1e-3, 1e-2)
    assert float(state.params["layers"]["mlp"]["up"]["B"].detach().abs().max()) > 0


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_gradcache_f32_step_matches_jax(head_dim, jax_flash):
    """fp32 GradCache: full-parameter unified steps with the batch's 4
    queries in 2 chunks, against the JAX train_step with gc_chunks 2 from
    the same weights: losses within LOSS_RTOL and grad norms within
    NORM_RTOL at each of 3 steps (step 3 after the first update)."""
    jcfg, tcfg, jparams, np_params, batch = _setup(head_dim)
    jtc = jt.TrainConfig(mode="unified", gc_chunks=2, **OPT)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tc = pt.TrainConfig(mode="unified", gc_chunks=2, **OPT)
    state = pt.init_train_state(params_from_jax(np_params, tcfg, device="cpu"), tc)
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jbatch, jcfg, jtc)
        state, m = pt.train_step(state, batch, tcfg, tc)
        _assert_metrics(m, jm, step, LOSS_RTOL, NORM_RTOL)
