"""The port's GRIT training at head dims 64 and 96 against the JAX package's,
on the narrow Llama-3.2-1B-shaped models of tests/test_torch_headdim.py
(float32, CPU), and the arguments `FlashAttentionFn` hands the kernels at
those head dims.

Train steps: three full-parameter steps and three LoRA steps from the same
weights (`params_from_jax`) and adapters (`lora_from_jax`) on the same
numpy batch (the port's collator over seeded samples), with query, passage
and generative lengths of 128, so every attention call of the JAX step
reaches its Pallas flash kernels (forward, `_bwd_dq_kernel`,
`_bwd_dkv_kernel`) in interpret mode: the JAX transformer's
`multi_head_attention` is monkeypatched to `impl="flash"` (on the CPU it
picks the einsum reference; no JAX file is edited). The JAX kernel pads
Dh 64 and 96 to 128 lanes and folds sqrt(128 / Dh) into q; the port runs
its plain versions (CPU tensors). Tolerances are tests/test_torch_train.py's:
losses rtol 1e-5, grad norms rtol 1e-4, parameters after three AdamW steps
atol 5e-5, but for the entries whose (clipped) gradient fell below
UNRESOLVED (1e-6) at some step. As tests/test_torch_moe_train.py sets out,
the packages' float32 gradients differ by up to about 1e-7, so such an
entry's gradient is known to a tenth or worse, and Adam (its update is
about the gradient's sign) can turn that into an update far apart. With
tied embeddings every embedding row takes a gradient through the LM head,
5% of them below 1e-6 (an entry of 3e-8 at Dh 96 ended 7.4e-5 apart); the
clip leaves 14% of wq below it. Those entries are held to the learning
rate summed over the steps, which bounds Adam's step.

The CLI on a tied checkpoint: `training.run --model_name_or_path <the
narrow Llama checkpoint> --lora` writes the export the JAX exporter writes
for the same config (config.json equal; tensor names, shapes and dtypes
equal: no lm_head), which both packages' loaders read with equal values.

Kernel arguments: with `_build.plain_path` and the kernel entry points
stubbed (no card needed), `FlashAttentionFn` at Dh 64 hands K1, K4 and K5
head dim 64 and scale 64^-0.5; at Dh 96 it hands all three width 128 (q, k,
v and dO zero-padded) and scale 96^-0.5, and returns gradients of the
unpadded shapes; at Dh 100 and 256 it raises NotImplementedError before a
kernel is reached.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gritlm_tpu.config import ModelConfig as JaxModelConfig
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import loader as jax_loader
from gritlm_tpu.models import transformer as jax_transformer
from gritlm_tpu.ops.attention import multi_head_attention as jax_mha
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models import loader
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax, params_to_numpy
from gritlm_tpu_torch.ops import _build
from gritlm_tpu_torch.ops import flash_attention as fa
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import make_lora_train_state
from gritlm_tpu_torch.training.run import main
from test_torch_headdim import HEADS, llama_dict

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 5e-5
UNRESOLVED = 1e-6
OPT = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05, remat=False)
LEN = 128  # every sequence at the JAX flash kernel's minimum query block


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX transformer's attention through its Pallas flash kernel."""
    monkeypatch.setattr(jax_transformer, "multi_head_attention",
                        functools.partial(jax_mha, impl="flash"))


@functools.lru_cache(maxsize=None)
def _setup(head_dim: int):
    """(JAX config, port config, JAX params, numpy params, batch)."""
    jcfg = JaxModelConfig.from_hf_config(llama_dict(head_dim))
    tcfg = ModelConfig.from_hf_config(llama_dict(head_dim))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    coll = GritCollator(ByteTokenizer(), query_max_len=LEN, passage_max_len=LEN,
                        generative_max_len=LEN)
    feats = [(("find it", f"query number {i}"),
              [("find it", f"matching passage {i}"), ("find it", f"junk {i}")],
              [f"what is {i}?", f"it is {i}, " * (4 + 3 * i)]) for i in range(2)]
    return jcfg, tcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), coll(feats)


def _assert_tree_close(got: dict, want: dict, atol: float, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                       err_msg=f"{path}/{k}")


def _mark_unresolved(state, unresolved: dict) -> None:
    """Mark the entries whose gradient this step (left in .grad) is nonzero
    and below UNRESOLVED; an exact zero is exact in both packages."""
    for t in pt.leaves(state.params):
        g = t.grad.abs()
        low = (g > 0) & (g < UNRESOLVED)
        unresolved[id(t)] = low | unresolved[id(t)] if id(t) in unresolved else low


def _assert_params_close(params: dict, want: dict, unresolved: dict, lr_sum: float, path=""):
    """The trained leaves against the JAX tree at PARAM_ATOL, but for the
    entries marked in `unresolved` (by leaf id), held to `lr_sum`."""
    for k, v in params.items():
        if isinstance(v, dict):
            _assert_params_close(v, want[k], unresolved, lr_sum, f"{path}/{k}")
            continue
        got, exp = v.detach().numpy(), np.asarray(want[k])
        low = unresolved[id(v)].numpy()
        np.testing.assert_allclose(got[~low], exp[~low], atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{path}/{k}")
        assert np.abs(got[low] - exp[low]).max(initial=0.0) <= lr_sum, (path, k)


def _assert_metrics(m_port, m_jax, step):
    for name in ("loss", "loss_emb", "loss_gen"):
        np.testing.assert_allclose(float(getattr(m_port, name)), float(getattr(m_jax, name)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=f"step {step} {name}")
    np.testing.assert_allclose(float(m_port.grad_norm), float(m_jax.grad_norm),
                               rtol=NORM_RTOL, err_msg=f"step {step} grad_norm")


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_batch_reaches_the_jax_flash_kernel(head_dim):
    """Every part of the batch is LEN long (the collator pads to its fixed
    lengths): the JAX flash kernel takes every attention call."""
    *_, batch = _setup(head_dim)
    assert {part["input_ids"].shape[1] for part in batch.values()} == {LEN}
    assert set(batch) == {"query", "passage", "generative"}


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_train_step_matches_jax(head_dim, jax_flash):
    """Three full-parameter unified steps (tied embeddings: the LM head is
    the embedding's transpose and its gradient flows into it)."""
    jcfg, tcfg, jparams, np_params, batch = _setup(head_dim)
    jtc = jt.TrainConfig(mode="unified", **OPT)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tc = pt.TrainConfig(mode="unified", **OPT)
    state = pt.init_train_state(params_from_jax(np_params, tcfg, device="cpu"), tc)
    assert "lm_head" not in state.params
    unresolved = {}
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jbatch, jcfg, jtc)
        state, m = pt.train_step(state, batch, tcfg, tc)
        _assert_metrics(m, jm, step)
        _mark_unresolved(state, unresolved)
    lr_sum = sum(tc.learning_rate * pt.lr_factor(tc)(c) for c in range(3))
    _assert_params_close(state.params, jax.tree_util.tree_map(np.asarray, jstate.params),
                         unresolved, lr_sum)


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_lora_train_step_matches_jax(head_dim, jax_flash):
    """Three LoRA steps (adapters trained, base frozen) against the JAX LoRA
    loss under its optax chain, from the same adapters."""
    jcfg, tcfg, jparams, np_params, batch = _setup(head_dim)
    jtc = jt.TrainConfig(mode="unified", **OPT)
    jlora, scale = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    loss_fn = jax_lora_fns(jparams, jcfg, jtc, scale)
    opt = jt.make_optimizer(jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = opt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg, optax.global_norm(g))

    tc = pt.TrainConfig(mode="unified", **OPT)
    run_step, state, _, port_scale = make_lora_train_state(
        tcfg, tc, params_from_jax(np_params, tcfg, device="cpu"), r=4, alpha=8, seed=0,
        device="cpu")
    assert port_scale == scale
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora), device="cpu")
    with torch.no_grad():  # the JAX package's adapters in the port's state
        for name, node in state.params["layers"].items():
            for w, ab in node.items():
                for x in ("A", "B"):
                    ab[x].copy_(start["layers"][name][w][x])
    cur, opt_state = jlora, opt.init(jlora)
    for step in (1, 2, 3):
        cur, opt_state, (loss, le, lg, gn) = jstep(cur, opt_state)
        state, m = run_step(state, batch)
        _assert_metrics(m, pt.StepMetrics(loss, le, lg, gn), step)
    _assert_tree_close(params_to_numpy(state.params),
                       jax.tree_util.tree_map(np.asarray, cur), PARAM_ATOL)
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_tied_lora_export_matches_jax(tmp_path, head_dim):
    """Two LoRA steps of the CLI from a tied checkpoint written by the port:
    the export's config.json and tensor names, shapes and dtypes are the JAX
    exporter's for the same config and params (no lm_head.weight), and the
    JAX loader reads it with the port loader's values and config."""
    from safetensors.numpy import load_file

    jcfg, tcfg, jparams, np_params, _ = _setup(head_dim)
    ckpt = tmp_path / "ckpt"
    loader.save_checkpoint(str(ckpt), tcfg, params_from_jax(np_params, tcfg, device="cpu"))
    r = main(["--train_data", os.path.join(os.path.dirname(__file__), "toy_data"),
              "--device", "cpu", "--model_name_or_path", str(ckpt), "--lora", "--lora_r", "4",
              "--mode", "unified", "--per_device_train_batch_size", "2", "--max_steps", "2",
              "--query_max_len", str(LEN), "--passage_max_len", str(LEN),
              "--generative_max_len", str(LEN), "--learning_rate", "1e-3",
              "--output_dir", str(tmp_path / "run")])
    assert r["steps"] == 2 and np.isfinite(r["final"]["loss"])
    jax_loader.save_checkpoint(str(tmp_path / "jax"), jcfg, jparams)
    export = r["export"]
    assert (json.loads(open(os.path.join(export, "config.json")).read())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))
    got = load_file(os.path.join(export, "model.safetensors"))
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    assert "lm_head.weight" not in got
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    cfg, pp = loader.load_checkpoint(export, device="cpu")
    back_cfg, jp = jax_loader.load_checkpoint(export)
    assert cfg == tcfg and dataclasses.asdict(cfg) == dataclasses.asdict(back_cfg)
    _assert_tree_close(params_to_numpy(pp), jax.tree_util.tree_map(np.asarray, jp), 0.0)


# ------------------------------------------------ the kernels' arguments

# each entry point's position of the head dim it runs and of the softmax
# scale, as ops/flash_attention._fn declares them
ENTRY_POINTS = {"gritlm_flash_fwd": 11, "gritlm_flash_bwd_dq": 13, "gritlm_flash_bwd_dkv": 14}


@pytest.fixture
def kernel_calls(monkeypatch):
    """CPU tensors down the kernel path: `plain_path` says False and each
    entry point records its arguments and returns 0 (its outputs stay as
    torch.empty left them)."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "plain_path", lambda *ts: False)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(fa, "_fn", lambda name="gritlm_flash_fwd", lib=None: entry(name))
    return calls


def _leaves(Dh, H=4, Hkv=2, S=16):
    g = torch.Generator().manual_seed(Dh)
    return [torch.randn((2, S, h, Dh), generator=g).to(torch.bfloat16).requires_grad_()
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("Dh,width", [(64, 64), (96, 128)])
def test_flash_attention_fn_kernel_arguments(kernel_calls, Dh, width):
    """K1 (with its LSE), K4 and K5 each launched once, at the kernels'
    width with the true head dim's scale; q's sequence stride is that of
    the width (the padded copy at Dh 96); the gradients have the inputs'
    shapes."""
    q, k, v = _leaves(Dh)
    out = fa.FlashAttentionFn.apply(q, k, v, None, True, None, 0)
    assert out.shape == q.shape
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert [name for name, _ in kernel_calls] == list(ENTRY_POINTS)
    for name, args in kernel_calls:
        at = ENTRY_POINTS[name]
        assert args[at] == width, name
        assert args[-2] == pytest.approx(Dh ** -0.5, rel=1e-12), name
        assert args[at + 2] == 4 * width, name  # q.stride(1): H heads of the width
    fwd_lse = kernel_calls[0][1][5]
    assert fwd_lse is not None
    for g, x in zip(grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype


@pytest.mark.parametrize("Dh", [100, 256])
def test_flash_attention_fn_raises_above_or_off_the_pad(kernel_calls, Dh):
    """A head dim neither compiled nor paddable to 128 (not a multiple of 8,
    or above 128) raises before any kernel is reached."""
    q, k, v = _leaves(Dh)
    with pytest.raises(NotImplementedError):
        fa.FlashAttentionFn.apply(q, k, v, None, True, None, 0)
    assert kernel_calls == []
