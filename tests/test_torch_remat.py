"""The remat policies of the port's trunk (`forward(remat_policy=...)`,
`TrainConfig.remat_policy`) on tiny_mistral, float32 on the CPU.

A policy decides what a checkpointed layer keeps from its forward instead
of recomputing it; the recompute runs the same ops on the same inputs, so
losses and gradients are bit-equal under every policy and without remat.
Against the JAX `train_step` with the same `remat_policy`, a dense and a
LoRA step hold tests/test_torch_train.py's tolerances (losses rtol 1e-5,
grad norms 1e-4, parameters after three AdamW steps atol 5e-5). The
dispatch count shows what each policy saves, as its JAX namesake: "dots"
every matrix product (the recompute runs no projection `mm` and no plain
attention `bmm`), "dots_no_batch" the products without a batch dimension
(the recompute runs the attention `bmm`s but no `mm`), None nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax, params_to_numpy
from gritlm_tpu_torch.models.transformer import forward, logits_from_hidden
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import make_lora_train_state

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 5e-5
OPT = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05)
POLICIES = [None, "full", "dots", "dots_no_batch"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(bs=4, group=2, qlen=32, plen=32, glen=48):
    coll = GritCollator(ByteTokenizer(), query_max_len=qlen, passage_max_len=plen,
                        generative_max_len=glen)
    feats = []
    for i in range(bs):
        q = ("find it", f"query number {i}")
        ps = [("find it", f"matching passage {i}")] + [
            ("find it", f"junk {i} {j}") for j in range(group - 1)]
        feats.append((q, ps, [f"what is {i}?", f"it is {i}"]))
    return coll(feats)


@pytest.fixture(scope="module")
def setup():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams), _batch()


def _one_step(np_params, batch, remat, policy, gc_chunks):
    """One port train_step (its update has LR 0): the metrics and every
    parameter's gradient."""
    tc = pt.TrainConfig(mode="unified", remat=remat, remat_policy=policy, gc_chunks=gc_chunks,
                        **OPT)
    state = pt.init_train_state(params_from_jax(np_params, tiny_mistral(), device="cpu"), tc)
    state, m = pt.train_step(state, batch, tiny_mistral(), tc)
    return m, [t.grad.clone() for t in pt.leaves(state.params)]


@pytest.fixture(scope="module")
def no_remat(setup):
    _, np_params, batch = setup
    return {gc: _one_step(np_params, batch, False, None, gc) for gc in (1, 2)}


@pytest.mark.parametrize("gc_chunks", [1, 2], ids=["full_batch", "gradcache"])
@pytest.mark.parametrize("policy", POLICIES, ids=[str(p) for p in POLICIES])
def test_policies_bit_equal(setup, no_remat, policy, gc_chunks):
    """Each policy's losses and gradients equal, bit for bit, those of the
    step without remat (GradCache too)."""
    _, np_params, batch = setup
    m, grads = _one_step(np_params, batch, True, policy, gc_chunks)
    m0, grads0 = no_remat[gc_chunks]
    for name in ("loss", "loss_emb", "loss_gen", "grad_norm"):
        assert torch.equal(getattr(m, name), getattr(m0, name)), name
    assert len(grads) == len(grads0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def _assert_metrics(m_port, m_jax, step):
    for name in ("loss", "loss_emb", "loss_gen"):
        np.testing.assert_allclose(float(getattr(m_port, name)), float(getattr(m_jax, name)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=f"step {step} {name}")
    np.testing.assert_allclose(float(m_port.grad_norm), float(m_jax.grad_norm),
                               rtol=NORM_RTOL, err_msg=f"step {step} grad_norm")


def _assert_tree_close(got: dict, want: dict, atol: float, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                       err_msg=f"{path}/{k}")


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", None])
def test_dense_step_matches_jax(setup, policy):
    """Three full-parameter steps under the same remat policy in both
    packages."""
    jparams, np_params, batch = setup
    jtc = jt.TrainConfig(mode="unified", remat=True, remat_policy=policy, **OPT)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tc = pt.TrainConfig(mode="unified", remat=True, remat_policy=policy, **OPT)
    state = pt.init_train_state(params_from_jax(np_params, tiny_mistral(), device="cpu"), tc)
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jbatch, jax_tiny_mistral(), jtc)
        state, m = pt.train_step(state, batch, tiny_mistral(), tc)
        _assert_metrics(m, jm, step)
    _assert_tree_close(params_to_numpy(state.params),
                       jax.tree_util.tree_map(np.asarray, jstate.params), PARAM_ATOL)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_lora_step_matches_jax(setup, policy):
    """Three LoRA steps (the lazy W + A B inside the checkpointed layer)
    under the same remat policy in both packages, from the same adapters."""
    jparams, np_params, batch = setup
    jtc = jt.TrainConfig(mode="unified", remat=True, remat_policy=policy, **OPT)
    jlora, scale = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    loss_fn = jax_lora_fns(jparams, jax_tiny_mistral(), jtc, scale)
    opt = jt.make_optimizer(jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = opt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg, optax.global_norm(g))

    tc = pt.TrainConfig(mode="unified", remat=True, remat_policy=policy, **OPT)
    run_step, state, _, _ = make_lora_train_state(
        tiny_mistral(), tc, params_from_jax(np_params, tiny_mistral(), device="cpu"), r=4,
        alpha=8, seed=0, device="cpu")
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


class _CountDots(TorchDispatchMode):
    """Counts the mm and bmm calls dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_dots(np_params, remat, policy):
    """mm / bmm calls in the backward of a causal forward + LM-head loss
    over every parameter (the recompute, if any, runs inside it)."""
    cfg = tiny_mistral()
    params = params_from_jax(np_params, cfg, device="cpu")
    leaves = pt.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.arange(3, 35).reshape(2, 16)
    mask = torch.ones((2, 16), dtype=torch.int32)
    mask[1, 12:] = 0
    hidden, _, _ = forward(params, cfg, ids, attention_mask=mask, causal=True, remat=remat,
                           remat_policy=policy)
    loss = logits_from_hidden(params, cfg, hidden).logsumexp(-1).mean()
    count = _CountDots()
    with count:
        loss.backward()
    return count.n


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_policy_saves_what_its_jax_namesake_saves(setup, policy):
    """The recompute's products: the backward's mm / bmm calls under the
    policy less those of the backward without remat (which recomputes
    nothing). "dots": none; "dots_no_batch": the plain attention's two
    einsums a layer (bmm) but no projection (mm); None: both."""
    _, np_params, _ = setup
    base = _backward_dots(np_params, False, None)
    got = _backward_dots(np_params, True, policy)
    recompute = {k: got[k] - base[k] for k in base}
    layers = tiny_mistral().num_hidden_layers
    want_bmm = {None: 2 * layers, "dots": 0, "dots_no_batch": 2 * layers}[policy]
    assert recompute["bmm"] == want_bmm, (recompute, base)
    if policy is None:
        # the layer's projections up to the last one the backward needs
        # (non-reentrant checkpointing stops its recompute there)
        assert recompute["mm"] >= 6 * layers, (recompute, base)
    else:
        assert recompute["mm"] == 0, (recompute, base)


def test_unknown_policy_raises(setup):
    """An unknown name raises ValueError naming the four policies (the JAX
    package raises KeyError), from forward and from a train step."""
    _, np_params, batch = setup
    cfg = tiny_mistral()
    params = params_from_jax(np_params, cfg, device="cpu")
    ids = torch.arange(3, 11).reshape(1, 8)
    with pytest.raises(ValueError, match="'dots_no_batch'"):
        forward(params, cfg, ids, remat=True, remat_policy="dot")
    tc = pt.TrainConfig(mode="unified", remat=True, remat_policy="saveable", **OPT)
    with pytest.raises(ValueError, match="unknown remat_policy 'saveable'"):
        pt.train_step(pt.init_train_state(params, tc), batch, cfg, tc)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_qlora_step_policies_bit_equal(setup, policy):
    """QLoRA (the int8 base dequantized inside the checkpointed layer) takes
    the policy unchanged: two steps' losses and adapters bit-equal to the
    full recompute's."""
    _, np_params, batch = setup
    runs = []
    for pol in (None, policy):
        tc = pt.TrainConfig(mode="unified", remat=True, remat_policy=pol, **OPT)
        run_step, state, _, _ = make_lora_train_state(
            tiny_mistral(), tc, params_from_jax(np_params, tiny_mistral(), device="cpu"), r=4,
            alpha=8, quantize=True, seed=0, device="cpu")
        losses = []
        for _ in range(2):
            state, m = run_step(state, batch)
            losses.append(m.loss)
        runs.append((torch.stack(losses), [t.detach().clone() for t in pt.leaves(state.params)]))
    (l0, a0), (l1, a1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(a0, a1))
