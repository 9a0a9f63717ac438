"""The port's GRIT training against the JAX package's on tiny_mistral
(float32): every loss and its gradient, and three train steps (unified,
GradCache, the q/p stop-gradient flags, LoRA) with the JAX params carried
over by `params_from_jax`.

The same numpy batch (the port's collator over seeded toy samples) goes to
both. The schedule makes the first update's LR 0 in both packages, so the
checks run to step 3. Tolerances, all float32: losses and loss gradients
rtol 1e-5 (the same sums in another order); grad norms rtol 1e-4 (sums of
squares over every parameter); parameters after three AdamW steps atol 5e-5, against updates
of up to 2e-3 a step (Adam's m / (sqrt(v) + eps) turns last-bit gradient
differences of near-zero entries into differences of a few 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.training import losses as jl
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax, params_to_numpy
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import losses as pl
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import lora_train_step_fns, make_lora_train_state

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 5e-5
OPT = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05)


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
    jcfg = jax_tiny_mistral()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, np_params, _batch()


def _assert_tree_close(got: dict, want: dict, atol: float, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                       err_msg=f"{path}/{k}")


def _assert_metrics(m_port, m_jax, step):
    for name in ("loss", "loss_emb", "loss_gen"):
        np.testing.assert_allclose(float(getattr(m_port, name)), float(getattr(m_jax, name)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=f"step {step} {name}")
    np.testing.assert_allclose(float(m_port.grad_norm), float(m_jax.grad_norm),
                               rtol=NORM_RTOL, err_msg=f"step {step} grad_norm")


# ---------------------------------------------------------------------------
# losses


def test_contrastive_loss_and_grad():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    p = rng.normal(size=(8, 16)).astype(np.float32)
    want, (wq, wp) = jax.value_and_grad(jl.contrastive_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(p), 0.05)
    tq, tp = (torch.from_numpy(x).requires_grad_(True) for x in (q, p))
    got = pl.contrastive_loss(tq, tp, 0.05)
    gq, gp = torch.autograd.grad(got, (tq, tp))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    # gradients reach 16 at temperature 0.05: atol 1e-5 is 1e-6 of that
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), rtol=LOSS_RTOL, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=LOSS_RTOL, atol=1e-5)


@pytest.mark.parametrize("loss_type,factor", [("mixed", 1.0), ("token", 0.003), ("mixed", 2.0)])
def test_next_token_losses_and_grads(loss_type, factor):
    """next_token_loss and the fused (vocab-chunked) loss against the JAX
    package's, values and gradients; fused against unfused in the port."""
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 12, 16, 40
    hidden = rng.normal(size=(B, S, D)).astype(np.float32)
    kernel = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S))
    labels[0, :5] = -100
    labels[1, -3:] = -100

    def j_unfused(h, w):
        return jl.next_token_loss(h @ w, jnp.asarray(labels), loss_type, factor)

    def j_fused(h, w):
        return jl.fused_next_token_loss(h, w, jnp.asarray(labels), loss_type, factor,
                                        vocab_chunk=16)

    th, tw = (torch.from_numpy(x).requires_grad_(True) for x in (hidden, kernel))
    tl = torch.from_numpy(labels)
    ports = {
        "unfused": lambda: pl.next_token_loss(th @ tw, tl, loss_type, factor),
        "fused": lambda: pl.fused_next_token_loss(th, tw, tl, loss_type, factor,
                                                  vocab_chunk=16),
    }
    results = {}
    for name, jfn in (("unfused", j_unfused), ("fused", j_fused)):
        want, wgrads = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(hidden),
                                                               jnp.asarray(kernel))
        got = ports[name]()
        grads = torch.autograd.grad(got, (th, tw))
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL,
                                   err_msg=name)
        for g, w in zip(grads, wgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=name)
        results[name] = (float(got.detach()), [g.numpy() for g in grads])
    np.testing.assert_allclose(results["fused"][0], results["unfused"][0], rtol=LOSS_RTOL)
    for a, b in zip(results["fused"][1], results["unfused"][1]):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# train_step


VARIANTS = {
    "unified": dict(),
    "gradcache": dict(gc_chunks=2),
    "no q grad": dict(q_grad=False),
    "gradcache no p grad": dict(gc_chunks=2, p_grad=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax(setup, variant):
    jcfg, jparams, np_params, batch = setup
    kw = dict(OPT, remat=False, **VARIANTS[variant])
    jtc = jt.TrainConfig(mode="unified", **kw)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    cfg = tiny_mistral()
    tc = pt.TrainConfig(mode="unified", **kw)
    state = pt.init_train_state(params_from_jax(np_params, cfg, device="cpu"), tc)
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jbatch, jcfg, jtc)
        state, m = pt.train_step(state, batch, cfg, tc)
        _assert_metrics(m, jm, step)
    assert state.step == 3
    _assert_tree_close(params_to_numpy(state.params),
                       jax.tree_util.tree_map(np.asarray, jstate.params), PARAM_ATOL)


def test_lora_train_step_matches_jax(setup):
    """make_lora_train_state's step (adapters only trained, base frozen)
    against the JAX package's LoRA loss under its optax chain, from the
    same adapters (lora_from_jax)."""
    jcfg, jparams, np_params, batch = setup
    jtc = jt.TrainConfig(mode="unified", remat=False, **OPT)
    jlora, scale = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    loss_fn = jax_lora_fns(jparams, jcfg, jtc, scale)
    opt = jt.make_optimizer(jtc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = opt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg, optax.global_norm(g))

    cfg = tiny_mistral()
    tc = pt.TrainConfig(mode="unified", remat=False, **OPT)
    base = params_from_jax(np_params, cfg, device="cpu")
    run_step, state, frozen, port_scale = make_lora_train_state(cfg, tc, base, r=4, alpha=8,
                                                                seed=0, device="cpu")
    assert port_scale == scale
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora), device="cpu")
    with torch.no_grad():  # the JAX package's adapters in the port's state
        for name, node in state.params["layers"].items():
            for w, ab in node.items():
                for x in ("A", "B"):
                    ab[x].copy_(start["layers"][name][w][x])
    # the loss function alone, from the same adapters
    want_loss, _ = loss_fn(jlora, jbatch)
    got_loss, _ = lora_train_step_fns(frozen, cfg, tc, scale)(
        start, pt.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=LOSS_RTOL)
    cur, opt_state = jlora, opt.init(jlora)
    for step in (1, 2, 3):
        cur, opt_state, (loss, le, lg, gn) = jstep(cur, opt_state)
        state, m = run_step(state, batch)
        _assert_metrics(m, pt.StepMetrics(loss, le, lg, gn), step)
    _assert_tree_close(params_to_numpy(state.params),
                       jax.tree_util.tree_map(np.asarray, cur), PARAM_ATOL)
    assert not any(t.requires_grad for t in pt.leaves(frozen))
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


def test_remat_matches_no_remat(setup):
    """One checkpoint per layer recomputes the same activations: losses,
    grad norm and updated params equal to the run without it."""
    _, _, np_params, batch = setup
    cfg = tiny_mistral()
    runs = []
    for remat in (False, True):
        tc = pt.TrainConfig(mode="unified", remat=remat, gc_chunks=2, **OPT)
        state = pt.init_train_state(params_from_jax(np_params, cfg, device="cpu"), tc)
        for _ in range(3):
            state, m = pt.train_step(state, batch, cfg, tc)
        runs.append((m, params_to_numpy(state.params)))
    (m0, p0), (m1, p1) = runs
    for name in ("loss", "loss_emb", "loss_gen", "grad_norm"):
        np.testing.assert_allclose(float(getattr(m1, name)), float(getattr(m0, name)),
                                   rtol=1e-6)
    _assert_tree_close(p1, p0, 1e-6)


def test_schedule_matches_optax():
    """The LambdaLR factor gives optax's join of the two linear schedules at
    every count, the first update at LR 0."""
    for total, ratio in ((10, 0.1), (1000, 0.03), (5, 0.0), (3, 0.5)):
        jtc = jt.TrainConfig(total_steps=total, warmup_ratio=ratio, learning_rate=3e-4)
        tc = pt.TrainConfig(total_steps=total, warmup_ratio=ratio, learning_rate=3e-4)
        warmup = max(int(total * ratio), 1)
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, 3e-4, warmup),
             optax.linear_schedule(3e-4, 0.0, max(total - warmup, 1))], [warmup])
        factor = pt.lr_factor(tc)
        for c in range(total + 2):
            np.testing.assert_allclose(3e-4 * factor(c), float(sched(c)), rtol=1e-5, atol=1e-12)
        assert factor(0) == 0.0 and jtc.total_steps == tc.total_steps


def test_not_ported_steps_raise():
    """The mesh, pipeline and sequence-parallel steps (and their trunks'
    router aux) still raise, naming item 12; a MoE config, which raised
    before MoE training was ported, takes a step (tests/test_torch_moe_train.py
    holds it against the JAX package)."""
    for fn in (pt.make_sharded_train_step, pt.make_pipeline_train_step,
               pt.make_seqpar_train_step, pt._router_aux_from_stats):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn(None, None, None)
    from gritlm_tpu_torch.config import tiny_mixtral
    from gritlm_tpu_torch.models.transformer import init_params

    cfg = tiny_mixtral()
    tc = pt.TrainConfig(remat=False, **OPT)
    state = pt.init_train_state(init_params(cfg, 0, device="cpu"), tc)
    state, m = pt.train_step(state, _batch(), cfg, tc)
    assert state.step == 1 and np.isfinite(float(m.loss)) and float(m.loss_gen) > 0
    assert float(m.moe_dropped_frac) == 0.0  # dense routing drops nothing
