"""The port's MoE GRIT training against the JAX package on tiny_mixtral
(float32, 4 experts, top-2), with the JAX params carried over by
`params_from_jax`: the load-balancing loss, forward's router aux under
every impl (and under remat), three train steps (unified, GradCache,
generative-only, a router_aux_coef override), the LoRA and QLoRA steps; and
tests/test_moe.py's training cases on the port alone.

Tolerances, all float32, as tests/test_torch_train.py holds the Mistral
steps: losses rtol 1e-5, grad norms rtol 1e-4, parameters after three AdamW
steps atol 5e-5; the load-balancing loss and its gradient rtol 1e-6 (sums of
at most 24 fp32 terms in another order); router logits through the trunk
atol 1e-6 (layer 1's input carries layer 0's float32 rounding, logits of
order 0.1); hidden states atol 1e-4 (tests/test_torch_moe.py's bound). The
dropped fractions are counts of routes over the routes, equal to the bit.

The parameters after three steps: every entry within 5e-5, but for the
entries whose (clipped) gradient fell below UNRESOLVED (1e-6) at some step.
The two packages' gradients differ by up to about 1e-7 after the clip
(float32 sums in another order: 2.5e-6 in wo before a clip by 1/41), so
such an entry's gradient is known to a tenth or worse, and Adam (its
m / (sqrt(v) + eps) is about the gradient's sign) turns that into an update
up to a tenth of the learning rate apart: a wo entry with gradients of
2e-10 ended 2.0e-4 apart, an expert `up` entry with 3e-9 1.2e-4 apart (the
Mistral steps of tests/test_torch_train.py happen to have no such entry;
the expert stacks, whose experts see few tokens, have a few percent). Those
entries, at most UNRESOLVED_MAX of a leaf, are held to the learning rate
summed over the steps, which bounds Adam's step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gritlm_tpu.config import tiny_mixtral as jax_tiny_mixtral
from gritlm_tpu.models import forward as jax_forward
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import transformer as jtr
from gritlm_tpu.training import quant as jq
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu_torch.config import tiny_mixtral
from gritlm_tpu_torch.models import transformer as ptr
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax, params_to_numpy
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import quant as pq
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import (
    apply_lora_lazy,
    init_lora,
    lora_train_step_fns,
    make_lora_train_state,
)

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 5e-5
AUX_RTOL = 1e-6
ROUTER_ATOL = 1e-6
ATOL = 1e-4
UNRESOLVED = 1e-6
UNRESOLVED_MAX = 0.1
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


def _gen_batch(n=4, glen=64):
    coll = GritCollator(ByteTokenizer(), query_max_len=32, passage_max_len=32,
                        generative_max_len=glen)
    return coll([(None, None, [f"q {i}?", f"answer {i}"]) for i in range(n)])


@pytest.fixture(scope="module")
def setup():
    jparams = jax_init_params(jax_tiny_mixtral(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, np_params


def _cfgs(**kw):
    return (dataclasses.replace(jax_tiny_mixtral(), **kw),
            dataclasses.replace(tiny_mixtral(), **kw))


def _ids(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 8:] = 0  # right padding
    return ids, mask


def _assert_tree_close(got: dict, want: dict, atol: float, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                       err_msg=f"{path}/{k}")


def _assert_params_close(state, want: dict, unresolved: dict, lr_sum: float):
    """The trained leaves against the JAX tree at PARAM_ATOL, but for the
    entries marked in `unresolved` (by leaf id), held to `lr_sum`."""

    def walk(node, ref, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, ref[k], f"{path}/{k}")
                continue
            got, exp = v.detach().numpy(), np.asarray(ref[k])
            low = unresolved[id(v)].numpy()
            assert low.mean() <= UNRESOLVED_MAX, (path, k, int(low.sum()))
            np.testing.assert_allclose(got[~low], exp[~low], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{path}/{k}")
            assert np.abs(got[low] - exp[low]).max(initial=0.0) <= lr_sum, (path, k)

    walk(state.params, want, "")


def _mark_unresolved(state, unresolved: dict) -> None:
    """Mark the entries whose gradient this step is nonzero and below
    UNRESOLVED (the step's clipped gradients left in .grad; an exact zero,
    as an embedding row no token reads, is exact in both packages)."""
    for t in pt.leaves(state.params):
        g = t.grad.abs()
        low = (g > 0) & (g < UNRESOLVED)
        unresolved[id(t)] = low | unresolved[id(t)] if id(t) in unresolved else low


def _assert_metrics(m_port, m_jax, step, drop=True):
    for name in ("loss", "loss_emb", "loss_gen"):
        np.testing.assert_allclose(float(getattr(m_port, name)), float(getattr(m_jax, name)),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=f"step {step} {name}")
    np.testing.assert_allclose(float(m_port.grad_norm), float(m_jax.grad_norm),
                               rtol=NORM_RTOL, err_msg=f"step {step} grad_norm")
    if drop:
        np.testing.assert_allclose(float(m_port.moe_dropped_frac),
                                   float(m_jax.moe_dropped_frac), rtol=1e-6, atol=0,
                                   err_msg=f"step {step} moe_dropped_frac")


# ---------------------------------------------------------------------------
# the load-balancing loss


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padding mask"])
def test_load_balancing_loss_matches_jax(masked):
    """The loss and its gradient with respect to the router logits."""
    cfg = tiny_mixtral()
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 12, 4)).astype(np.float32)
    mask = np.ones((3, 4), np.int32)
    mask[1, 2:] = 0
    mask[2, 1:] = 0
    jmask = jnp.asarray(mask) if masked else None
    want, wgrad = jax.value_and_grad(
        lambda x: jtr.load_balancing_loss(x, jax_tiny_mixtral(), jmask))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ptr.load_balancing_loss(x, cfg, torch.from_numpy(mask) if masked else None)
    (grad,) = torch.autograd.grad(got, x)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=AUX_RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(wgrad), rtol=AUX_RTOL, atol=1e-8)


def test_aux_loss_allones_mask_matches_unmasked():
    """tests/test_moe.py's case: the padded branch with an all-ones mask
    equals the unpadded branch (no extra E/k factor)."""
    cfg = tiny_mixtral()
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 12, 4)).astype(
        np.float32))
    a = float(ptr.load_balancing_loss(logits, cfg))
    b = float(ptr.load_balancing_loss(logits, cfg, torch.ones((3, 4), dtype=torch.int32)))
    np.testing.assert_allclose(a, b, rtol=1e-6)


# ---------------------------------------------------------------------------
# forward's aux


FWD_IMPLS = {"dense": {}, "dropless": dict(moe_impl="dropless"),
             "gshard": dict(moe_impl="gshard", capacity_factor=0.5)}


@pytest.mark.parametrize("remat", [False, True], ids=["no remat", "remat"])
@pytest.mark.parametrize("impl", list(FWD_IMPLS))
def test_forward_router_aux_matches_jax(setup, impl, remat):
    """forward(output_router_logits=True): the hidden states, the [L, T, E]
    router logits and the mean dropped fraction against the JAX package's
    (gshard at capacity 0.5 drops routes); under remat the logits leave the
    checkpointed layers and the aux loss's gradient flows back through the
    recompute, equal to the gradient without remat."""
    jparams, np_params = setup
    jcfg, cfg = _cfgs(**FWD_IMPLS[impl])
    ids, mask = _ids()
    want_h, _, want = jax_forward(jparams, jcfg, jnp.asarray(ids),
                                  attention_mask=jnp.asarray(mask), causal=True,
                                  remat=remat, output_router_logits=True)
    params = params_from_jax(np_params, cfg, device="cpu")
    leaves = pt.leaves({k: v for k, v in params.items() if k != "lm_head"})  # the trunk's
    for t in leaves:
        t.requires_grad_(True)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    grads = []
    for r in (remat, False):
        h, _, aux = ptr.forward(params, cfg, tids, attention_mask=tmask, causal=True,
                                remat=r, output_router_logits=True)
        assert tuple(aux["router_logits"].shape) == (2, 24, 4)
        loss = ptr.load_balancing_loss(aux["router_logits"], cfg, tmask) + h.pow(2).mean()
        grads.append(torch.autograd.grad(loss, leaves))
        if r == remat:
            np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(aux["router_logits"].detach().numpy(),
                                       np.asarray(want["router_logits"]), atol=ROUTER_ATOL,
                                       rtol=0)
            assert float(aux["moe_dropped_frac"]) == float(want["moe_dropped_frac"])
            assert (float(aux["moe_dropped_frac"]) > 0) == (impl == "gshard")
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    router_grad = grads[0][[i for i, t in enumerate(leaves)
                            if t is params["layers"]["moe"]["router"]][0]]
    assert float(router_grad.abs().max()) > 0


def test_forward_aux_only_when_asked(setup):
    """No aux unless asked, and none from a dense trunk (whose callers
    never ask: training asks only for a MoE config)."""
    _, np_params = setup
    cfg = tiny_mixtral()
    ids, _ = _ids()
    _, _, aux = ptr.forward(params_from_jax(np_params, cfg, device="cpu"), cfg,
                            torch.from_numpy(ids))
    assert aux == {}
    from gritlm_tpu_torch.config import tiny_mistral

    dcfg = tiny_mistral()
    _, _, aux = ptr.forward(ptr.init_params(dcfg, 0, device="cpu"), dcfg,
                            torch.from_numpy(ids), output_router_logits=True)
    assert aux == {}


class _CountOps(TorchDispatchMode):
    """Counts the calls of the named aten ops dispatched while it is active."""

    def __init__(self, *names):
        super().__init__()
        self.n = dict.fromkeys(names, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_grouped(np_params, remat, policy):
    cfg = dataclasses.replace(tiny_mixtral(), moe_impl="dropless")
    params = params_from_jax(np_params, cfg, device="cpu")
    for t in pt.leaves(params):
        t.requires_grad_(True)
    ids, mask = _ids()
    h, _, _ = ptr.forward(params, cfg, torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask), causal=True, remat=remat,
                          remat_policy=policy)
    loss = ptr.logits_from_hidden(params, cfg, h).logsumexp(-1).mean()
    count = _CountOps("_grouped_mm")
    with count:
        loss.backward()
    return count.n["_grouped_mm"]


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_recomputes_the_grouped_products(setup, policy):
    """jax.checkpoint_policies.dots_saveable (and the no-batch one) keep
    dot_general's outputs, and ragged_dot is a primitive of its own
    (ragged_dot_general), so the JAX package recomputes the dropless
    products under every policy. The port mirrors it: under "dots" the
    backward runs the three grouped products of every layer once more than
    without remat."""
    _, np_params = setup
    extra = _backward_grouped(np_params, True, policy) - _backward_grouped(np_params, False,
                                                                           None)
    assert extra == 3 * tiny_mixtral().num_hidden_layers
    jaxpr = jax.make_jaxpr(lambda x, w: jax.lax.ragged_dot(x, w, jnp.array([3, 5])))(
        jnp.ones((8, 4)), jnp.ones((2, 4, 3)))
    (eqn,) = jaxpr.eqns
    assert eqn.primitive.name == "ragged_dot_general"
    assert not jax.checkpoint_policies.dots_saveable(eqn.primitive)
    assert not jax.checkpoint_policies.dots_with_no_batch_dims_saveable(eqn.primitive)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policies_on_the_dense_moe_products(setup, policy):
    """A deliberate difference. The dense impl's expert products
    (td,edf->etf for gate and up; etf,efd->etd; the te,etd->td combine) all
    dispatch as `bmm` in the port. "dots" keeps every bmm, so the recompute
    runs no product, as under the JAX package's dots_saveable. The JAX
    package's dots_with_no_batch_dims_saveable also keeps the gate and up
    products (they have no batch dimension) and recomputes only the down
    product; the port's "dots_no_batch" keeps no bmm, so its recompute
    reruns the gate, up and down products (3 a layer; the combine's output
    is not needed by the backward). The values are the same: the recompute
    is exact."""
    _, np_params = setup
    cfg = tiny_mixtral()
    ids, mask = _ids()

    def run(remat, pol):
        params = params_from_jax(np_params, cfg, device="cpu")
        for t in pt.leaves(params):
            t.requires_grad_(True)
        fwd = _CountOps("mm", "bmm")
        with fwd:
            h, _, _ = ptr.forward(params, cfg, torch.from_numpy(ids),
                                  attention_mask=torch.from_numpy(mask), causal=True,
                                  remat=remat, remat_policy=pol)
        loss = ptr.logits_from_hidden(params, cfg, h).logsumexp(-1).mean()
        bwd = _CountOps("mm", "bmm")
        with bwd:
            loss.backward()
        return fwd.n, bwd.n

    fwd, plain = run(False, None)
    _, kept = run(True, policy)
    extra = {k: kept[k] - plain[k] for k in kept}
    L = cfg.num_hidden_layers
    assert fwd["bmm"] == 4 * L  # gate, up, down, combine
    assert extra == {"mm": 0, "bmm": 0 if policy == "dots" else 3 * L}


# ---------------------------------------------------------------------------
# tests/test_moe.py's training cases on the port


def test_gshard_grads_flow(setup):
    _, np_params = setup
    cfg = dataclasses.replace(tiny_mixtral(), moe_impl="gshard")
    params = params_from_jax(np_params, cfg, device="cpu")
    moe = params["layers"]["moe"]
    for t in moe.values():
        t.requires_grad_(True)
    ids = torch.from_numpy(_ids(S=8)[0][:1])
    h, _, _ = ptr.forward(params, cfg, ids, causal=True)
    grads = torch.autograd.grad(h.float().pow(2).sum(), list(moe.values()))
    for name, g in zip(moe, grads):
        assert float(g.abs().max()) > 0, name


def test_gshard_dropped_frac_reported(setup):
    """At a starved capacity factor the drop fraction is nonzero and the
    output departs from dense."""
    _, np_params = setup
    cfg = tiny_mixtral()
    tp = {k: v[0] for k, v in params_from_jax(np_params, cfg, device="cpu")[
        "layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 16, 64)).astype(np.float32))
    out_d, _, _ = ptr._moe_mlp_dense(tp, x, cfg)
    out_g, _, drop = ptr._moe_mlp_gshard(tp, x, dataclasses.replace(cfg, moe_impl="gshard",
                                                                    capacity_factor=0.25))
    assert 0.0 < float(drop) <= 1.0
    assert not torch.allclose(out_g, out_d, atol=1e-5)


def test_train_step_reports_moe_drop(setup):
    """The drop rate reaches the step's metrics: starved capacity > 0,
    capacity 2.0 (E/k) exactly 0."""
    _, np_params = setup
    batch = _gen_batch()
    tc = pt.TrainConfig(mode="generative", total_steps=2, remat=False)
    for cf, expect_drop in ((0.25, True), (2.0, False)):
        cfg = dataclasses.replace(tiny_mixtral(), moe_impl="gshard", capacity_factor=cf)
        state = pt.init_train_state(params_from_jax(np_params, cfg, device="cpu"), tc)
        _, m = pt.train_step(state, batch, cfg, tc)
        d = float(m.moe_dropped_frac)
        assert (d > 0.0) == expect_drop, (cf, d)
        assert np.isfinite(float(m.loss))


def test_dropless_forward_and_grad():
    """The trunk through the dropless path equals the dense one, and a loss
    over the LM head backpropagates through the grouped products into the
    expert stacks."""
    jparams = jax_init_params(jax_tiny_mixtral(), jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = dataclasses.replace(tiny_mixtral(), moe_impl="dropless")
    params = params_from_jax(np_params, cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 12)))
    h_dl, _, _ = ptr.forward(params, cfg, ids, causal=True)
    h_dn, _, _ = ptr.forward(params, dataclasses.replace(cfg, moe_impl="dense"), ids,
                             causal=True)
    torch.testing.assert_close(h_dl, h_dn, atol=2e-5, rtol=1e-4)
    leaves = pt.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    lg, _, _ = ptr.forward_lm(params, cfg, ids, causal=True)
    grads = torch.autograd.grad(lg.float().pow(2).mean(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    gate = grads[[i for i, t in enumerate(leaves) if t is params["layers"]["moe"]["gate"]][0]]
    assert float(gate.abs().max()) > 0


# ---------------------------------------------------------------------------
# train_step against the JAX package


VARIANTS = {
    "unified": (dict(), {}, False),
    "gradcache gshard": (dict(gc_chunks=2), dict(moe_impl="gshard", capacity_factor=1.0),
                         False),
    "generative dropless": (dict(mode="generative"), dict(moe_impl="dropless"), False),
    "router_aux_coef": (dict(router_aux_coef=0.5), {}, False),
    "gradcache remat": (dict(gc_chunks=2, remat=True), {}, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(setup, variant):
    """Three steps in both packages from the same params and batch:
    losses (the aux term in loss_gen), moe_dropped_frac, grad norms, and
    the params after step 3 (_assert_params_close)."""
    jparams, np_params = setup
    kw, cfg_kw, remat = VARIANTS[variant]
    kw = dict(OPT, **{"remat": remat, "mode": "unified", **kw})
    jcfg, cfg = _cfgs(**cfg_kw)
    jtc = jt.TrainConfig(**kw)
    jstep = jax.jit(jt.train_step, static_argnums=(2, 3))
    jstate = jt.init_train_state(jparams, jtc)
    batch = _batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tc = pt.TrainConfig(**kw)
    state = pt.init_train_state(params_from_jax(np_params, cfg, device="cpu"), tc)
    drops, unresolved = [], {}
    for step in (1, 2, 3):
        jstate, jm = jstep(jstate, jbatch, jcfg, jtc)
        state, m = pt.train_step(state, batch, cfg, tc)
        _assert_metrics(m, jm, step)
        _mark_unresolved(state, unresolved)
        drops.append(float(m.moe_dropped_frac))
    lr_sum = sum(tc.learning_rate * pt.lr_factor(tc)(c) for c in range(3))
    _assert_params_close(state, jax.tree_util.tree_map(np.asarray, jstate.params), unresolved,
                         lr_sum)
    assert (max(drops) > 0) == (cfg.moe_impl == "gshard")


def test_aux_term_is_in_loss_gen(setup):
    """loss_gen with the default coefficient minus loss_gen with coef 0 is
    coef * load_balancing_loss of the generative forward's router logits."""
    _, np_params = setup
    cfg = tiny_mixtral()
    params = params_from_jax(np_params, cfg, device="cpu")
    gen = pt.batch_to_device(_batch()["generative"], "cpu")
    losses = {}
    for coef in (None, 0.0):
        tc = pt.TrainConfig(router_aux_coef=coef, remat=False)
        with torch.no_grad():
            losses[coef], _ = pt.generative_loss(params, cfg, tc, gen)
    with torch.no_grad():
        _, _, aux = ptr.forward(params, cfg, gen["input_ids"],
                                attention_mask=gen["attention_mask"], causal=True,
                                output_router_logits=True)
        aux_loss = ptr.load_balancing_loss(aux["router_logits"], cfg, gen["attention_mask"])
    np.testing.assert_allclose(float(losses[None] - losses[0.0]),
                               cfg.router_aux_loss_coef * float(aux_loss), rtol=1e-5)
    assert float(aux_loss) > 0


# ---------------------------------------------------------------------------
# LoRA and QLoRA


def test_lora_targets_match_jax(setup):
    """init_lora targets what the JAX package's does on a MoE tree: the
    attention projections; the 4-D expert stacks and the router stay out."""
    jparams, np_params = setup
    jlora, _ = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    lora, _ = init_lora(params_from_jax(np_params, tiny_mixtral(), device="cpu"), 0, r=4,
                        alpha=8)

    def shapes(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from shapes(v, path + (k,))
            else:
                yield path + (k,), tuple(v.shape)

    assert dict(shapes(lora)) == dict(shapes(jlora))
    assert set(lora["layers"]) == {"attn"}
    assert set(lora["layers"]["attn"]) == {"wq", "wk", "wv", "wo"}


def test_lora_train_step_matches_jax(setup):
    """make_lora_train_state's step on tiny_mixtral against the JAX
    package's LoRA loss (the aux term included) under its optax chain, from
    the same adapters. The JAX LoRA step reports no drop (StepMetrics'
    default 0); the port's LoRA step runs through train_step and reports the
    drop (0 here: dense routing)."""
    jparams, np_params = setup
    jcfg, cfg = _cfgs()
    jtc = jt.TrainConfig(mode="unified", remat=False, **OPT)
    jlora, scale = jax_init_lora(jparams, jax.random.PRNGKey(3), r=4, alpha=8)
    loss_fn = jax_lora_fns(jparams, jcfg, jtc, scale)
    opt = jt.make_optimizer(jtc)
    batch = _batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = opt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg, optax.global_norm(g))

    tc = pt.TrainConfig(mode="unified", remat=False, **OPT)
    run_step, state, frozen, port_scale = make_lora_train_state(
        cfg, tc, params_from_jax(np_params, cfg, device="cpu"), r=4, alpha=8, seed=0,
        device="cpu")
    assert port_scale == scale
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora), device="cpu")
    with torch.no_grad():
        for w, ab in state.params["layers"]["attn"].items():
            for x in ("A", "B"):
                ab[x].copy_(start["layers"]["attn"][w][x])
    want_loss, _ = loss_fn(jlora, jbatch)
    got_loss, _ = lora_train_step_fns(frozen, cfg, tc, scale)(
        start, pt.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=LOSS_RTOL)
    cur, opt_state = jlora, opt.init(jlora)
    for step in (1, 2, 3):
        cur, opt_state, (loss, le, lg, gn) = jstep(cur, opt_state)
        state, m = run_step(state, batch)
        _assert_metrics(m, jt.StepMetrics(loss, le, lg, gn), step, drop=False)
        assert float(m.moe_dropped_frac) == 0.0
    _assert_tree_close(params_to_numpy(state.params),
                       jax.tree_util.tree_map(np.asarray, cur), PARAM_ATOL)
    assert float(state.params["layers"]["attn"]["wq"]["B"].detach().abs().max()) > 0


def test_qlora_train_step_matches_jax(setup):
    """QLoRA on tiny_mixtral: the int8 base (the expert stacks quantized
    too, bytes equal to the JAX package's), float32 adapters so that no
    bf16 rounding of the update intervenes, three steps of the port's
    train_step against the JAX package's QLoRA loss under its optax chain,
    losses within 1e-5."""
    jparams, np_params = setup
    jcfg, cfg = _cfgs()
    jtc = jt.TrainConfig(mode="unified", remat=False, **OPT)
    jbase = jq.quantize_tree(jparams)
    jlora, scale = jax_init_lora(jbase, jax.random.PRNGKey(3), r=4, alpha=8)
    jlora = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jlora)
    loss_fn = jax_lora_fns(jbase, jcfg, jtc, scale)
    jopt = jt.make_optimizer(jtc)
    batch = _batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = jopt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg)

    tc = pt.TrainConfig(mode="unified", remat=False, **OPT)
    base = pq.quantize_tree(params_from_jax(np_params, cfg, device="cpu"))
    gate = base["layers"]["moe"]["gate"]
    assert gate["q8"].dtype == torch.int8 and gate["q8"].dim() == 4
    np.testing.assert_array_equal(gate["q8"].numpy(),
                                  np.asarray(jbase["layers"]["moe"]["gate"]["q8"]))
    state = pt.init_train_state(lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora),
                                              device="cpu"), tc)
    cur, opt_state = jlora, jopt.init(jlora)
    for step in (1, 2, 3):
        cur, opt_state, want = jstep(cur, opt_state)
        state, m = pt.train_step(state, batch, cfg, tc,
                                 params_fn=lambda tree: apply_lora_lazy(base, tree, scale))
        for name, w in zip(("loss", "loss_emb", "loss_gen"), want):
            np.testing.assert_allclose(float(getattr(m, name)), float(w), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {step} {name}")
