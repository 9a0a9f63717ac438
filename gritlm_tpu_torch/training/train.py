"""GRIT joint training on one device: the unified contrastive + next-token
step with GradCache (port of gritlm_tpu.training.train).

  - Full-batch path: loss = next_token(gen) + contrastive(q, p); one
    backward.
  - GradCache path (gc_chunks > 1): (1) chunked encode under no_grad,
    (2) the contrastive loss's gradient with respect to the reps only,
    (3) each chunk replayed with grad, backpropagating the surrogate
    sum(reps * rep_grad) into `.grad`. The trunk has no dropout, so the
    replay is exact.

The generative loss runs first, as in the JAX package (reference
gradcache_trainer.py:549-551). A Mixtral (MoE) config adds the
load-balancing aux loss, `router_aux_coef` (default the config's
`router_aux_loss_coef`) times models/transformer.load_balancing_loss of the
generative forward's router logits, to the generative loss, and reports the
fraction of routes a gshard capacity dropped (`StepMetrics.moe_dropped_frac`,
averaged over the step's forwards as the JAX package averages it).

The optimizer is the JAX package's optax chain: clip to `max_grad_norm`
by the global norm, then AdamW(0.9, 0.999, eps 1e-8, weight_decay) under a
schedule that rises linearly from 0 to `learning_rate` over the warmup and
falls linearly to 0; the first update has LR 0 (optax counts from 0). Here that is `torch.optim.AdamW` with a
`LambdaLR`, and the clip is done by hand so that it matches
`optax.clip_by_global_norm`; its moments are kept in the parameters' dtype,
like optax's.

A train step updates the state in place (parameters, optimizer, scheduler,
step) and returns it with the step's metrics. The trained tree is either
the model's params or, for LoRA, the adapter tree (`params_fn` then maps it
to the model's params, training/lora.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models.transformer import (
    forward,
    forward_lm,
    lm_head_kernel,
    load_balancing_loss,
)
from gritlm_tpu_torch.ops.pooling import mask_instruction, pool
from gritlm_tpu_torch.training.losses import (
    contrastive_loss,
    fused_next_token_loss,
    next_token_loss,
)

NOT_PORTED_MESH = ("is not ported: the mesh, pipeline and sequence-parallel steps wait for "
                   "the parallel slice (ROADMAP Queue 1 item 12); the port trains on one device")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    mode: str = "unified"  # unified | embedding | generative
    pooling_method: str = "mean"
    normalized: bool = True
    attn: str = "bbcc"
    temperature: float = 0.02
    loss_gen_type: str = "mixed"
    loss_gen_factor: float = 1.0
    # GradCache: number of chunks the emb batch is split into (1 = off)
    gc_chunks: int = 1
    # stop-gradient variants (reference emb_q_only / emb_p_only flags)
    q_grad: bool = True
    p_grad: bool = True
    # optimizer
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    remat: bool = True
    # what a checkpointed layer keeps: None / "full" (nothing), "dots",
    # "dots_no_batch" (models/transformer.remat_context)
    remat_policy: Optional[str] = None
    # fuse the LM head into the next-token loss (vocab-chunked online
    # logsumexp): a memory feature for big-vocab logits, same semantics
    fused_ce: bool = False
    router_aux_coef: Optional[float] = None  # None -> cfg.router_aux_loss_coef

    @property
    def embed_causal(self) -> bool:
        return self.attn[:2] != "bb"


@dataclasses.dataclass
class TrainState:
    """step: updates done so far; params: the trained tree (leaves require
    grad); optimizer and scheduler hold the Adam moments and the LR count."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_emb: torch.Tensor
    loss_gen: torch.Tensor
    grad_norm: torch.Tensor
    # the fraction of MoE routes a gshard capacity dropped this step (0 for
    # dense models and exact routing); run.py logs it for a MoE config
    moe_dropped_frac: Union[torch.Tensor, float] = 0.0


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, depth first in insertion order (the
    order the optimizer holds them in)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def batch_to_device(batch: dict, device) -> dict:
    """A collator batch (nested dicts of numpy arrays or tensors) on device."""
    return {k: batch_to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Encode / loss pieces


def encode_reps(params, cfg: ModelConfig, tc: TrainConfig, feat: Dict[str, torch.Tensor],
                return_drop: bool = False):
    """features -> pooled (optionally normalized) fp32 reps [B, D] (or
    [B, P] with a projection head); instruction tokens are attended but not
    pooled (reference gritlm/training/model.py:134-165). Pools with
    ops/pooling.pool, not the fused K2 epilogue, as the JAX package's
    training does. A head in `params` ({kernel [D, P], bias [P]}) applies to
    the pooled rep, cast to the rep's dtype, before the normalize (reference
    gritlm/training/model.py:147-148); inference projects every token before
    pooling instead (gritlm._encode_step), and the port keeps both as the
    JAX package has them. With `return_drop`, returns (reps, the MoE
    dropped fraction of this forward; 0 for a dense model)."""
    hidden, _, aux = forward(params, cfg, feat["input_ids"],
                             attention_mask=feat["attention_mask"], causal=tc.embed_causal,
                             remat=tc.remat, remat_policy=tc.remat_policy,
                             output_router_logits=cfg.is_moe and return_drop)
    pmask = feat["attention_mask"]
    if "instruction_lens" in feat:
        pmask = mask_instruction(pmask, feat["instruction_lens"])
    reps = pool(hidden, pmask, tc.pooling_method)
    if "projection" in params:
        pr = params["projection"]
        reps = reps @ pr["kernel"].to(reps.dtype) + pr["bias"].to(reps.dtype)
    if tc.normalized:
        reps = reps / reps.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if return_drop:
        return reps, aux.get("moe_dropped_frac", _zero(reps.device))
    return reps


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def generative_loss(params, cfg: ModelConfig, tc: TrainConfig,
                    gen: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the next-token loss of a generative sub-batch, the MoE dropped
    fraction of its forward). For a MoE config the loss includes
    coef * load_balancing_loss over the forward's router logits under the
    sub-batch's attention mask (the aux loss is on the generative side only,
    as in the JAX package); a dense model's fraction is 0."""
    kw = dict(attention_mask=gen["attention_mask"], causal=True, remat=tc.remat,
              remat_policy=tc.remat_policy, output_router_logits=cfg.is_moe)
    if tc.fused_ce:
        hidden, _, aux = forward(params, cfg, gen["input_ids"], **kw)
        loss = fused_next_token_loss(hidden, lm_head_kernel(params, cfg, hidden.dtype),
                                     gen["labels"], tc.loss_gen_type, tc.loss_gen_factor)
    else:
        logits, _, aux = forward_lm(params, cfg, gen["input_ids"], **kw)
        loss = next_token_loss(logits, gen["labels"], tc.loss_gen_type, tc.loss_gen_factor)
    if cfg.is_moe:
        coef = tc.router_aux_coef if tc.router_aux_coef is not None else cfg.router_aux_loss_coef
        loss = loss + coef * load_balancing_loss(aux["router_logits"], cfg,
                                                 gen["attention_mask"])
    return loss, aux.get("moe_dropped_frac", _zero(loss.device))


def _router_aux_from_stats(*args, **kwargs):
    raise NotImplementedError("_router_aux_from_stats (the pipeline and sequence-parallel "
                              "trunks' aux loss) " + NOT_PORTED_MESH)


# ---------------------------------------------------------------------------
# GradCache


def _chunks(feat: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    size = next(iter(feat.values())).shape[0]
    if size % n:
        raise ValueError(f"gc_chunks={n} does not divide the batch of {size}")
    b = size // n
    return [{k: v[i * b:(i + 1) * b] for k, v in feat.items()} for i in range(n)]


def gradcache_emb_grads(
    params_fn: Callable[[], dict], cfg: ModelConfig, tc: TrainConfig,
    query: Dict[str, torch.Tensor], passage: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contrastive loss over the whole query/passage batch with chunked
    activations: accumulates its parameter gradients into `.grad` of the
    trained leaves and returns (the loss, detached; the MoE dropped fraction
    averaged over every query and passage chunk of the first stage, 0 for a
    dense model). `params_fn()` gives the model's params; it is called per
    replayed chunk, so each chunk's graph is its own (a LoRA tree is
    resolved anew per chunk)."""
    n = tc.gc_chunks
    q_chunks, p_chunks = _chunks(query, n), _chunks(passage, n)

    # stage 1: no-grad chunked encode, tracking the MoE drops (the replay's
    # forwards repeat the same routes)
    with torch.no_grad():
        params = params_fn()
        q_out = [encode_reps(params, cfg, tc, c, return_drop=True) for c in q_chunks]
        p_out = [encode_reps(params, cfg, tc, c, return_drop=True) for c in p_chunks]
        del params
        q_reps = torch.cat([r for r, _ in q_out])
        p_reps = torch.cat([r for r, _ in p_out])
        dropped = torch.stack([d for _, d in q_out + p_out]).mean()

    # stage 2: loss and its gradient with respect to the reps only
    q_reps.requires_grad_(True)
    p_reps.requires_grad_(True)
    with torch.enable_grad():
        loss_emb = contrastive_loss(q_reps, p_reps, tc.temperature)
        dq, dp = torch.autograd.grad(loss_emb, (q_reps, p_reps))

    # stage 3: replay each chunk, backpropagating the surrogate
    # sum(reps * rep_grad); a stopped side contributes exactly zero, so its
    # replay is skipped
    for chunks, grads, on in ((q_chunks, dq, tc.q_grad), (p_chunks, dp, tc.p_grad)):
        if not on:
            continue
        for feat, drep in zip(chunks, grads.chunk(n)):
            reps = encode_reps(params_fn(), cfg, tc, feat)
            (reps * drep).sum().backward()
    return loss_emb.detach(), dropped


# ---------------------------------------------------------------------------
# Optimizer and train step


def lr_factor(tc: TrainConfig) -> Callable[[int], float]:
    """The optax schedule as a factor of learning_rate at update count c
    (c = 0 for the first update): c / warmup up to the warmup, then a linear
    fall to 0 at total_steps."""
    warmup = max(int(tc.total_steps * tc.warmup_ratio), 1)
    decay = max(tc.total_steps - warmup, 1)

    def factor(c: int) -> float:
        if c < warmup:
            return c / warmup
        return 1.0 - min(c - warmup, decay) / decay

    return factor


def make_optimizer(tc: TrainConfig, params: List[torch.Tensor]):
    """(AdamW, LambdaLR) over `params`: the JAX package's optax chain minus
    the clip, which train_step applies by the global norm first."""
    opt = torch.optim.AdamW(params, lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tc.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(tc))


def trainable(tree: dict) -> dict:
    """The tree with every leaf a leaf tensor that requires grad (tensors
    made under inference mode are copied: they cannot take part in
    autograd)."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    t = tree.clone() if tree.is_inference() else tree.detach()
    return t.requires_grad_(True)


def init_train_state(params: dict, tc: TrainConfig) -> TrainState:
    """The trained tree's leaves require grad (the tensors themselves, no
    copy unless made under inference mode); fresh optimizer and schedule."""
    params = trainable(params)
    opt, sched = make_optimizer(tc, leaves(params))
    return TrainState(step=0, params=params, optimizer=opt, scheduler=sched)


def train_step(
    state: TrainState,
    batch: Dict[str, Dict],
    cfg: ModelConfig,
    tc: TrainConfig,
    params_fn: Optional[Callable[[dict], dict]] = None,
):
    """One step over a batch dict with optional 'query'/'passage'/
    'generative' sub-batches (numpy arrays or tensors). `params_fn` maps the
    trained tree to the model's params (identity when None). Returns
    (state, StepMetrics), the state updated in place. The MoE dropped
    fraction is the mean over the step's forwards (the generative one and
    the query and passage encodes, those of GradCache's first stage counted
    as two), as the JAX package averages it."""
    trained = leaves(state.params)
    device = trained[0].device
    batch = batch_to_device(batch, device)

    def model_params() -> dict:
        return state.params if params_fn is None else params_fn(state.params)

    has_emb = "query" in batch and tc.mode in ("unified", "embedding")
    has_gen = "generative" in batch and tc.mode in ("unified", "generative")
    use_gc = has_emb and tc.gc_chunks > 1
    for t in trained:
        t.grad = None

    zero = _zero(device)
    loss_gen, loss_emb, dropped = zero, zero, zero
    n_fwd = 3.0 if has_gen else 2.0  # the mean's forwards when there is an emb side
    params = model_params()
    if has_gen:  # gen first (reference ordering, gradcache_trainer.py:549)
        loss_gen, dropped = generative_loss(params, cfg, tc, batch["generative"])
    if has_emb and not use_gc:
        q, dq = encode_reps(params, cfg, tc, batch["query"], return_drop=True)
        p, dp = encode_reps(params, cfg, tc, batch["passage"], return_drop=True)
        dropped = (dropped * (n_fwd - 2.0) + dq + dp) / n_fwd
        loss_emb = contrastive_loss(q if tc.q_grad else q.detach(),
                                    p if tc.p_grad else p.detach(), tc.temperature)
    loss = loss_gen + loss_emb
    if loss.requires_grad:
        loss.backward()
    del params
    if use_gc:
        loss_emb, gc_drop = gradcache_emb_grads(model_params, cfg, tc, batch["query"],
                                                batch["passage"])
        loss = loss + loss_emb
        dropped = (dropped * (n_fwd - 2.0) + 2.0 * gc_drop) / n_fwd

    # optax updates every leaf: one without a gradient takes a zero one
    grads = []
    for t in trained:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        grads.append(t.grad)
    with torch.no_grad():
        gnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        # optax.clip_by_global_norm: g * max_norm / |g| when |g| >= max_norm
        clip = torch.where(gnorm < tc.max_grad_norm, torch.ones_like(gnorm),
                           tc.max_grad_norm / gnorm)
        torch._foreach_mul_(grads, clip)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, StepMetrics(loss.detach(), loss_emb.detach(), loss_gen.detach(), gnorm,
                              dropped.detach())


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError("make_sharded_train_step " + NOT_PORTED_MESH)


def make_pipeline_train_step(*args, **kwargs):
    raise NotImplementedError("make_pipeline_train_step " + NOT_PORTED_MESH)


def make_seqpar_train_step(*args, **kwargs):
    raise NotImplementedError("make_seqpar_train_step " + NOT_PORTED_MESH)

