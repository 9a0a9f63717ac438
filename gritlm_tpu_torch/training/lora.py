"""LoRA adapters for parameter-efficient GRIT training (port of
gritlm_tpu.training.lora).

A parallel `lora` tree holds {A [L, in, r], B [L, r, out]} per targeted
kernel (reference PEFT path, gritlm/training/run.py:217-284: r 16, alpha 64
on q/k/v/o and the MLP projections). `apply_lora_lazy` turns each adapted
kernel into a lazy leaf {"w", "A", "B": (alpha/r) B} that the trunk
resolves one layer at a time (models/transformer._w), so no full effective
copy of the weights exists and only the LoRA tree gets gradients and
optimizer state. `merge` folds the adapters into the base for export.

QLoRA (`make_lora_train_state(quantize=True)`) quantizes the frozen base to
int8 (training/quant.quantize_tree, per-channel scales). Its adapters are
bf16, and the training forward dequantizes each layer's base in `_w`
(q * scale in fp32, cast to the activations' dtype) before adding A @ B, as
the JAX package does: it never reaches the w8a16 kernel K6, which has no
backward. `merge` dequantizes the base first, so the export is dense.

Per-request adapters in serving (S-LoRA style): `stack_adapters` stacks N
adapter trees onto the base as {"w", "As", "Bs"} leaves (slot 0 the zero
adapter), and `set_adapter_ids` grafts each batch row's adapter id into
them; models/transformer._mm then adds each row's own low-rank delta over
the shared base product (serving.ServingEngine(adapters=...)).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from gritlm_tpu_torch.models.transformer import resolve_device
from gritlm_tpu_torch.training.quant import dequantize_tree, quantize_tree
from gritlm_tpu_torch.training.train import (
    TrainState,
    contrastive_loss,
    encode_reps,
    generative_loss,
    init_train_state,
    train_step,
)

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _target_leaves(params: dict, targets: Sequence[str]):
    """(path, leaf) for the targeted 3-D kernels [L, in, out], depth first;
    an int8 base {"q8", "scale"} (QLoRA) gives its q8 tensor. On a MoE tree
    the 4-D expert stacks [L, E, in, out] are not targeted (nor is the
    router, whose name is no target), as in the JAX package: LoRA adapts
    the attention projections there."""
    out = []

    def walk(node, path):
        if isinstance(node, dict) and "q8" in node:
            if path[-1] in targets and node["q8"].dim() == 3:
                out.append((path, node["q8"]))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif path[-1] in targets and node.dim() == 3:
            out.append((path, node))

    walk(params, ())
    return out


def init_lora(
    params: dict,
    seed: Union[int, torch.Generator] = 0,
    r: int = 16,
    alpha: int = 64,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Tuple[Dict, float]:
    """The LoRA tree: A ~ N(0, 0.02) drawn in fp32 from a seeded generator
    on the base's device, B = 0 (so W_eff starts equal to W), both in the
    base's dtype (bf16 over an int8 base). Returns (tree, scale); scale =
    alpha / r stays out of the tree so the optimizer never touches it."""
    leaves = _target_leaves(params, targets)
    gen = seed
    if not isinstance(gen, torch.Generator):
        device = leaves[0][1].device if leaves else torch.device("cpu")
        gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict = {}
    for path, w in leaves:
        L, din, dout = w.shape
        dt = torch.bfloat16 if w.dtype == torch.int8 else w.dtype  # int8: a quantized base
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = torch.empty((L, din, r), dtype=torch.float32, device=w.device)
        a.normal_(0.0, 1.0, generator=gen)
        node[path[-1]] = {"A": (a * 0.02).to(dt),
                          "B": torch.zeros((L, r, dout), dtype=dt, device=w.device)}
    return tree, float(alpha) / float(r)


def apply_lora_lazy(params: dict, lora: Dict, scale: float) -> dict:
    """params with each adapted kernel a lazy leaf {"w": base, "A": A,
    "B": scale * B (fp32)}, resolved per layer by the trunk; an int8 base
    node is a leaf."""

    def walk(p_node, l_node):
        if not isinstance(p_node, dict) or "q8" in p_node:
            return p_node
        out = {}
        for k, v in p_node.items():
            ln = l_node.get(k) if isinstance(l_node, dict) else None
            if isinstance(ln, dict) and "A" in ln:
                out[k] = {"w": v, "A": ln["A"], "B": ln["B"].float() * scale}
            elif isinstance(v, dict):
                out[k] = walk(v, ln or {})
            else:
                out[k] = v
        return out

    return walk(params, lora)


def apply_lora(params: dict, lora: Dict, scale: float) -> dict:
    """params with W -> W + scale * A @ B on every adapted kernel,
    materialized (the export / merge path; training uses apply_lora_lazy).
    A quantized base is dequantized (to bf16) first."""
    params = dequantize_tree(params)

    def walk(p_node, l_node):
        if not isinstance(p_node, dict):
            return p_node
        out = {}
        for k, v in p_node.items():
            ln = l_node.get(k) if isinstance(l_node, dict) else None
            if isinstance(ln, dict) and "A" in ln and not isinstance(v, dict):
                merged = torch.empty_like(v)
                with torch.no_grad():
                    for i in range(v.shape[0]):  # one layer in fp32 at a time
                        delta = ln["A"][i].float() @ ln["B"][i].float()
                        merged[i] = v[i].float() + scale * delta
                out[k] = merged
            elif isinstance(v, dict):
                out[k] = walk(v, ln or {})
            else:
                out[k] = v
        return out

    return walk(params, lora)


def merge(params: dict, lora: Dict, scale: float) -> dict:
    """Fold adapters into base weights (export path)."""
    return apply_lora(params, lora, scale)


def stack_adapters(params: dict, adapters: Sequence[Dict], scale: float) -> dict:
    """Multi-LoRA serving: stack N adapter trees onto the base params as
    `{"w": base, "As": [L, n+1, in, r], "Bs": [L, n+1, r, out]}` leaves.
    Slot 0 is the ZERO adapter (requests without an adapter get the plain
    base with no branch), slot i+1 is adapters[i]; Bs are pre-scaled by
    alpha/r (`scale`) and kept in the adapters' dtype. A quantized base node
    ({"q8"|"q4", "scale"}) becomes its leaf's "w" unchanged. All adapters
    must share targets and rank (one stacked shape per leaf)."""

    def walk(p_node, l_nodes):
        if not isinstance(p_node, dict) or "q8" in p_node or "q4" in p_node:
            return p_node
        out = {}
        for k, v in p_node.items():
            lns = [ln.get(k) if isinstance(ln, dict) else None for ln in l_nodes]
            adapted = [isinstance(ln, dict) and "A" in ln for ln in lns]
            if any(adapted) and not all(adapted):
                raise ValueError(f"adapters disagree on target {k}: stacked serving needs "
                                 "identical target sets")
            if all(adapted) and lns:
                shapes = {(tuple(ln["A"].shape), tuple(ln["B"].shape)) for ln in lns}
                if len(shapes) != 1:
                    raise ValueError(f"adapter shapes differ at {k}: {shapes} — stacked "
                                     "serving needs one rank per leaf")
                dt = lns[0]["B"].dtype
                with torch.no_grad():
                    As = torch.stack([torch.zeros_like(lns[0]["A"])]
                                     + [ln["A"].detach() for ln in lns], dim=1)
                    Bs = torch.stack([torch.zeros_like(lns[0]["B"])]
                                     + [(ln["B"].detach().float() * scale).to(dt)
                                        for ln in lns], dim=1)
                out[k] = {"w": v, "As": As, "Bs": Bs}  # [L, n+1, ...]: L leads
            elif isinstance(v, dict):
                out[k] = walk(v, [ln or {} for ln in lns])
            else:
                out[k] = v
        return out

    return walk(params, list(adapters))


def set_adapter_ids(params: dict, aid: torch.Tensor, num_layers: int) -> dict:
    """Graft per-row adapter ids `aid` [B] (on the params' device) into
    every stacked-adapter leaf as "aid" [L, B]: an expand view of the one
    tensor, so each layer's slice (the trunk unbinds the layer axis) is
    `aid` itself and nothing is copied. A pure tree restructure; a tree
    without stacked leaves comes back unchanged."""
    aid_l = aid[None, :].expand(num_layers, aid.shape[0])

    def walk(node):
        if not isinstance(node, dict):
            return node
        if "As" in node and "w" in node:
            return {**node, "aid": aid_l}
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def _frozen(params: dict, device=None) -> dict:
    """The tree detached from autograd (and moved to `device` if given)."""
    if isinstance(params, dict):
        return {k: _frozen(v, device) for k, v in params.items()}
    return params.detach() if device is None else params.detach().to(device)


def lora_train_step_fns(base_params: dict, cfg, tc, scale: float):
    """loss_fn(lora, batch) -> (loss, (loss_emb, loss_gen)) with only the
    LoRA tree differentiated; the base is closed over, detached. `batch`
    holds tensors on the base's device."""
    frozen = _frozen(base_params)
    device = frozen["final_ln"]["scale"].device

    def loss_fn(lora, batch):
        params = apply_lora_lazy(frozen, lora, scale)
        loss_gen = torch.zeros((), device=device)
        loss_emb = torch.zeros((), device=device)
        if "generative" in batch and tc.mode in ("unified", "generative"):
            loss_gen, _ = generative_loss(params, cfg, tc, batch["generative"])
        if "query" in batch and tc.mode in ("unified", "embedding"):
            q = encode_reps(params, cfg, tc, batch["query"])
            p = encode_reps(params, cfg, tc, batch["passage"])
            loss_emb = contrastive_loss(q, p, tc.temperature)
        return loss_gen + loss_emb, (loss_emb, loss_gen)

    return loss_fn


def make_lora_train_state(
    cfg, tc, base_params: dict, r: int = 16, alpha: int = 64, quantize: bool = False,
    seed: int = 0, device: Optional[Union[str, torch.device]] = None,
):
    """The LoRA training setup on one device: the frozen base (int8 with
    `quantize`: QLoRA), and a TrainState whose `params` IS the LoRA tree (so
    the checkpoint manager and the run loop work unchanged). Returns
    (run_step, state, base, scale); run_step(state, batch) is train_step
    with the base closed over (GradCache included). A projection head in
    `base_params` is part of the frozen base, as in the JAX package (no
    adapter targets it): encode_reps applies it, it takes no gradient, and
    `merge` carries it into the export unchanged."""
    device = resolve_device(device)
    base = _frozen(base_params, device)
    if quantize:
        base = quantize_tree(base)
    lora, scale = init_lora(base, seed, r=r, alpha=alpha)
    state: TrainState = init_train_state(lora, tc)

    def params_fn(tree):
        return apply_lora_lazy(base, tree, scale)

    def run_step(state, batch):
        return train_step(state, batch, cfg, tc, params_fn=params_fn)

    return run_step, state, base, scale

