"""Carry the JAX package's parameters over to the port.

`params_from_jax` takes the JAX param pytree after `jax.tree_util.tree_map(
np.asarray, params)` (nested dicts of numpy arrays; no JAX needed here) and
returns the port's params: the same tree, same layouts ([L, in, out]
stacked weights), as torch tensors on `device`. Both packages then compute
the same function, which is what the parity tests rely on. Quantized leaves
(int8 and int4 serving leaves, an int8 QLoRA base) carry over byte for
byte. `lora_from_jax` does the same for a LoRA adapter tree, and
`params_to_numpy` goes the other way (the port's tree as numpy arrays in
the JAX package's layout), so tests can hold trained weights against the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models.transformer import resolve_device


def expected_shapes(cfg: ModelConfig) -> dict:
    """Leaf path -> shape for a config's params (the MLP's or, for a
    Mixtral config, the MoE's leaves)."""
    L, D, F = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, Kv, Dh, V = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_,
                    cfg.vocab_size)
    if cfg.is_moe:
        E = cfg.num_local_experts
        mlp = {("layers", "moe", "router"): (L, D, E),
               ("layers", "moe", "gate"): (L, E, D, F),
               ("layers", "moe", "up"): (L, E, D, F),
               ("layers", "moe", "down"): (L, E, F, D)}
    else:
        mlp = {("layers", "mlp", "gate"): (L, D, F),
               ("layers", "mlp", "up"): (L, D, F),
               ("layers", "mlp", "down"): (L, F, D)}
    return {
        ("embed", "embedding"): (V, D),
        ("layers", "ln1", "scale"): (L, D),
        ("layers", "ln2", "scale"): (L, D),
        ("layers", "attn", "wq"): (L, D, H * Dh),
        ("layers", "attn", "wk"): (L, D, Kv * Dh),
        ("layers", "attn", "wv"): (L, D, Kv * Dh),
        ("layers", "attn", "wo"): (L, H * Dh, D),
        ("layers", "attn", "bq"): (L, H * Dh),
        ("layers", "attn", "bk"): (L, Kv * Dh),
        ("layers", "attn", "bv"): (L, Kv * Dh),
        **mlp,
        ("final_ln", "scale"): (D,),
        ("lm_head", "kernel"): (D, V),
    }


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _quantized_shapes(node: dict, dense: tuple, name: str) -> None:
    """Check a quantized leaf against the dense [..., K, N] shape it stands
    for ([L, K, N], or [L, E, K, N] for an expert stack): q8 int8 [..., K, N]
    with scale [..., 1, N]; q4 uint8 [..., K/2, N] with scale [..., K/g, N],
    g dividing K."""
    *lead, K, N = dense
    scale = tuple(np.shape(node["scale"]))
    if "q8" in node:
        want = {"q8": (dense, np.int8), "scale": ((*lead, 1, N), np.float32)}
    else:
        G = scale[-2] if len(scale) == len(dense) and scale[-2] else 0
        if not G or K % G:
            raise ValueError(f"params_from_jax: {name} scale {scale} has no group dividing K {K}")
        want = {"q4": ((*lead, K // 2, N), np.uint8), "scale": ((*lead, G, N), np.float32)}
    if set(node) != set(want):
        raise ValueError(f"params_from_jax: {name} has leaves {sorted(node)}")
    for key, (shape, dtype) in want.items():
        arr = np.asarray(node[key])
        if arr.shape != shape or arr.dtype != dtype:
            raise ValueError(f"params_from_jax: {name}/{key} is {arr.dtype} {arr.shape}, "
                             f"the config needs {np.dtype(dtype)} {shape}")


def _projection_shapes(node: dict, D: int) -> None:
    """Check an embedding projection head: {kernel [D, P], bias [P]}, any P."""
    if not isinstance(node, dict) or set(node) != {"kernel", "bias"}:
        raise ValueError(f"params_from_jax: projection has leaves "
                         f"{sorted(node) if isinstance(node, dict) else type(node)}")
    kernel, bias = np.shape(node["kernel"]), np.shape(node["bias"])
    if len(kernel) != 2 or kernel[0] != D or bias != kernel[1:]:
        raise ValueError(f"params_from_jax: projection kernel {kernel}, bias {bias}; "
                         f"the config needs [{D}, P] and [P]")


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX param tree (numpy leaves) -> the port's param tree on
    `device`. Quantized leaves (training/quant.py layouts) carry over as
    they are, and so does an embedding projection head
    (projection/{kernel [D, P], bias [P]}, any P). Raises on a leaf the
    port does not know or a shape that does not match `cfg`."""
    device = resolve_device(device)
    shapes = expected_shapes(cfg)

    def walk(node, path):
        name = "/".join(path)
        if path == ("projection",):
            _projection_shapes(node, cfg.hidden_size)
            return {k: _to_torch(v).to(device) for k, v in node.items()}
        if isinstance(node, dict) and ("q8" in node or "q4" in node) and path in shapes:
            _quantized_shapes(node, shapes[path], name)
            return {k: _to_torch(v).to(device) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path not in shapes:
            raise ValueError(f"params_from_jax: unknown leaf {name}")
        if tuple(np.shape(node)) != shapes[path]:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{tuple(np.shape(node))}, config needs {shapes[path]}")
        return _to_torch(node).to(device)

    return walk(tree, ())


def lora_from_jax(tree: dict, device=None) -> dict:
    """A JAX LoRA tree ({..., name: {"A": [L, in, r], "B": [L, r, out]}},
    numpy leaves) -> the port's LoRA tree on `device`."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_torch(node).to(device)

    return walk(tree)


def params_to_numpy(tree: dict) -> dict:
    """The port's tree (params or LoRA) -> numpy arrays, same nesting and
    layouts as the JAX package's tree; bfloat16 leaves come out as float32
    (numpy has no bfloat16 of its own)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
