"""HF-safetensors checkpoint bridge (port of gritlm_tpu.models.loader).

`load_checkpoint` reads Mistral/Mixtral/Llama/Qwen2-family HF checkpoints into the
port's stacked-layer param tree; `save_checkpoint` exports back to HF names,
sharded and indexed as the JAX package does. HF stores Linear weights as
[out, in]; the port's kernels are [in, out], so they transpose on the way.

The safetensors format is written and read here by hand (the card's machine
has no `safetensors` package): an 8-byte little-endian header length, a
JSON header mapping each name to its dtype, shape and `data_offsets`
(padded with spaces to a multiple of 8 bytes), then the raw little-endian
tensor bytes. Files written here load in `safetensors.numpy.load_file`.
An embedding projection head travels as `projection.weight`/`.bias`.
A Mixtral layer's MoE travels as `block_sparse_moe.gate.weight` (the
router) and `block_sparse_moe.experts.{e}.w1|w3|w2.weight` (gate, up,
down). `add_lm_head` grafts a donor's LM head onto an embedding-only model.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Optional, Tuple

import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.models.transformer import resolve_device

_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write `tensors` (in order) as one safetensors file."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            # little-endian bytes of a contiguous CPU copy, strides dropped
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
                    .tobytes())


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, on the CPU."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())  # the tensors are views of this one buffer
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(bytes(buf[8:8 + n]))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        dt = _DTYPES[info["dtype"]]
        if b == a:
            out[name] = torch.empty(info["shape"], dtype=dt)
            continue
        t = torch.frombuffer(buf, dtype=torch.uint8, count=b - a, offset=8 + n + a)
        out[name] = t.view(dt).reshape(info["shape"])
    return out


def _open_all_tensors(path: str) -> Dict[str, torch.Tensor]:
    tensors: Dict[str, torch.Tensor] = {}
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        for shard in sorted(set(weight_map.values())):
            tensors.update(read_safetensors(os.path.join(path, shard)))
    else:
        for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
            tensors.update(read_safetensors(f))
    if not tensors:
        raise FileNotFoundError(f"No safetensors found under {path}")
    return tensors


def load_checkpoint(path: str, with_lm_head: bool = True, dtype: Optional[str] = None,
                    device=None) -> Tuple[ModelConfig, dict]:
    """(config, params) from an HF checkpoint directory, params on `device`
    (CUDA unless asked otherwise). `dtype` overrides the checkpoint dtype
    for both the config and the tensors."""
    cfg = ModelConfig.from_hf_config(os.path.join(path, "config.json"), dtype=dtype)
    device = resolve_device(device)
    tensors = _open_all_tensors(path)
    dt = cfg.torch_dtype

    def on_device(x: torch.Tensor, transpose: bool) -> torch.Tensor:
        # transposed on the device: a strided copy there is cheap
        x = x.to(device)
        return (x.transpose(-1, -2).contiguous() if transpose else x).to(dt)

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        return on_device(tensors[name], transpose)

    def maybe_prefix(name: str) -> str:
        # trainer state dicts may carry a leading "model." already
        for p in ("model.", ""):
            if p + name in tensors:
                return p + name
        raise KeyError(name)

    L = cfg.num_hidden_layers

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return on_device(torch.stack([tensors[maybe_prefix(fmt.format(i=i))]
                                      for i in range(L)]), transpose)

    attn = {
        "wq": stack("layers.{i}.self_attn.q_proj.weight", True),
        "wk": stack("layers.{i}.self_attn.k_proj.weight", True),
        "wv": stack("layers.{i}.self_attn.v_proj.weight", True),
        "wo": stack("layers.{i}.self_attn.o_proj.weight", True),
    }
    if cfg.attention_bias:  # Qwen2-family QKV biases
        attn["bq"] = stack("layers.{i}.self_attn.q_proj.bias")
        attn["bk"] = stack("layers.{i}.self_attn.k_proj.bias")
        attn["bv"] = stack("layers.{i}.self_attn.v_proj.bias")
    layers = {
        "ln1": {"scale": stack("layers.{i}.input_layernorm.weight")},
        "attn": attn,
        "ln2": {"scale": stack("layers.{i}.post_attention_layernorm.weight")},
    }
    if cfg.is_moe:
        E = cfg.num_local_experts

        def stack_experts(w: str) -> torch.Tensor:
            # [L, E, in, out], filled one expert matrix at a time
            name = "layers.{i}.block_sparse_moe.experts.{e}." + w + ".weight"
            out_dim, in_dim = tensors[maybe_prefix(name.format(i=0, e=0))].shape
            out = torch.empty((L, E, in_dim, out_dim), dtype=dt, device=device)
            for i in range(L):
                for e in range(E):
                    out[i, e] = on_device(tensors[maybe_prefix(name.format(i=i, e=e))], True)
            return out

        layers["moe"] = {
            "router": stack("layers.{i}.block_sparse_moe.gate.weight", True),
            "gate": stack_experts("w1"),  # HF w1 = gate [F, D]
            "up": stack_experts("w3"),  # HF w3 = up [F, D]
            "down": stack_experts("w2"),  # HF w2 = down [D, F]
        }
    else:
        layers["mlp"] = {
            "gate": stack("layers.{i}.mlp.gate_proj.weight", True),
            "up": stack("layers.{i}.mlp.up_proj.weight", True),
            "down": stack("layers.{i}.mlp.down_proj.weight", True),
        }
    params = {
        "embed": {"embedding": get(maybe_prefix("embed_tokens.weight"))},
        "layers": layers,
        "final_ln": {"scale": get(maybe_prefix("norm.weight"))},
    }
    if with_lm_head and not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = {"kernel": get("lm_head.weight", True)}
    if "projection.weight" in tensors:
        params["projection"] = {"kernel": get("projection.weight", True),
                                "bias": get("projection.bias")}
    return cfg, params


def save_checkpoint(path: str, cfg: ModelConfig, params: dict,
                    max_shard_bytes: int = 5 * 2**30) -> None:
    """Export to HF names in safetensors (the inverse of load_checkpoint),
    sharded at about 5 GB with an index, as the JAX package does. Tensors
    are copied to the CPU one at a time as they are written."""
    os.makedirs(path, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}

    def put(name: str, x: torch.Tensor, transpose: bool = False) -> None:
        flat[name] = x.detach().T if transpose else x.detach()

    put("model.embed_tokens.weight", params["embed"]["embedding"])
    ls = params["layers"]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        put(f"{p}.input_layernorm.weight", ls["ln1"]["scale"][i])
        put(f"{p}.self_attn.q_proj.weight", ls["attn"]["wq"][i], True)
        put(f"{p}.self_attn.k_proj.weight", ls["attn"]["wk"][i], True)
        put(f"{p}.self_attn.v_proj.weight", ls["attn"]["wv"][i], True)
        put(f"{p}.self_attn.o_proj.weight", ls["attn"]["wo"][i], True)
        if "bq" in ls["attn"]:
            put(f"{p}.self_attn.q_proj.bias", ls["attn"]["bq"][i])
            put(f"{p}.self_attn.k_proj.bias", ls["attn"]["bk"][i])
            put(f"{p}.self_attn.v_proj.bias", ls["attn"]["bv"][i])
        put(f"{p}.post_attention_layernorm.weight", ls["ln2"]["scale"][i])
        if cfg.is_moe:
            moe = ls["moe"]
            put(f"{p}.block_sparse_moe.gate.weight", moe["router"][i], True)
            for e in range(cfg.num_local_experts):
                q = f"{p}.block_sparse_moe.experts.{e}"
                put(f"{q}.w1.weight", moe["gate"][i, e], True)
                put(f"{q}.w3.weight", moe["up"][i, e], True)
                put(f"{q}.w2.weight", moe["down"][i, e], True)
        else:
            put(f"{p}.mlp.gate_proj.weight", ls["mlp"]["gate"][i], True)
            put(f"{p}.mlp.up_proj.weight", ls["mlp"]["up"][i], True)
            put(f"{p}.mlp.down_proj.weight", ls["mlp"]["down"][i], True)
    put("model.norm.weight", params["final_ln"]["scale"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"]["kernel"], True)
    if "projection" in params:
        put("projection.weight", params["projection"]["kernel"], True)
        put("projection.bias", params["projection"]["bias"])

    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        if cur and cur_bytes + nbytes(v) > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += nbytes(v)
    shards.append(cur)

    if len(shards) == 1:
        write_safetensors(os.path.join(path, "model.safetensors"), shards[0])
    else:
        weight_map = {}
        n = len(shards)
        for si, shard in enumerate(shards):
            fname = f"model-{si + 1:05d}-of-{n:05d}.safetensors"
            write_safetensors(os.path.join(path, fname), shard)
            for k in shard:
                weight_map[k] = fname
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": int(sum(nbytes(v) for v in flat.values()))},
                       "weight_map": weight_map}, f)

    hf_cfg = {
        "model_type": cfg.model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "sliding_window": cfg.sliding_window,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": cfg.dtype,
    }
    if cfg.head_dim is not None:
        hf_cfg["head_dim"] = cfg.head_dim
    if cfg.attention_bias:
        hf_cfg["attention_bias"] = True
    if cfg.rope_scaling_type is not None:
        rs = {"rope_type": cfg.rope_scaling_type, "factor": cfg.rope_scaling_factor}
        if cfg.rope_scaling_type == "llama3":
            rs.update(low_freq_factor=cfg.rope_low_freq_factor,
                      high_freq_factor=cfg.rope_high_freq_factor,
                      original_max_position_embeddings=cfg.rope_original_max_position)
        hf_cfg["rope_scaling"] = rs
    if cfg.is_moe:
        hf_cfg.update(num_local_experts=cfg.num_local_experts,
                      num_experts_per_tok=cfg.num_experts_per_tok,
                      router_aux_loss_coef=cfg.router_aux_loss_coef)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)


def add_lm_head(params: dict, donor_params: dict) -> dict:
    """Graft the LM head of a donor checkpoint's params onto an
    embedding-only model's (reference scripts/add_lm_head.py). A new top
    level; the leaves are shared, not copied."""
    out = dict(params)
    out["lm_head"] = donor_params["lm_head"]
    return out
