"""Model configuration (Mistral family), the PyTorch port's own copy.

Same fields and presets as `gritlm_tpu.config`; `torch_dtype` stands where
the JAX package has `jnp_dtype`.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer config (Mistral / Mixtral family). Field
    names mirror the HF config.json keys."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-family QKV projection biases
    rope_scaling_type: Optional[str] = None  # None | "linear" | "llama3"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # MoE (Mixtral). num_local_experts == 0 means dense MLP.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    moe_impl: str = "dense"
    capacity_factor: float = 2.0
    dtype: str = "bfloat16"  # parameter/activation dtype
    model_type: str = "mistral"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_local_experts > 0

    @property
    def rope_scaling_(self):
        """(type, factor, low, high, orig_ctx) tuple for apply_rope, or
        None when unscaled."""
        if self.rope_scaling_type is None:
            return None
        return (
            self.rope_scaling_type,
            self.rope_scaling_factor,
            self.rope_low_freq_factor,
            self.rope_high_freq_factor,
            self.rope_original_max_position,
        )

    @classmethod
    def from_hf_config(cls, path_or_dict, dtype: Optional[str] = None) -> "ModelConfig":
        """Build from an HF config.json path or dict (mistral/mixtral/llama/
        qwen2). `dtype` overrides the checkpoint's torch_dtype."""
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                d = json.load(f)
        else:
            d = dict(path_or_dict)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if d.get("model_type") == "mixtral":
            kwargs.setdefault("num_local_experts", d.get("num_local_experts", 8))
        else:
            kwargs["num_local_experts"] = 0
        kwargs["model_type"] = d.get("model_type", "mistral")
        if kwargs["model_type"] == "qwen2":
            kwargs.setdefault("attention_bias", d.get("attention_bias", True))
        rs = d.get("rope_scaling")
        if rs:
            t = rs.get("rope_type") or rs.get("type")
            if t in ("linear", "llama3"):
                kwargs["rope_scaling_type"] = t
                kwargs["rope_scaling_factor"] = float(rs.get("factor", 1.0))
                if t == "llama3":
                    kwargs["rope_low_freq_factor"] = float(
                        rs.get("low_freq_factor", 1.0))
                    kwargs["rope_high_freq_factor"] = float(
                        rs.get("high_freq_factor", 4.0))
                    kwargs["rope_original_max_position"] = int(
                        rs.get("original_max_position_embeddings", 8192))
            elif t not in (None, "default"):
                raise NotImplementedError(
                    f"rope_scaling type {t!r} not supported "
                    "(supported: linear, llama3)"
                )
        td = d.get("torch_dtype")
        if dtype is not None:
            kwargs["dtype"] = dtype
        elif td in ("bfloat16", "float32", "float16"):
            if td == "float16":
                warnings.warn(
                    "from_hf_config: promoting torch_dtype float16 to "
                    "bfloat16. Pass dtype='float16' to keep fp16 numerics.",
                    stacklevel=2,
                )
                kwargs["dtype"] = "bfloat16"
            else:
                kwargs["dtype"] = td
        return cls(**kwargs)


# ---------------------------------------------------------------------------
# Presets


def mistral_7b() -> ModelConfig:
    return ModelConfig()


def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        num_local_experts=8,
        num_experts_per_tok=2,
        model_type="mixtral",
    )


def tiny_mistral(vocab_size: int = 512) -> ModelConfig:
    """Tiny config for tests."""
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=2048,
        dtype="float32",
    )


def llama3_8b() -> ModelConfig:
    return ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=131072,
        rope_theta=500000.0,
        rope_scaling_type="llama3",
        rope_scaling_factor=8.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_position=8192,
        model_type="llama",
    )


def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        max_position_embeddings=131072,
        rope_theta=1000000.0,
        attention_bias=True,
        model_type="qwen2",
    )


def tiny_llama3(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=2048,
        rope_theta=500000.0,
        rope_scaling_type="llama3",
        rope_scaling_factor=8.0,
        rope_original_max_position=256,
        model_type="llama",
        dtype="float32",
    )


def tiny_qwen2(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=2048,
        rope_theta=1000000.0,
        attention_bias=True,
        model_type="qwen2",
        dtype="float32",
    )


def tiny_mixtral(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=2048,
        num_local_experts=4,
        num_experts_per_tok=2,
        model_type="mixtral",
        dtype="float32",
    )
