"""Typed run configuration + CLI parsing (a copy of
gritlm_tpu.training.arguments, plus `--device`).

One config system replacing the reference's HfArgumentParser dataclasses +
TrainingArguments + accelerate YAML topology files (SURVEY §5.6): model,
data, optimization and mesh in one place, parseable from the command line
(--key value / --key=value / --flag) or a JSON file.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import List, Optional, Sequence


@dataclasses.dataclass
class RunArguments:
    # model
    model_name_or_path: Optional[str] = None  # HF checkpoint dir; None = preset
    model_preset: str = "tiny_mistral"  # tiny_mistral | tiny_mixtral | mistral_7b | mixtral_8x7b
    pooling_method: str = "mean"
    normalized: bool = True
    attn: str = "bbcc"
    projection: Optional[int] = None  # embedding projection head dim
    dtype: Optional[str] = None  # override checkpoint dtype
    moe_impl: Optional[str] = None  # MoE execution override:
    # dense | dropless (exact) | gshard (EP all_to_all, capacity-dropped)

    # data (reference DataArguments, gritlm/training/arguments.py)
    train_data: List[str] = dataclasses.field(default_factory=list)
    mode: str = "unified"
    train_group_size: int = 2
    query_max_len: int = 256
    passage_max_len: int = 2048
    generative_max_len: int = 2048
    prefixlm: bool = False
    use_unique_indices: bool = False

    # optimization (reference CustomTrainingArguments)
    per_device_train_batch_size: int = 8
    per_device_generative_bs: Optional[int] = None  # smaller gen sub-batch
    gc_chunks: int = 1  # GradCache chunks (reference: gradient_accumulation via GradCache)
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    num_train_epochs: int = 1
    max_steps: Optional[int] = None
    max_grad_norm: float = 1.0
    temperature: float = 0.02
    loss_gen_type: str = "mixed"
    loss_gen_factor: float = 1.0
    emb_q_only: bool = False  # stop-grad through passages
    emb_p_only: bool = False  # stop-grad through queries
    remat: bool = True
    remat_policy: Optional[str] = None  # None|dots|dots_no_batch
    # fuse LM head into the next-token loss (vocab-chunked logsumexp);
    # memory feature — enable when big-vocab logits OOM (see train.py)
    fused_ce: bool = False
    seed: int = 42

    # parameter-efficient training (reference --lora/--qlora,
    # gritlm/training/run.py:217-284; qlora = int8 frozen base, quant.py)
    lora: bool = False
    qlora: bool = False
    lora_r: int = 16
    lora_alpha: int = 64

    # mesh topology (replaces accelerate YAML)
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_model: int = 1
    mesh_expert: int = 1
    # pipeline parallelism: GPipe stages over a `stage` axis (dense models;
    # composes with mesh_data, not with gc_chunks/lora)
    mesh_stage: int = 1
    pipeline_microbatches: int = 2
    # sequence parallelism: shard sequences over all devices (ring attention)
    # for long-context training; mutually exclusive with the other axes
    seq_parallel: bool = False

    # input pipeline: native C++ loader (byte-tokenizer path; JSONL parse +
    # tokenize + batch pack in a background thread, see native/gritloader.cpp)
    native_loader: bool = False

    # the port's device: cuda (default) or cpu (the kernels' plain versions)
    device: str = "cuda"

    # io
    output_dir: str = "out"
    save_steps: int = 500
    save_total_limit: int = 2
    logging_steps: int = 10
    resume_from_checkpoint: Optional[str] = None  # path or "auto"

    def check_ported(self) -> None:
        """Raise NotImplementedError, naming the ROADMAP Queue 1 item that
        brings it, for every option the port does not run yet."""
        not_ported = [
            (self.native_loader, "--native_loader (the C++ input pipeline)", 13),
            (self.seq_parallel, "--seq_parallel", 12),
            (self.mesh_stage > 1, "--mesh_stage > 1", 12),
            (self.mesh_data != 1 or self.mesh_fsdp not in (-1, 1) or self.mesh_model != 1
             or self.mesh_expert != 1, "a mesh of more than one device", 12),
            (self.moe_impl is not None, "--moe_impl", 11),
        ]
        for bad, what, item in not_ported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported to gritlm_tpu_torch yet (ROADMAP Queue 1 item {item})")

    def to_train_config(self, total_steps: int):
        from gritlm_tpu_torch.training.train import TrainConfig

        return TrainConfig(
            mode=self.mode,
            pooling_method=self.pooling_method,
            normalized=self.normalized,
            attn=self.attn,
            temperature=self.temperature,
            loss_gen_type=self.loss_gen_type,
            loss_gen_factor=self.loss_gen_factor,
            gc_chunks=self.gc_chunks,
            q_grad=not self.emb_p_only,
            p_grad=not self.emb_q_only,
            learning_rate=self.learning_rate,
            weight_decay=self.weight_decay,
            warmup_ratio=self.warmup_ratio,
            total_steps=total_steps,
            max_grad_norm=self.max_grad_norm,
            remat=self.remat,
            remat_policy=self.remat_policy,
            fused_ce=self.fused_ce,
        )


def _coerce(val: str, typ) -> object:
    import typing

    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[x]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if val.lower() in ("none", "null"):
            return None
        return _coerce(val, args[0])
    if typ is bool or typ == bool:
        return val.lower() in ("1", "true", "yes")
    if origin in (list, List):
        return [x for x in val.split(",") if x]
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def parse_args(argv: Optional[Sequence[str]] = None) -> RunArguments:
    import typing

    argv = list(sys.argv[1:] if argv is None else argv)
    args = RunArguments()
    hints = typing.get_type_hints(RunArguments)  # resolve PEP-563 strings
    fields = {f.name: f for f in dataclasses.fields(RunArguments)}
    if argv and argv[0].endswith(".json"):
        with open(argv.pop(0)) as f:
            for k, v in json.load(f).items():
                setattr(args, k, v)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"Unexpected argument: {tok}")
        key = tok[2:].replace("-", "_")
        if "=" in key:
            key, val = key.split("=", 1)
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            i += 1
            val = argv[i]
        else:
            val = "true"  # bare flag
        if key not in fields:
            raise ValueError(f"Unknown argument: --{key}")
        typ = hints[key]
        if key == "train_data":
            args.train_data.extend(_coerce(val, typ))
        else:
            setattr(args, key, _coerce(val, typ))
        i += 1
    return args
