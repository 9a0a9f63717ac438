"""GRIT training entry point: `python -m gritlm_tpu_torch.training.run --args...`

The port of `python -m gritlm_tpu.training.run` on one device: loads JSONL
data, builds the unified dataset / collator / sampler, runs the train step
(GradCache inside; full parameters, LoRA, or QLoRA over an int8 base), logs
loss_emb / loss_gen, checkpoints with resume, and exports the final model as
an HF-safetensors checkpoint (LoRA merged, the base dense). The model is an
HF checkpoint with its tokenizer (`--model_name_or_path`, with the
embedding projection head it carries) or a preset with random weights from
`--seed`; `--projection P` adds a fresh head of width P (trained with full
parameters, frozen under LoRA, as in the JAX package). A Mixtral model
(`--model_preset tiny_mixtral|mixtral_8x7b` or a Mixtral checkpoint) trains
with the load-balancing aux loss, `--moe_impl dense|dropless|gshard|auto`
overrides its MoE execution, and its metrics log carries moe_dropped_frac.
`--native_loader` feeds the steps from the C++ input pipeline
(training/native_loader.py) when the tokenizer is the byte tokenizer, and
warns and keeps the Python pipeline otherwise, as the JAX CLI does. It
writes the JAX CLI's files: run_args.json, dataset_num_samples.json,
metrics.jsonl, checkpoints/step_<n>/ and export/.

Example (toy run on the CPU, the kernels' plain versions):
  python -m gritlm_tpu_torch.training.run --train_data tests/toy_data \\
      --device cpu --model_preset tiny_mistral --mode unified \\
      --per_device_train_batch_size 2 --max_steps 8 --output_dir /tmp/run

On the GPU drop `--device cpu` (default cuda). `--dtype float32` trains at
fp32 activations on either device (on the GPU through the fp32 forms of the
flash forward and backward). The mesh options, which the port does not run
yet, raise NotImplementedError (RunArguments.check_ported).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re

logger = logging.getLogger("gritlm_tpu_torch.train")


def main(argv=None) -> dict:
    from gritlm_tpu_torch import config as cfgmod
    from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from gritlm_tpu_torch.models.transformer import (
        init_params,
        init_projection,
        resolve_device,
    )
    from gritlm_tpu_torch.tokenizer import ByteTokenizer, load_tokenizer
    from gritlm_tpu_torch.training.arguments import parse_args
    from gritlm_tpu_torch.training.checkpoint import CheckpointManager
    from gritlm_tpu_torch.training.data import (
        GritCollator,
        GritDataset,
        batch_iterator,
        filter_too_long_instructions,
        load_train_dirs,
    )
    from gritlm_tpu_torch.training.metrics_logger import MetricsLogger
    from gritlm_tpu_torch.training.train import init_train_state, train_step

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    args.check_ported()
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "run_args.json"), "w") as f:
        json.dump(args.__dict__, f, indent=2, default=str)

    # ---- model: an HF checkpoint with its tokenizer, or a preset with random
    # weights from --seed
    if args.model_name_or_path:
        cfg, params = load_checkpoint(args.model_name_or_path,
                                      with_lm_head=(args.mode != "embedding"), dtype=args.dtype,
                                      device=device)
        if args.moe_impl and cfg.is_moe:
            cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
        tokenizer = load_tokenizer(args.model_name_or_path)
    else:
        cfg = getattr(cfgmod, args.model_preset)()
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        if args.moe_impl and cfg.is_moe:
            cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
        params = init_params(cfg, args.seed, with_lm_head=(args.mode != "embedding"),
                             device=device)
        tokenizer = load_tokenizer(None)
    if args.projection:
        # a fresh embedding head (over a checkpoint's own): uniform in
        # +-sqrt(6 / (D + P)), zero bias, from seed + 1, as the JAX CLI draws it
        params["projection"] = init_projection(cfg, args.projection, args.seed + 1, device)
    logger.info("model: %s (%s) on %s, moe=%s, projection=%s",
                args.model_name_or_path or args.model_preset, cfg.dtype, device,
                cfg.moe_impl if cfg.is_moe else False, args.projection)

    # ---- data
    emb_sets, gen_sets = load_train_dirs(args.train_data)
    emb_sets = filter_too_long_instructions(tokenizer, emb_sets, args.query_max_len,
                                            args.passage_max_len)
    emb_sets = [s for s in emb_sets if s]
    n_emb = sum(len(s) for s in emb_sets)
    n_gen = sum(len(s) for s in gen_sets)
    logger.info("data: %d embedding samples (%d files), %d generative (%d files)",
                n_emb, len(emb_sets), n_gen, len(gen_sets))
    if args.mode == "unified" and n_emb == 0 and n_gen > 0:
        logger.warning(
            "unified mode but every embedding sample was filtered out (instruction+query "
            "longer than query_max_len=%d / passage_max_len=%d?): training degrades to "
            "generative-only", args.query_max_len, args.passage_max_len)
    with open(os.path.join(args.output_dir, "dataset_num_samples.json"), "w") as f:
        json.dump({"embedding": n_emb, "generative": n_gen}, f)
    dataset = GritDataset(
        emb_sets, gen_sets, mode=args.mode, train_group_size=args.train_group_size,
        max_char_len=max(args.passage_max_len, args.generative_max_len) * 10,
        seed=args.seed, use_unique_indices=args.use_unique_indices,
    )

    # ---- global batch: one device
    global_bs = args.per_device_train_batch_size
    take_nth = 1
    if args.per_device_generative_bs:
        assert args.per_device_train_batch_size % args.per_device_generative_bs == 0
        take_nth = args.per_device_train_batch_size // args.per_device_generative_bs
    collator = GritCollator(
        tokenizer, query_max_len=args.query_max_len, passage_max_len=args.passage_max_len,
        generative_max_len=args.generative_max_len, prefixlm=args.prefixlm,
        take_nth=take_nth,
    )
    steps_per_epoch = max(len(dataset) // global_bs, 1)
    total_steps = args.max_steps or steps_per_epoch * args.num_train_epochs
    tc = args.to_train_config(total_steps)
    logger.info("global_bs=%d steps=%d gradcache_chunks=%d", global_bs, total_steps,
                tc.gc_chunks)

    # ---- state (+ resume)
    lora_setup = None
    if args.lora or args.qlora:
        from gritlm_tpu_torch.training.lora import make_lora_train_state

        run_step, state, frozen_base, lora_scale = make_lora_train_state(
            cfg, tc, params, r=args.lora_r, alpha=args.lora_alpha, quantize=args.qlora,
            seed=args.seed, device=device)
        lora_setup = (frozen_base, lora_scale)
        logger.info("%s training: r=%d alpha=%d (base frozen%s)",
                    "qlora" if args.qlora else "lora", args.lora_r, args.lora_alpha,
                    ", int8" if args.qlora else "")
    else:
        state = init_train_state(params, tc)

        def run_step(state, batch):
            return train_step(state, batch, cfg, tc)
    del params
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                             args.save_total_limit)
    start_step = 0
    start_epoch, skip_batches = 0, 0
    if args.resume_from_checkpoint:
        want = None  # "auto" -> latest
        if args.resume_from_checkpoint != "auto":
            m = re.search(r"step_(\d+)", args.resume_from_checkpoint)
            want = int(m.group(1)) if m else None
        if ckpt.latest_step() is not None:
            state = ckpt.restore(state, step=want)
            start_step = state.step
            # data-order resume: fast-forward the deterministic batch stream
            # to the saved cursor (steps_per_epoch arithmetic without one)
            extra = ckpt.read_extra(want) or {}
            if "batch_in_epoch" in extra:
                start_epoch = int(extra.get("epoch", 0))
                skip_batches = int(extra["batch_in_epoch"])
            else:
                start_epoch = start_step // steps_per_epoch
                skip_batches = start_step % steps_per_epoch
            logger.info("resumed from step %d (epoch %d, skipping %d batches)",
                        start_step, start_epoch, skip_batches)

    native = None
    if args.native_loader:
        if not isinstance(tokenizer, ByteTokenizer):
            logger.warning("native_loader supports the byte tokenizer only; falling back to "
                           "the python pipeline")
        else:
            from gritlm_tpu_torch.training.native_loader import NativeGritLoader

            native = NativeGritLoader(
                args.train_data, batch_size=global_bs, train_group_size=args.train_group_size,
                query_max_len=args.query_max_len, passage_max_len=args.passage_max_len,
                generative_max_len=args.generative_max_len, seed=args.seed, take_nth=take_nth,
            )
            logger.info("native loader: %d emb / %d gen samples", native.n_emb, native.n_gen)

    def batches_for(epoch: int, skip: int = 0):
        if native is not None:
            it = native.epoch(epoch)
            for _ in range(skip):  # draining the C++ loader's skipped batches is cheap
                if next(it, None) is None:
                    return iter(())
            return it
        return batch_iterator(dataset, collator, global_bs, seed=args.seed, epoch=epoch,
                              skip=skip)

    mlog = MetricsLogger(args.output_dir, args.logging_steps)
    step = start_step
    done = False
    last = {}
    epoch, bidx = start_epoch, skip_batches  # cursor if the loop never runs
    for epoch in range(args.num_train_epochs * 50):  # re-iterate if max_steps is larger
        if done:
            break
        if epoch < start_epoch:
            # replay fully consumed epochs' dataset draws so GritDataset.rng
            # reaches the uninterrupted run's state (collation is skipped; the
            # native loader reseeds each epoch)
            if native is None:
                for _ in batches_for(epoch, skip=10**9):
                    pass
            continue
        bidx = skip_batches if epoch == start_epoch else 0
        for batch in batches_for(epoch, skip=bidx):
            if step >= total_steps:
                done = True
                break
            state, m = run_step(state, batch)
            step += 1
            bidx += 1
            last = {"loss": float(m.loss), "loss_emb": float(m.loss_emb),
                    "loss_gen": float(m.loss_gen), "grad_norm": float(m.grad_norm)}
            if cfg.is_moe:  # the gshard capacity-overflow rate (0 = exact routing)
                last["moe_dropped_frac"] = float(m.moe_dropped_frac)
            mlog.log(step, last)
            if args.save_steps and step % args.save_steps == 0:
                ckpt.save(state, extra={"epoch": epoch, "batch_in_epoch": bidx})
        if args.max_steps is None and epoch + 1 >= args.num_train_epochs:
            done = True

    # ---- final save + HF export (LoRA: merged into dense weights)
    ckpt.save(state, extra={"epoch": epoch, "batch_in_epoch": bidx})
    ckpt.wait()
    export_dir = os.path.join(args.output_dir, "export")
    if lora_setup is not None:
        from gritlm_tpu_torch.training.lora import merge

        frozen_base, lora_scale = lora_setup
        export_params = merge(frozen_base, state.params, lora_scale)
    else:
        export_params = state.params
    save_checkpoint(export_dir, cfg, export_params)
    del export_params
    logger.info("final checkpoint step %d -> %s", step, export_dir)
    mlog.close()
    if native is not None:
        native.close()
    return {"steps": step, "final": last, "export": export_dir}


if __name__ == "__main__":
    main()
