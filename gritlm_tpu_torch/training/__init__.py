"""GRIT training on one device: losses, the unified train step with
GradCache (train.py), LoRA (lora.py), the data pipeline, run arguments,
checkpoints, metrics logging, the CLI `python -m gritlm_tpu_torch.training.run`,
and the prompt templates."""
