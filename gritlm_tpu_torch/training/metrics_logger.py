"""Training metrics logging (a copy of gritlm_tpu.training.metrics_logger).

The reference logs train/loss_emb and train/loss_gen separately in unified
mode via a monkey-patched WandB callback (run.py:345-380). Here: a JSONL
metrics file always, console every logging_steps, and WandB if the package
exists and WANDB_PROJECT is set (not installed in this image → no-op).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

logger = logging.getLogger("gritlm_tpu_torch.train")


class MetricsLogger:
    def __init__(self, output_dir: str, logging_steps: int = 10):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.logging_steps = logging_steps
        self._t0 = time.perf_counter()
        self._last_t = self._t0
        self._last_step = 0
        self._wandb = None
        if os.environ.get("WANDB_PROJECT"):
            try:
                import wandb  # noqa: F401

                self._wandb = wandb
                wandb.init(project=os.environ["WANDB_PROJECT"])
            except ImportError:
                logger.info("wandb not installed; JSONL logging only")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        now = time.perf_counter()
        row = {
            "step": step,
            "time": round(now - self._t0, 3),
            **{k: round(float(v), 6) for k, v in metrics.items()},
        }
        if step > self._last_step:
            row["steps_per_sec"] = round(
                (step - self._last_step) / max(now - self._last_t, 1e-9), 4
            )
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({f"train/{k}": v for k, v in metrics.items()}, step=step)
        if self.logging_steps and step % self.logging_steps == 0:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            logger.info("step %d: %s", step, parts)
            print(f"[step {step}] {parts}", flush=True)
        self._last_t, self._last_step = now, step

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
