"""Training checkpoints: save / restore / rotate / resume of a TrainState
(the port's counterpart of gritlm_tpu.training.checkpoint, which uses Orbax).

Same API and directory layout as the JAX package: `<dir>/step_<n>/state`
holds the state and `<dir>/step_<n>/extra.json` the data cursor. Here
`state` is a directory holding one `torch.save` file (the trained tree, the
optimizer's and the scheduler's state dicts, and the step), renamed into
place when complete, so a step whose write was cut is never listed. Saves
are synchronous: `wait()` only re-applies the rotation. The final model
export in HF safetensors goes through models/loader.save_checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch

from gritlm_tpu_torch.training.train import TrainState, leaves

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "train_state.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _copy_into(dst, src, path=()):
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"checkpoint tree differs from the template at {'/'.join(path)}")
        for k in dst:
            _copy_into(dst[k], src[k], path + (k,))
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {'/'.join(path)} has shape {tuple(src.shape)}, "
                         f"the template {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_total_limit = save_total_limit

    # ------------------------------------------------------------------ paths

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self):
        steps = []
        if os.path.isdir(self.directory):
            for d in os.listdir(self.directory):
                m = _STEP_RE.match(d)
                # only committed checkpoints: "state" appears by a rename
                if m and os.path.isdir(os.path.join(self.directory, d, "state")):
                    steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------- save

    def save(self, state: TrainState, extra: Optional[dict] = None) -> str:
        step = int(state.step)
        path = self._path(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"state.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({
            "step": step,
            "params": _cpu(state.params),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
        }, os.path.join(tmp, STATE_FILE))
        final = os.path.join(path, "state")
        shutil.rmtree(final, ignore_errors=True)  # a re-save of the same step
        os.replace(tmp, final)
        if extra:
            with open(os.path.join(path, "extra.json"), "w") as f:
                json.dump(extra, f)
        self._rotate()
        return path

    def wait(self) -> None:
        """Saves are synchronous: re-applies the rotation only."""
        self._rotate()

    def _rotate(self) -> None:
        steps = self.all_steps()
        while len(steps) > self.save_total_limit:
            shutil.rmtree(self._path(steps.pop(0)), ignore_errors=True)

    def read_extra(self, step: Optional[int] = None) -> Optional[dict]:
        """Sidecar metadata saved alongside a step (data cursor for resume)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        p = os.path.join(self._path(step), "extra.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    # ---------------------------------------------------------------- restore

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into the template (a freshly built TrainState of the same
        tree): its tensors are overwritten in place, its optimizer and
        scheduler load their saved state, its step is set. Returns it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        device = leaves(template.params)[0].device
        saved = torch.load(os.path.join(self._path(step), "state", STATE_FILE),
                           map_location=device, weights_only=True)
        _copy_into(template.params, saved["params"])
        template.optimizer.load_state_dict(saved["optimizer"])
        template.scheduler.load_state_dict(saved["scheduler"])
        template.step = int(saved["step"])
        return template

