"""Profiling and timing helpers (the port of gritlm_tpu.utils.profiling).

  - trace(log_dir): a torch.profiler region (CPU activity, and CUDA
    activity where the card is there) written as a Chrome trace under
    `log_dir`, the port's counterpart of an xprof trace;
  - annotate(name): a named region in that trace (record_function);
  - timed(fn): seconds a call on the host clock, fenced on the device
    before the clock starts and after it stops;
  - device_sync(x): the fence, torch.cuda.synchronize on the device of the
    first tensor in `x` (nothing for a CPU tensor).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x) -> None:
    """Wait for everything queued on the device that holds `x`'s first
    tensor (a tensor, or a dict / list / tuple holding tensors)."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region: writes `trace.json` (Chrome trace format, CUDA
    kernels included when the card is there) under `log_dir` at exit and
    yields the profiler (its `key_averages()` give the region's totals)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region in the trace."""
    return torch.profiler.record_function(name)


def timed(fn: Callable, *args, warmup: int = 2, iters: int = 10,
          **kwargs) -> Tuple[float, object]:
    """(seconds a call, the last call's result): `warmup` calls, a fence,
    `iters` calls on the host clock, a fence."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    device_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    device_sync(out)
    return (time.perf_counter() - t0) / iters, out
