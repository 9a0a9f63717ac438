"""The port's profiling helpers (utils/profiling.py) on the CPU: timed's
warm-up, iterations and result, device_sync on CPU tensors and nested
results, and a trace written as a Chrome trace with the annotated region
and the region's operations in it."""

import json

import torch

from gritlm_tpu_torch.utils import profiling


def test_timed_counts_calls_and_returns_the_last_result():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.full((2,), float(len(calls))) * scale

    secs, out = profiling.timed(fn, 3, warmup=2, iters=5, scale=2.0)
    assert len(calls) == 7 and secs >= 0.0
    assert torch.equal(out, torch.full((2,), 14.0))
    secs, out = profiling.timed(lambda: None, warmup=0, iters=1)
    assert out is None and secs >= 0.0


def test_device_sync_on_the_cpu(monkeypatch):
    """A CPU tensor, or a structure holding one, needs no fence: nothing is
    synchronized (the call would raise without a CUDA device)."""
    def no_sync(*a, **k):
        raise AssertionError("synchronize called for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    for x in (torch.ones(3), {"a": [None, (torch.ones(1),)]}, (1, "x"), None):
        profiling.device_sync(x)


def test_device_sync_fences_the_tensors_device(monkeypatch):
    """A CUDA tensor's device is the one synchronized (a stand-in tensor:
    this machine has no card)."""
    seen = []

    class Fake:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(profiling, "_first_tensor", lambda x: Fake())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: seen.append(d))
    profiling.device_sync(object())
    assert seen == [torch.device("cuda", 1)]


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("region of interest"):
            y = x @ x
    assert torch.isfinite(y).all()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "region of interest" in names and "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
