"""Builds the port's CUDA kernels from `gritlm_tpu_torch/csrc/` at first use.

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface, loaded with `ctypes`. All sources build at once, one
`nvcc` process each, into `build/gritlm_tpu_torch_kernels/` at the root of the
checkout (listed in `.gitignore`). A library's file name carries a hash of its
source, the shared header and the flags, so an edited source is rebuilt and an
unchanged one is reused. nvcc's `-Xptxas -v` report is kept beside each
library (same name, `.ptxas.txt`), and a library without its report is
rebuilt, so the report of the library in use can always be read.

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the plain versions of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gritlm_tpu_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "paged_attention",
           "fused_pool", "scores_segmax", "quant_matmul")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
            "built from gritlm_tpu_torch/csrc at first use"
        )
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _report(name: str) -> Path:
    return _target(name).with_suffix(".ptxas.txt")


def build_all() -> Dict[str, str]:
    """Compile every library that is missing (or lacks its ptxas report),
    all sources in parallel. Returns {source: ptxas report} of every source,
    built now or before. Raises RuntimeError with nvcc's output if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (_target(n).exists() and _report(n).exists())]
    if todo:
        _compile(todo)
    return {n: _report(n).read_text() for n in SOURCES}


def _compile(todo) -> None:
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        # atomic: a concurrent loader never sees half a file; the report
        # lands first, so a library in place always has one
        report = _report(name)
        report_tmp = report.with_name(f"{report.name}.tmp{os.getpid()}")
        report_tmp.write_text(log)
        os.replace(report_tmp, report)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building all sources first if
    any is missing."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError after
    the launch: a refused launch never runs, and a later synchronize would
    not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def plain_path(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when every one lies on a CUDA device (the kernel runs). Anything
    else raises: a CUDA tensor never takes the plain path."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(
        f"tensors on {sorted(kinds)}: a kernel takes CUDA tensors only, "
        "its plain version CPU tensors only"
    )


# a kernel's forms by the dtype of its activations
FORMS = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kernel_form(*tensors, what: str = "kernel") -> str:
    """The form of a kernel a call's activations take: "bf16" when every
    tensor given is bfloat16, "f32" when every one is float32 (None entries
    are skipped). Any other dtype (float16) or a mix raises TypeError: an
    fp32 call is never cast to bf16, nor a bf16 call widened."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) == 1 and next(iter(dtypes)) in FORMS:
        return FORMS[next(iter(dtypes))]
    raise TypeError(f"{what}: {sorted(str(d) for d in dtypes)}: the kernels take all bfloat16 "
                    "or all float32")


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device; kernels size their
    grids (split counts) from it."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


_counters: Dict[torch.device, torch.Tensor] = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of the kernels whose last block (K3, K6, K7,
    K8) or last cluster (K2) merges the others' partial sums: int32, zero
    between launches (the merging block resets its own), so one buffer on a
    device serves every launch as long as launches do not overlap (the port
    launches on one stream); grown on demand, at least 4096."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on t's device (kernels launch
    on it, so they order with PyTorch's own work)."""
    return torch.cuda.current_stream(t.device).cuda_stream


# ctypes argument kinds used by the kernel modules
P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
