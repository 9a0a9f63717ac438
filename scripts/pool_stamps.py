#!/usr/bin/env python3
"""Where the time of K2 (`fused_norm_mean_pool`, csrc/fused_pool.cu) goes,
phase by phase, on one CUDA card.

    python3 scripts/pool_stamps.py

Builds a copy of csrc/fused_pool.cu into build/pool_stamps/ with thread 0
of every block writing the card's %globaltimer (ns) into a device array at
each phase boundary, swaps it in for the kernel, and runs one cold call
(the L2 flushed first by a 64 MB write) at chip_smoke's pool cases (B 8
S 512, B 64 S 128, B 1 S 4096; D 4096). For each phase it prints the
microseconds since the first block started: the least, the median and the
largest over the blocks that reached it. Phases, in order:
  start       the block runs (mbarriers initialised)
  mask        the mask's bits are in shared memory
  list        the block's rank list is written
  first row   the first row's data and factor are ready
  stream      the block's rows are all summed
  cluster     the cluster's barrier before the merge through distributed
              shared memory is passed
  slice       the block's slice of the cluster partial is stored
  arrived     the row's last block is past its arrival (last blocks only)
  merged      the row's partials are summed (last blocks only)
  end         the row's result is written (the blocks that write it)
The stamps cost a global store a phase; the printed timing of the stamped
kernel (CUDA graph replays, warm) is its own, not the kernel's. Beside it,
a yardstick: a PyTorch clone of the same hidden state, cold (copies of it
cycled), in TB/s read and written.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "pool_stamps"
SLOTS = 16
NAMES = ("start", "mask", "list", "first row", "stream", "cluster", "slice", "arrived",
         "merged", "end")


def stamp(i: int) -> str:
    return ("\n  if (tid == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
            f" : \"=l\"(t_)); pool_stamps[blockIdx.x * {SLOTS} + {i}] = t_; }}\n")


# (text in csrc/fused_pool.cu, where the stamp goes, phase index in NAMES)
POINTS = (
    ("  const uint32_t row_bytes = (uint32_t)D * 2;\n", "after", 0),
    ("\n  // 2. prefix counts", "before", 1),
    ("  sm90::fence_proxy_async();  // the mask's bytes are the ring's next\n  __syncthreads();\n",
     "after", 2),
    ("      const float f = fac[st];\n", "first", 3),
    ("  __syncthreads();  // every row read: the ring's bytes hold the block's partial next\n",
     "after", 4),
    ("  cluster.sync();\n  const int per", "cluster", 5),
    ("  __syncthreads();  // the block's slice stored\n", "after", 6),
    ("  if (!last) return;\n", "after", 7),
    ("  const float inv = a.normalized", "before", 8),
    ("    return;\n  }\n  __syncthreads();  // the block's slice stored", "whole", 9),
    ("  }\n}\n\n// The ring and", "end", 9),
)


def stamped_source(src: str) -> str:
    for text, how, i in POINTS:
        if src.count(text) != 1:
            raise SystemExit(f"pool_stamps: {text!r} is not once in csrc/fused_pool.cu")
        new = {
            "after": text + stamp(i),
            "before": stamp(i) + text,
            "cluster": "  cluster.sync();\n" + stamp(i) + "  const int per",
            "first": "      if (j == 0) {" + stamp(i) + "}\n" + text,
            "whole": stamp(i) + text,
            "end": "  }\n" + stamp(i) + "}\n\n// The ring and",
        }[how]
        src = src.replace(text, new)
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n"
                      f"__device__ unsigned long long pool_stamps[65536 * {SLOTS}];")
    return src + f"""
extern "C" int pool_read_stamps(void* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, pool_stamps, n * sizeof(unsigned long long));
}}
extern "C" int pool_clear_stamps() {{
  static unsigned long long zero[65536 * {SLOTS}];
  return (int)cudaMemcpyToSymbol(pool_stamps, zero, sizeof(zero));
}}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pool_stamps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gritlm_tpu_torch.ops import _build
    from gritlm_tpu_torch.ops import fused_pool as fp

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    for f in _build.CSRC.iterdir():
        shutil.copy(f, WORK / f.name)
    cu = WORK / "fused_pool.cu"
    cu.write_text(stamped_source(cu.read_text()))
    lib_path = WORK / "libpool_stamps.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{WORK}", "-o", str(lib_path),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        print(out.stdout, out.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    _build._libs["fused_pool"] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for B, S in ((8, 512), (64, 128), (1, 4096)):
        hidden, gamma, mask = cs.pool_case(dev, randn, B, S, 4096)
        K, CL, need, balanced = fp.pool_plan(B, S, _build.sm_count(dev),
                                             fit=lambda cl, bal: fp._fit(dev, B, S, 4096, cl, bal))
        blocks = K * CL
        for _ in range(3):
            fp.fused_norm_mean_pool(hidden, gamma, mask, eps=1e-5)
        for trial in range(2):
            lib.pool_clear_stamps()
            flush.zero_()
            torch.cuda.synchronize()
            fp.fused_norm_mean_pool(hidden, gamma, mask, eps=1e-5)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (blocks * SLOTS))()
            lib.pool_read_stamps(buf, blocks * SLOTS)
            t = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, SLOTS).astype(np.int64)
            t0 = t[:, 0].min()
            print(f"B{B} S{S}: {K} clusters of {CL} (need {need}, balanced {balanced}), "
                  f"trial {trial}: us since the first block started, min / median / max "
                  f"over the blocks", flush=True)
            for i, name in enumerate(NAMES):
                col = t[:, i][t[:, i] > 0]
                if len(col):
                    d = (col - t0) / 1e3
                    print(f"  {name:10s} {len(col):5d} blocks {d.min():8.2f} {np.median(d):8.2f} "
                          f"{d.max():8.2f}", flush=True)
        warm = cs.graph_ms(lambda: fp.fused_norm_mean_pool(hidden, gamma, mask, eps=1e-5),
                           calls=10)
        copies = [hidden] + [randn(*hidden.shape)
                             for _ in range(cs.cold_copies(cs.nbytes(hidden)) - 1)]
        clone = cs.graph_ms(lambda: [h.clone() for h in copies]) / len(copies)
        rows = int(mask.sum())
        print(f"  the stamped kernel, warm: {warm * 1e3:.2f} us a call; yardstick: a PyTorch "
              f"clone of the hidden state, cold, {clone * 1e3:.2f} us = "
              f"{2 * cs.nbytes(hidden) / clone / 1e9:.2f} TB/s read and written; the "
              f"{rows} masked-in rows are {rows * 4096 * 2 / 1e6:.1f} MB", flush=True)
        del hidden, copies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
