#!/usr/bin/env python3
"""K4 and K5 (the flash backward, `csrc/flash_attention_bwd.cu`, bf16 forms)
against another checkout's, on one CUDA card: the SASS of the Dh-128 and
Dh-64 kernels compared instruction for instruction, their outputs compared
bit for bit on the same inputs, and both timed in turns (that checkout,
this one, this one, that checkout) at Dh 128.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/flash_bwd_ab.py build/parent

Both sources are compiled with this checkout's nvcc flags
(`ops/_build.NVCC_FLAGS`) into `build/flash_bwd_ab/`, in parallel, and
loaded with ctypes side by side. The other checkout's entry points may lack
the head-dim argument (before the Dh-64 instances): the script reads
which from the source. SASS: `cuobjdump -sass` of each library, the
functions named flash_bwd_dq_kernel / flash_bwd_dkv_kernel (their <128>
and, where the other checkout has them, <64> instances; the fp32 forms'
flash_bwd_*_f32_kernel are other names), each function's instructions with
its name line dropped. Outputs: K4 and K5 at B 2, S 2048, H 32, Hkv 8
(causal with right padding, bidirectional, causal with a 512 window; and
causal with right padding at Dh 64 where the other checkout has it), K1's
LSE and delta computed once by this checkout's wrappers. Times: CUDA events around 20
calls launched back to back at the passage shape (B 8, S 2048,
bidirectional) and the generative shape (B 4, S 2048, causal). ptxas'
registers and spill bytes of every K4/K5 instance of both builds are
printed.

Output: `ab` JSON lines, then a summary; exits 1 when the SASS or an
output differs.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "flash_bwd_ab"
KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def emit(what: str, value) -> None:
    print("ab " + json.dumps({"what": what, "value": value}), flush=True)


def build(roots) -> dict:
    """{label: (library path, ptxas log)} of each checkout's
    flash_attention_bwd.cu, compiled in parallel."""
    sys.path.insert(0, str(HERE))
    from gritlm_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, root in roots.items():
        csrc = root / "gritlm_tpu_torch" / "csrc"
        lib = OUT / f"{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib),
               str(csrc / "flash_attention_bwd.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    out = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        out[label] = (lib, log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{label}] {line.strip()}", flush=True)
    return out


def kernel_sass(lib: Path) -> dict:
    """{(kernel, Dh): that instance's SASS lines, name line dropped}, for the
    Dh-128 instances (or a build without instances) and the Dh-64 ones."""
    from gritlm_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line.rstrip())
    out = {}
    for kernel in KERNELS:
        names = [n for n in funcs if kernel in n and ("ILi128E" in n or "ILi" not in n)]
        if len(names) != 1:
            raise RuntimeError(f"{lib.name}: {kernel} at Dh 128 is {names}")
        out[kernel, 128] = [x for x in funcs[names[0]] if x.strip()]
        names = [n for n in funcs if kernel in n and "ILi64E" in n]
        if len(names) == 1:
            out[kernel, 64] = [x for x in funcs[names[0]] if x.strip()]
    return out


def entry_points(lib: Path, with_dh: bool):
    """The two C entry points with their argument types (with or without
    the head-dim argument after Hkv)."""
    from gritlm_tpu_torch.ops import _build

    so = ctypes.CDLL(str(lib))
    P, I32, I64, F32 = _build.P, _build.I32, _build.I64, _build.F32
    ints = 6 if with_dh else 5
    dq, dkv = so.gritlm_flash_bwd_dq, so.gritlm_flash_bwd_dkv
    dq.argtypes = [P] * 8 + [I32] * ints + [I64] * 9 + [I32] * 3 + [F32, P]
    dkv.argtypes = [P] * 9 + [I32] * ints + [I64] * 9 + [I32] * 3 + [F32, P]
    dq.restype = dkv.restype = I32
    return dq, dkv


def runner(fns, with_dh: bool, q, k, v, mask, do, lse, delta, causal: bool, window: int):
    """A call of K4 then K5 into fresh outputs through one library's entry
    points; returns (dq, dk, dv)."""
    import torch

    from gritlm_tpu_torch.ops import _build

    dq_fn, dkv_fn = fns
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dims = (B, Sq, Sk, H, Hkv) + ((Dh,) if with_dh else ())
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               mask.stride(0), do.stride(0), do.stride(1))
    tail = dims + strides + (int(causal), window, 0, Dh ** -0.5, _build.stream_of(q))
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())

    def call():
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _build.check(dq_fn(*head, dq.data_ptr(), *tail), "K4")
        _build.check(dkv_fn(*head, dk.data_ptr(), dv.data_ptr(), *tail), "K5")
        return dq, dk, dv

    return call


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    other = Path(sys.argv[1]).resolve()
    libs = build({"other": other, "this": HERE})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    ok = True
    sass = {label: kernel_sass(lib) for label, (lib, _) in libs.items()}
    for kernel, dh in sass["other"]:
        a, b = sass["other"][kernel, dh], sass["this"].get((kernel, dh))
        same = a == b
        ok &= same
        emit(f"sass {kernel} Dh {dh} identical", same)
        print(f"sass {kernel} [Dh {dh}]: {len(b or [])} lines, identical to the other "
              f"checkout's: {same}", flush=True)

    from gritlm_tpu_torch.ops import flash_attention as fa

    src = (other / "gritlm_tpu_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    with_dh = {"other": "int Dh" in src, "this": True}
    fns = {label: entry_points(lib, with_dh[label]) for label, (lib, _) in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def inputs(B, S, causal, window, pad, Dh=128):
        q, k, v, do = randn(B, S, 32, Dh), randn(B, S, 8, Dh), randn(B, S, 8, Dh), \
            randn(B, S, 32, Dh)
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if pad:
            mask[-1, S * 3 // 4:] = 0
        out, lse = fa.flash_attention(q, k, v, mask, causal=causal, sliding_window=window or None,
                                      return_lse=True)
        return q, k, v, mask, do, lse, fa.attention_delta(out, do)

    cases = [("causal, right padding", True, 0, 128), ("bidirectional, padding", False, 0, 128),
             ("causal, window 512", True, 512, 128)]
    if ("flash_bwd_dq_kernel", 64) in sass["other"]:
        cases.append(("causal, right padding", True, 0, 64))
    for label, causal, window, dh in cases:
        args = inputs(2, 2048, causal, window, True, dh)
        got = {name: runner(fns[name], with_dh[name], *args, causal, window)()
               for name in fns}
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(got["other"], got["this"]))
        ok &= equal
        emit(f"outputs Dh {dh} [{label}] bit-equal", equal)
        print(f"outputs [{label}, B2 S2048 H32 Hkv8 Dh{dh}]: dq, dk, dv bit-equal to the other "
              f"checkout's: {equal}", flush=True)

    for label, B, causal in (("B8 S2048 bidirectional", 8, False), ("B4 S2048 causal", 4, True)):
        args = inputs(B, 2048, causal, 0, False)
        calls = {name: runner(fns[name], with_dh[name], *args, causal, 0) for name in fns}
        ms = {name: [] for name in fns}
        for name in ("other", "this", "this", "other"):
            for _ in range(3):
                calls[name]()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                calls[name]()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / 20)
        for name, xs in ms.items():
            emit(f"K4 + K5 Dh 128 [{label}] {name}", xs)
        print(f"time K4 + K5 [{label}, Dh 128]: other {statistics.median(ms['other']):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ms['other'])}), this "
              f"{statistics.median(ms['this']):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ms['this'])})", flush=True)
    print(f"flash_bwd_ab: {'identical' if ok else 'DIFFERENT'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
