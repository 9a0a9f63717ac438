#!/usr/bin/env python3
"""K9's bf16 kernel (`csrc/scores_segmax.cu`, `scores_segmax_kernel`)
against another checkout's, on one CUDA card: its SASS compared
instruction for instruction, its outputs compared bit for bit on the same
inputs, and both timed in turns (that checkout, this one, this one, that
checkout). Then this checkout's fp32 kernel (`scores_segmax_f32_kernel`)
against the plain version at the same three shapes.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/k9_ab.py build/parent

Both sources are compiled with this checkout's nvcc flags
(`ops/_build.NVCC_FLAGS`) into `build/k9_ab/`, in parallel, and loaded
with ctypes side by side. SASS: `cuobjdump -sass` of each library, the
function named scores_segmax_kernel, its name line dropped (the anonymous
namespace's hash in the name differs between sources) and each run of
blanks taken as one (cuobjdump pads its columns to the file's longest
line): every instruction and its encoding, in order. Both are written to
`build/k9_ab/{that,this}.sass` and their first differences printed.
Outputs: Q 256 against 65,536 unit bf16 rows of 4096 with n_docs 65,000; Q 3; a partial
last segment (N 65,836, n_docs 65,786). Times: CUDA events around 10
calls launched back to back at Q 256 against 2^20 rows (1,000,000 real).
ptxas' registers and spill bytes of each build's kernels are printed.

Output: `ab` JSON lines, then a summary; exits 1 when the SASS or an
output differs, or the fp32 kernel departs from its plain version.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "k9_ab"
F32_ATOL = 1e-5  # exact fp32 products summed in another order, unit rows of 4096


def emit(what: str, value) -> None:
    print("ab " + json.dumps({"what": what, "value": value}), flush=True)


def build(roots) -> dict:
    """{label: library path} of each checkout's scores_segmax.cu, compiled
    in parallel."""
    sys.path.insert(0, str(HERE))
    from gritlm_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, root in roots.items():
        csrc = root / "gritlm_tpu_torch" / "csrc"
        lib = OUT / f"{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib),
               str(csrc / "scores_segmax.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    out = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        out[label] = lib
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{label}] {line.strip()}", flush=True)
    return out


def bf16_sass(lib: Path) -> list:
    """The bf16 kernel's SASS lines, name line dropped."""
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
    names = [n for n in funcs if "scores_segmax_kernel" in n]
    if len(names) != 1:
        raise RuntimeError(f"{lib.name}: scores_segmax_kernel is {names}")
    # cuobjdump pads its columns to the longest line of the whole file, so
    # the runs of blanks are compared as one
    return [" ".join(x.split()) for x in funcs[names[0]] if x.strip()]


def entry(lib: Path):
    from gritlm_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(lib)).gritlm_scores_segmax
    fn.argtypes = [_build.P] * 4 + [_build.I32] * 4 + [_build.P]
    fn.restype = _build.I32
    return fn


def runner(fn, q, emb, n_docs):
    import torch

    from gritlm_tpu_torch.ops import _build

    Q, N = q.shape[0], emb.shape[0]

    def call():
        s = torch.empty((Q, N), dtype=torch.float32, device=q.device)
        m = torch.empty((-(-N // 128), Q), dtype=torch.float32, device=q.device)
        _build.check(fn(q.data_ptr(), emb.data_ptr(), s.data_ptr(), m.data_ptr(), Q, N,
                        q.shape[1], n_docs, _build.stream_of(q)), "K9")
        return s, m

    return call


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("k9_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    libs = build({"that": Path(argv[0]).resolve(), "this": HERE})
    bad = []
    sass = {label: bf16_sass(lib) for label, lib in libs.items()}
    for label, lines in sass.items():
        (OUT / f"{label}.sass").write_text("\n".join(lines) + "\n")
    same_sass = sass["that"] == sass["this"]
    emit("bf16 SASS identical", same_sass)
    if not same_sass:
        import difflib

        diff = list(difflib.unified_diff(sass["that"], sass["this"], "that", "this", n=1,
                                         lineterm=""))
        emit("bf16 SASS lines (that, this), differing", [len(sass["that"]), len(sass["this"]),
                                                         sum(d[:1] in "+-" for d in diff[2:])])
        print("\n".join(diff[:60]), flush=True)
    bad += [] if same_sass else ["SASS"]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit(n, dtype, d=4096):
        x = torch.randn((n, d), generator=gen, device=dev)
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    fns = {label: entry(lib) for label, lib in libs.items()}
    for dtype in (torch.bfloat16, torch.float32):
        q, emb = unit(256, dtype), unit(65536 + 300, dtype)
        cases = (("Q256 N65536 n_docs 65000", q, emb[:65536], 65000),
                 ("Q3 N65536", q[:3], emb[:65536], 65536),
                 ("Q256 N65836 partial last segment", q, emb, 65536 + 250))
        for label, qq, ee, nd in cases:
            if dtype == torch.bfloat16:
                a, b = runner(fns["that"], qq, ee, nd)(), runner(fns["this"], qq, ee, nd)()
                equal = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                emit(f"bf16 outputs bit-equal [{label}]", equal)
                bad += [] if equal else [f"bf16 {label}"]
                continue
            from gritlm_tpu_torch.ops import scores_segmax as k9

            s, m = k9.scores_segmax(qq, ee, nd)
            s2, m2 = k9.scores_segmax(qq, ee, nd)
            ps, _ = k9.scores_segmax_plain(qq, ee, nd)
            Q, N = s.shape
            ns = -(-N // 128)
            own = F.pad(s, (0, ns * 128 - N), value=float("-inf")).view(Q, ns, 128).amax(-1).T
            err = float((s[:, :nd] - ps[:, :nd]).abs().max())
            ok = (err <= F32_ATOL and bool(torch.isneginf(s[:, nd:]).all())
                  and torch.equal(m, own) and torch.equal(s, s2) and torch.equal(m, m2))
            emit(f"f32 [{label}] max abs err, -inf tail, segmax, rerun", [err, ok])
            bad += [] if ok else [f"f32 {label}"]
        del q, emb
    torch.cuda.empty_cache()

    q = unit(256, torch.bfloat16)
    emb = torch.empty((2**20, 4096), dtype=torch.bfloat16, device=dev)
    for a in range(0, 2**20, 65536):
        emb[a:a + 65536] = unit(65536, torch.bfloat16)
    calls = {label: runner(fn, q, emb, 1_000_000) for label, fn in fns.items()}
    order = ("that", "this", "this", "that")
    ms = {label: [] for label in fns}
    for label in order:
        ms[label].append(event_ms(calls[label]))
    emit("bf16 ms at Q256 N2^20 (that, this)", [ms["that"], ms["this"]])
    print(f"summary: bf16 SASS identical {same_sass}; bf16 ms that {min(ms['that']):.4f}, this "
          f"{min(ms['this']):.4f}; failures {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
