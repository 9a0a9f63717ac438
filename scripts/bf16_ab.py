#!/usr/bin/env python3
"""The bf16 forms of K1, K2, K3 and K8 against another checkout's, on one
CUDA card: every kernel function of that checkout's `flash_attention.cu`,
`fused_pool.cu`, `decode_attention.cu` and `paged_attention.cu` compared
instruction for instruction with this checkout's function of the same
name, and the bf16 wrappers' outputs on fixed seeded inputs compared bit
for bit between the two builds (this checkout's Python wrappers over each
build's library). It holds the bf16 forms still while fp32 forms are added
beside them in the same sources.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/bf16_ab.py build/parent

Both checkouts' sources are compiled with this checkout's nvcc flags
(`ops/_build.NVCC_FLAGS`) into `build/bf16_ab/`, all in parallel. SASS:
`cuobjdump -sass` of each library; a function's name is taken with the
anonymous namespace's hash removed (it differs between sources) and its
lines with each run of blanks as one (cuobjdump pads its columns to the
file's longest line). Outputs: the sha256 of each case's output bytes
(`digests`), each build's in a process of its own (`--digests LABEL`):
the static locals of the kernels' template launchers are process-wide
symbols, so two builds of one source in one process share them and the
second skips its shared-memory attribute. `BF16_DIGESTS` holds the digests
of the parent commit's kernels on an NVIDIA H100 80GB HBM3, which
`tests/test_torch_gpu.py` checks.

Output: `ab` JSON lines, then a summary; exits 1 when a function's SASS
differs or is missing, or an output differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "bf16_ab"
SOURCES = ("flash_attention", "fused_pool", "decode_attention", "paged_attention")

# sha256 of the bf16 outputs of `digests` from the parent commit's kernels
# (NVIDIA H100 80GB HBM3)
BF16_DIGESTS = {
    "K1 Dh128 causal +LSE":
        "853662e23c7c6e8af48294445fdcf0ce628cb00e643fdc954dd782a11a7e7db5",
    "K1 Dh128 bidirectional":
        "8760f2f0710eaf9df071d0a7cdde06e36ebb8f7cef8a307bb1dbcdf884ca7bb3",
    "K1 Dh64 causal +LSE":
        "6684b6eb48b37395fbf18fc1673fbf5b461fcfbbeab94462aebdaafd2d689607",
    "K1 Dh64 bidirectional":
        "75efaa597cf05a156e7e78557cf27eaf7441b134c21a43246528879ade06a059",
    "K1 Dh96 causal +LSE":
        "a0cd8bc5446146d4a2ce7066a9db26d47c45ccd06e74b1c287af14f286c6f0aa",
    "K1 Dh96 bidirectional":
        "2da27f151ee4311621ab891c5d953c5e87e54fd54cb38d01aaa0426a7bb967c5",
    "K2 mean":
        "5d01cd84f578317e4bae0d018e7f069a2d7dd7ee40d05578ad19feff376d1f4e",
    "K2 weightedmean":
        "ad48d187b251daf8354f391ff08db6efebd3ce4b5066b7f300d829de196a73f2",
    "K3 bf16 Sq1":
        "02f056805ef51aa6489ad978b193c244eeb7c2191e385dc66c63b4f95cce12ca",
    "K8 bf16 Sq1":
        "02f056805ef51aa6489ad978b193c244eeb7c2191e385dc66c63b4f95cce12ca",
    "K3 bf16 Sq8":
        "8d483a6eade86dfd6e38c5d79e2b441b8f316ac833cc40ffe96c06fa4965917a",
    "K8 bf16 Sq8":
        "8d483a6eade86dfd6e38c5d79e2b441b8f316ac833cc40ffe96c06fa4965917a",
    "K3 int8 Sq1":
        "293bf193142f95280d45c293b3680f422382a679c5e1971fa536b3ba8070e866",
    "K8 int8 Sq1":
        "293bf193142f95280d45c293b3680f422382a679c5e1971fa536b3ba8070e866",
    "K3 int8 Sq8":
        "649ae7f49dde4e55d65770a156198624ca912807009af03b63b6218409c6ebd7",
    "K8 int8 Sq8":
        "649ae7f49dde4e55d65770a156198624ca912807009af03b63b6218409c6ebd7",
}


def emit(what: str, value) -> None:
    print("ab " + json.dumps({"what": what, "value": value}), flush=True)


def build(roots) -> dict:
    """{(label, source): library path}, every source of every checkout
    compiled in parallel."""
    sys.path.insert(0, str(HERE))
    from gritlm_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, root in roots.items():
        csrc = root / "gritlm_tpu_torch" / "csrc"
        for src in SOURCES:
            lib = OUT / f"{label}_{src}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib),
                   str(csrc / f"{src}.cu")]
            procs[label, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = lib
    return out


def sass(lib: Path) -> dict:
    """{function name without the anonymous namespace's hash: its SASS
    lines}."""
    from gritlm_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"\d*_GLOBAL__N__\w*?_cu_[0-9a-f]+", "ANON", m.group(1))
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(" ".join(line.split()))
    return funcs


def digests(dev) -> dict:
    """{case: sha256 of the output bytes} of the bf16 wrappers on fixed
    seeded inputs: K1 (Dh 128 and 64, causal with its LSE; Dh 96 through
    the pad), K2 (mean and weightedmean), K3 (the serving call, bf16 and
    int8 caches; the verify chunk's [B] offsets) and K8 (Sq 1 and 8, bf16
    and int8 pages)."""
    import torch

    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import decode_attention, flash_attention, fused_pool
    from gritlm_tpu_torch.ops import paged_attention

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def sha(fn) -> str:
        """The digest of fn()'s outputs, or the error it raised."""
        try:
            ts = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            return f"error: {e}"
        h = hashlib.sha256()
        for t in (ts if isinstance(ts, tuple) else (ts,)):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for Dh in (128, 64, 96):
        q, k, v = randn(2, 200, 8, Dh), randn(2, 333, 2, Dh), randn(2, 333, 2, Dh)
        mask = torch.ones((2, 333), dtype=torch.int32, device=dev)
        mask[1, 290:] = 0
        out[f"K1 Dh{Dh} causal +LSE"] = sha(lambda: flash_attention.flash_attention(
            q, k, v, mask, causal=True, return_lse=True))
        out[f"K1 Dh{Dh} bidirectional"] = sha(lambda: flash_attention.flash_attention(
            q, k, v, mask, causal=False))
    hidden, gamma = randn(8, 512, 4096), (1 + 0.5 * randn(4096).float()).to(torch.bfloat16)
    pmask = (torch.rand((8, 512), generator=gen, device=dev) < 0.9).int()
    pmask[2] = 0
    for method in ("mean", "weightedmean"):
        out[f"K2 {method}"] = sha(lambda: fused_pool.fused_norm_mean_pool(
            hidden, gamma, pmask, eps=1e-5, method=method))
    L, B, H, Hkv, page, maxp = 2, 8, 32, 8, 256, 16
    Smax = page * maxp
    k, v = randn(L, B, Smax, Hkv * 128), randn(L, B, Smax, Hkv * 128)
    k8, ks = quantize_kv(k.view(L * B, Smax, Hkv, 128))
    v8, vs = quantize_kv(v.view(L * B, Smax, Hkv, 128))
    caches = {"bf16": (k, v, {}), "int8": (k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1), {
        "k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
        "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()})}
    lens = torch.tensor([37, 1900, 256, 700, 1333, 3000, 9, 512], device=dev)
    mask = (torch.arange(Smax, device=dev)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).view(B, maxp).flip(1).contiguous()
    for kind, (kc, vc, sc) in caches.items():
        for Sq in (1, 8):
            q = randn(B, Sq, H, 128)
            kw = dict(causal=False) if Sq == 1 else dict(causal=True,
                                                         offset=(lens - Sq).to(torch.int32))
            out[f"K3 {kind} Sq{Sq}"] = sha(lambda: decode_attention.flash_decode(
                q, kc, vc, mask, layer=1, num_kv_heads=Hkv, **kw, **sc))
            # the same cache as pages: logical page j of row b is pool page pt[b, j]
            inv = torch.empty(B * maxp, dtype=torch.long, device=dev)
            inv[pt.long().reshape(-1)] = torch.arange(B * maxp, device=dev)
            kp = kc.view(L, B * maxp, page, -1)[:, inv].contiguous()
            vp = vc.view(L, B * maxp, page, -1)[:, inv].contiguous()
            psc = {n: s.view(L, B, Hkv, maxp, page).transpose(2, 3).reshape(
                L, B * maxp, Hkv, page)[:, inv].contiguous() for n, s in sc.items()}
            out[f"K8 {kind} Sq{Sq}"] = sha(lambda: paged_attention.paged_decode(
                q, kp, vp, pt, mask, layer=1, num_kv_heads=Hkv, **kw, **psc))
    torch.cuda.synchronize()
    return out


def own_digests(label: str) -> int:
    """Print the digests of the build `label` (its libraries from
    build/bf16_ab/) as one JSON line."""
    import torch

    sys.path.insert(0, str(HERE))
    from gritlm_tpu_torch.ops import _build

    for src in SOURCES:
        _build._libs[src] = ctypes.CDLL(str(OUT / f"{label}_{src}.so"))
    print(json.dumps(digests(torch.device("cuda"))), flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--digests":
        return own_digests(argv[1])
    if len(argv) != 1:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    libs = build({"that": Path(argv[0]).resolve(), "this": HERE})
    bad = []
    for src in SOURCES:
        that, this = sass(libs["that", src]), sass(libs["this", src])
        same = [n for n in that if this.get(n) == that[n]]
        differ = [n for n in that if n not in same]
        emit(f"{src}: bf16 functions with identical SASS", [len(same), len(that)])
        emit(f"{src}: functions added", len(set(this) - set(that)))
        if differ:
            emit(f"{src}: differing or missing", differ[:8])
            bad.append(src)

    got = {}
    for label in ("that", "this"):
        out = subprocess.run([sys.executable, __file__, "--digests", label], capture_output=True,
                             text=True, check=True).stdout
        got[label] = json.loads(out.strip().splitlines()[-1])
    for case, h in got["this"].items():
        same = got["that"][case] == h and not h.startswith("error")
        emit(f"outputs bit-equal [{case}]", same)
        if not same:
            bad.append(case)
    print("BF16_DIGESTS (that) = " + json.dumps(got["that"], indent=1), flush=True)
    if BF16_DIGESTS and BF16_DIGESTS != got["that"]:
        emit("BF16_DIGESTS match the other checkout's outputs", False)
        bad.append("BF16_DIGESTS")
    print(f"summary: {'ok' if not bad else 'FAILED ' + ', '.join(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
