#!/usr/bin/env python3
"""The port's decode-path kernels and K2 timed against another checkout's,
on one CUDA card, in turns: that checkout, this one, this one, that checkout.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 scripts/kernel_ab.py build/parent [--only decode,quant,chunk,pool]

Each turn is its own process with its checkout's `gritlm_tpu_torch` first
on sys.path, so each runs its own kernels and wrappers through the public
functions (`paged_decode`, `flash_decode`, `w8a16_matmul`, `w4a16_matmul`,
`ServingEngine`); the timing helpers come from this checkout's
`chip_smoke.py` and are the same for both. Both checkouts' kernels are
built first, in parallel, each into its own `build/`, and the registers
and spill bytes ptxas reports for the decode kernels are printed.

Measured in every turn (NVIDIA card named on the first line), device ms by
CUDA events around CUDA graph replays:
  - K8 at chip_smoke's four K8_SHAPES (B 8, page 256, SERVING_LENS; bf16
    and int8 pages; Sq 1 and the causal Sq 8 chunk at per-row offsets),
    cold (each call on its own layer of a pool larger than L2), with the
    device operations a call;
  - K3 at Sq 1 B 4 (1400 of 2048 slots), bf16 and int8, and at the
    serving shape, cold;
  - K6 and K7 at M 8 on Mistral-7B's five projections, and K6 at gate/up
    at M 1, 16, 64, 128, 256 and 512, over weight copies kept out of L2;
  - the decode chunk of a full-width Mistral-7B ServingEngine (8 rows, 16
    steps) with a paged bf16 pool and a dense one: device ms a step by
    torch.profiler (chip_smoke.profile_decode_chunk);
  - K2 (`fused_norm_mean_pool`) at chip_smoke's pool cases (B 8 S 512 mean
    and weightedmean, B 1 S 4096, B 64 S 128, B 8 S 64; D 4096), cold (each
    call on its own copy of the hidden state, cold_copies of them), with
    the device operations a call.
`--only` keeps the named groups (decode, quant, chunk, pool).
In this checkout's turns also K6's two kernels forced on every row count
(the rows kernel against the staged template at M 1-512, gate/up), the
rows kernel's split counts at M 8 on each projection, and at M 8 a variant
of K6 built from this checkout's source with the bf16x2 pack done by
`cvt.rn.bf16x2.f32` instead of a byte permute.

Output: one `ab` JSON line per measurement and turn, then a table of the
medians, the other checkout first.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
QUANT_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000))
GATE_UP = (4096, 14336)
K6_ROWS = (1, 8, 16, 64, 80, 96, 112, 128, 256, 512)
# K6's variant: the two floats' upper halves packed by cvt.rn.bf16x2.f32
# instead of a byte permute (exact either way: the floats are integers
# that bf16 holds)
PACK_PERMUTE = "  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);"
PACK_CVT = ('  uint32_t r;\n  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(r) : "f"(b), "f"(a));\n'
            "  return r;")
VARIANT = HERE / "build" / "kernel_ab" / "quant_matmul_cvt.so"
PTXAS_SOURCES = ("decode_attention", "paged_attention", "quant_matmul", "fused_pool")
GROUPS = ("decode", "quant", "chunk", "pool")
POOL_CASES = ((8, 512, "mean"), (8, 512, "weightedmean"), (1, 4096, "mean"), (64, 128, "mean"),
              (8, 64, "mean"))


def emit(what: str, ms) -> None:
    print("ab " + json.dumps({"what": what, "ms": ms}), flush=True)


def build(root: Path, groups=GROUPS) -> None:
    """Build root's kernels (and, for this checkout when K6 is measured,
    K6's cvt variant into VARIANT); print the measured kernels' ptxas lines."""
    sys.path.insert(0, str(root))
    from gritlm_tpu_torch.ops import _build

    logs = _build.build_all()
    if root == HERE and "quant" in groups:
        src = (_build.CSRC / "quant_matmul.cu").read_text()
        if src.count(PACK_PERMUTE) != 1:
            raise SystemExit("kernel_ab: K6's byte-permute pack not found in quant_matmul.cu")
        VARIANT.parent.mkdir(parents=True, exist_ok=True)
        cu = VARIANT.with_suffix(".cu")
        cu.write_text(src.replace(PACK_PERMUTE, PACK_CVT))
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
                              str(VARIANT), str(cu)], capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"kernel_ab: the cvt variant did not build:\n{out.stdout}{out.stderr}")
        logs["quant_matmul (cvt variant)"] = out.stdout + out.stderr
    for name, log in logs.items():
        if name.split()[0] not in PTXAS_SOURCES:
            continue
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas[{root.name}:{name}] {line.strip()}", flush=True)


def decode_times(cs, dev, gen) -> None:
    """K8 at the four K8_SHAPES and K3 at three shapes, cold."""
    import torch

    from gritlm_tpu_torch.ops import decode_attention as da
    from gritlm_tpu_torch.ops import paged_attention as pa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B, H, Hkv, Dh = 8, 32, 8, 128
    lens = sum(cs.SERVING_LENS)
    for Sq, quant in cs.K8_SHAPES:
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * 2
        L = cs.cold_copies(lens * per_slot * 2)
        pt, mask, bf16_pages, int8_pages, scales = cs.paged_pool(dev, randn, L)
        kp, vp = int8_pages if quant else bf16_pages
        _, offs = cs.k8_keep(mask, Sq)
        q = randn(B, Sq, H, Dh)
        kw = dict(num_kv_heads=Hkv, causal=Sq > 1, offset=0 if offs is None else offs,
                  **(scales if quant else {}))
        label = f"K8 {'int8' if quant else 'bf16'} Sq{Sq}"
        emit(label, cs.graph_ms(lambda: [pa.paged_decode(q, kp, vp, pt, mask, layer=i, **kw)
                                         for i in range(L)]) / L)
        emit(f"{label} device operations a call",
             cs.kernels_per_call(lambda: pa.paged_decode(q, kp, vp, pt, mask, layer=0, **kw))[1])
        del bf16_pages, int8_pages, kp, vp, scales
        torch.cuda.empty_cache()

    from gritlm_tpu_torch.models.transformer import quantize_kv

    mask_d = (torch.arange(2048, device=dev) < 1500).int()[None].repeat(4, 1)
    mask_d[:, 600:700] = 0
    for label, mask, causal, offset, quant in (
            ("K3 Sq1 B4 1400 valid", mask_d, True, 1499, False),
            ("K3 int8 Sq1 B4 1400 valid", mask_d, True, 1499, True),
            ("K3 serving B8", cs.serving_mask(dev), False, 0, False)):
        Bq, Smax = mask.shape
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * 2
        L = cs.cold_copies(int(mask.sum()) * per_slot * 2)  # the valid slots' K and V
        k_all, v_all = randn(L, Bq, Smax, Hkv * Dh), randn(L, Bq, Smax, Hkv * Dh)
        scales = {}
        if quant:
            k8, ks = quantize_kv(k_all.view(L * Bq, Smax, Hkv, Dh))
            v8, vs = quantize_kv(v_all.view(L * Bq, Smax, Hkv, Dh))
            k_all, v_all = k8.view(L, Bq, Smax, -1), v8.view(L, Bq, Smax, -1)
            scales = {"k_scale": ks.view(L, Bq, Smax, Hkv).transpose(2, 3).contiguous(),
                      "v_scale": vs.view(L, Bq, Smax, Hkv).transpose(2, 3).contiguous()}
        q = randn(Bq, 1, H, Dh)
        emit(label, cs.graph_ms(lambda: [da.flash_decode(
            q, k_all, v_all, mask, causal=causal, offset=offset, layer=i, num_kv_heads=Hkv,
            **scales) for i in range(L)]) / L)
        del k_all, v_all, scales
        torch.cuda.empty_cache()


def quant_times(cs, dev, gen) -> None:
    """K6/K7 at M 8 on the five projections, K6 at gate/up over K6_ROWS;
    with this checkout's wrappers also K6's two kernels forced and the
    rows kernel's split counts."""
    import torch

    from gritlm_tpu_torch.ops import _build
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.training import quant

    forced = hasattr(qm, "plan_rows")  # this checkout's K6: a rows kernel and a staged one
    sms = _build.sm_count(dev) if forced else None
    for K, N in QUANT_SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
        for name, node, kern in (("K6", quant.quantize_kernel(w), qm.w8a16_matmul),
                                 ("K7", quant.quantize_kernel_int4(w), qm.w4a16_matmul)):
            nodes = [node] + [{k: v.clone() for k, v in node.items()}
                              for _ in range(cs.cold_copies(cs.nbytes(*node.values())) - 1)]
            rows = K6_ROWS if (name == "K6" and (K, N) == GATE_UP) else (8,)
            for M in rows:
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                emit(f"{name} M{M} K{K} N{N}",
                     cs.graph_ms(lambda: [kern(x, nd) for nd in nodes]) / len(nodes))
                if name != "K6" or not forced:
                    continue
                fn = qm._fn("gritlm_w8a16_matmul")

                def launch(planned, x=x):
                    return [qm._launch(fn, "K6", x, nd["q8"], nd["scale"], M, K, N, planned)
                            for nd in nodes]

                if (K, N) == GATE_UP:
                    for route, planned in (
                            ("rows kernel", qm.plan_rows(M, -(-K // qm.W8_STAGE), N, sms,
                                                    qm.W8_SPLIT_BLOCKS_PER_SM)),
                            ("staged template", qm.plan(M, -(-K // qm.DK), N, sms))):
                        emit(f"K6 M{M} K{K} N{N} {route}", cs.graph_ms(lambda: launch(planned))
                             / len(nodes))
                if M == 8:
                    stages = -(-K // qm.W8_STAGE)
                    for splits in (1, 2, 4, 8, 16, 32):
                        kper = -(-stages // splits)
                        planned = (8, -(-stages // kper), kper)
                        emit(f"K6 M8 K{K} N{N} rows kernel, {planned[1]} splits",
                             cs.graph_ms(lambda: launch(planned)) / len(nodes))
                if forced and M == 8 and VARIANT.exists():  # the cvt pack, same plan
                    import ctypes

                    lib = _build._libs["quant_matmul"]
                    _build._libs["quant_matmul"] = ctypes.CDLL(str(VARIANT))
                    emit(f"K6 M8 K{K} N{N} cvt pack",
                         cs.graph_ms(lambda: [kern(x, nd) for nd in nodes]) / len(nodes))
                    _build._libs["quant_matmul"] = lib
            del nodes
        del w
        torch.cuda.empty_cache()


def chunk_times(cs, dev) -> None:
    """Device ms a step of the serving decode chunk at B = 8, paged bf16
    and dense bf16 pools, full-width Mistral-7B with random weights."""
    import numpy as np
    import torch

    from gritlm_tpu_torch import GritLM, serving
    from gritlm_tpu_torch.config import mistral_7b
    from gritlm_tpu_torch.serving import ServingEngine

    model = GritLM(mistral_7b(), seed=0)
    cfg, tok = model.config, model.tokenizer
    rng = np.random.default_rng(0)  # chip_smoke.serving_workload's prompts
    specs = [(f"g{i}", rng.integers(3, cfg.vocab_size, size=int(n)).tolist(), int(m))
             for i, (n, m) in enumerate(zip(rng.integers(32, 1901, 24),
                                            rng.integers(8, 65, 24)))]
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=dev)
    for label, extra in (("paged bf16", dict(paged=True, page_size=256)), ("dense bf16", {})):
        eng = ServingEngine(cfg, model.params, **extra, **kw)
        step = cs.profile_decode_chunk(label, eng, serving._decode_chunk_program, specs)
        emit(f"serving chunk {label}, device ms a step", None if step is None else step[0])
        del eng
        torch.cuda.empty_cache()


def pool_times(cs, dev, gen) -> None:
    """K2 at POOL_CASES, cold, with its device operations a call."""
    import torch

    from gritlm_tpu_torch.ops import fused_pool as fp

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for B, S, method in POOL_CASES:
        hidden, gamma, mask = cs.pool_case(dev, randn, B, S, 4096)
        copies = [hidden] + [randn(*hidden.shape)
                             for _ in range(cs.cold_copies(cs.nbytes(hidden)) - 1)]
        kw = dict(eps=1e-5, method=method)
        label = f"K2 {method} B{B} S{S}"
        emit(label, cs.graph_ms(lambda: [fp.fused_norm_mean_pool(h, gamma, mask, **kw)
                                         for h in copies]) / len(copies))
        emit(f"{label} device operations a call",
             cs.kernels_per_call(lambda: fp.fused_norm_mean_pool(hidden, gamma, mask, **kw))[1])
        del hidden, copies
        torch.cuda.empty_cache()


def turn(root: Path, groups=GROUPS) -> None:
    """One checkout's measurements (its package first on sys.path)."""
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import gritlm_tpu_torch

    print(f"turn {root}: {gritlm_tpu_torch.__file__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    if "decode" in groups:
        decode_times(cs, dev, gen)
    if "quant" in groups:
        quant_times(cs, dev, gen)
    if "chunk" in groups:
        chunk_times(cs, dev)
    if "pool" in groups:
        pool_times(cs, dev, gen)


def main() -> int:
    args = sys.argv[1:]
    groups = GROUPS
    if len(args) >= 2 and args[-2] == "--only":
        groups = tuple(args[-1].split(","))
        args = args[:-2]
        if not set(groups) <= set(GROUPS):
            print(__doc__, file=sys.stderr)
            return 2
    if len(args) == 2 and args[0] in ("--build", "--turn"):
        root = Path(args[1]).resolve()
        (build if args[0] == "--build" else turn)(root, groups)
        return 0
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    if not (other / "gritlm_tpu_torch" / "__init__.py").exists():
        print(f"kernel_ab: no gritlm_tpu_torch in {other}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card {card}", flush=True)
    me = [sys.executable, str(Path(__file__).resolve())]
    only = ["--only", ",".join(groups)]
    builds = [subprocess.Popen(me + ["--build", str(r)] + only) for r in (other, HERE)]
    if any(p.wait() for p in builds):
        return 1
    results = {}  # (what, root) -> [ms]
    for root in (other, HERE, HERE, other):
        out = subprocess.run(me + ["--turn", str(root)] + only, stdout=subprocess.PIPE, text=True,
                             env=dict(os.environ, PYTHONUNBUFFERED="1"))
        for line in out.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("ab "):
                rec = json.loads(line[3:])
                results.setdefault(rec["what"], {}).setdefault(root, []).append(rec["ms"])
        if out.returncode:
            print(f"kernel_ab: the turn of {root} failed ({out.returncode})", file=sys.stderr)
            return 1

    def med(xs):
        xs = [x for x in xs if x is not None]
        return f"{statistics.median(xs):.4f}" if xs else "not measured"

    print(f"\n{'measurement':58s} {other.name:>12s} {'this':>12s}  (ms, median of 2; {card})")
    for what, by_root in results.items():
        print(f"{what:58s} {med(by_root.get(other, [])):>12s} {med(by_root.get(HERE, [])):>12s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
