"""ctypes binding of the C++ input pipeline (`native/gritloader.cpp`), the
port of gritlm_tpu.training.native_loader.

JSONL parsing, the GRIT templates, byte tokenization and batch packing run
in a C++ background thread that keeps `prefetch_depth` batches ready, so
the host pipeline overlaps the device's step instead of holding the train
loop on the GIL. It yields the batch dicts of training/data.py's
GritCollator + batch_iterator (numpy int32 ids and masks, int64 labels) for
the byte tokenizer; an HF tokenizer trains through the Python pipeline.

The library is built at first use with g++ (the flags of native/Makefile)
from the checkout's `native/gritloader.cpp` into `build/gritlm_tpu_torch_native/`
at the root of the checkout (git-ignored), under a file name that carries a
hash of the source and the flags: an edited source is rebuilt, an unchanged
one reused. Nothing is written under `native/`. A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "gritloader.cpp"
BUILD_DIR = ROOT / "build" / "gritlm_tpu_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgritloader-{h.hexdigest()[:16]}.so"


def build_library() -> str:
    """The built library's path, compiling it first if it is missing.
    Raises RuntimeError when there is no C++ compiler or the build fails."""
    out = _target()
    if out.exists():
        return str(out)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader is built from "
                           "native/gritloader.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return str(out)


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.gl_create.restype = ctypes.c_void_p
        lib.gl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        for name in ("gl_num_emb", "gl_num_gen", "gl_num_batches"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.gl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.gl_next.restype = ctypes.c_int
        lib.gl_next.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i64p, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.gl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeGritLoader:
    """The training batches of `train_data` (directories of *.jsonl, or
    files): `epoch(e)` yields batch dicts with "query", "passage" (each
    input_ids, attention_mask, instruction_lens) and, when the batch has
    generative samples, "generative" (input_ids, attention_mask, labels).
    `n_emb` / `n_gen` count the samples read; `num_batches()` the batches of
    an epoch."""

    def __init__(
        self,
        train_data: Sequence[str],
        batch_size: int,
        train_group_size: int = 2,
        query_max_len: int = 256,
        passage_max_len: int = 2048,
        generative_max_len: int = 2048,
        seed: int = 42,
        take_nth: int = 1,
        prefetch_depth: int = 4,
        max_char_len: Optional[int] = None,
    ):
        lib = _load()
        files: List[str] = []
        for p in train_data:
            if os.path.isdir(p):
                files.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
            else:
                files.append(p)
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._lib = lib
        self.batch_size = batch_size
        self.group_size = train_group_size
        self.qlen, self.plen, self.glen = query_max_len, passage_max_len, generative_max_len
        self.take_nth = take_nth
        self._h = lib.gl_create(
            arr, len(files), batch_size, train_group_size,
            query_max_len, passage_max_len, generative_max_len,
            seed, take_nth, prefetch_depth,
            max_char_len or max(passage_max_len, generative_max_len) * 10,
        )
        self.n_emb = lib.gl_num_emb(self._h)
        self.n_gen = lib.gl_num_gen(self._h)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Dict[str, np.ndarray]]]:
        lib = self._lib
        lib.gl_start_epoch(self._h, epoch)
        B, G = self.batch_size, self.group_size
        n_gen = -(-B // self.take_nth)  # ceil
        while True:
            q_ids = np.empty((B, self.qlen), np.int32)
            q_mask = np.empty((B, self.qlen), np.int32)
            q_il = np.empty((B,), np.int32)
            p_ids = np.empty((B * G, self.plen), np.int32)
            p_mask = np.empty((B * G, self.plen), np.int32)
            p_il = np.empty((B * G,), np.int32)
            g_ids = np.empty((n_gen, self.glen), np.int32)
            g_mask = np.empty((n_gen, self.glen), np.int32)
            g_labels = np.empty((n_gen, self.glen), np.int64)
            g_count = ctypes.c_int32(0)
            if not lib.gl_next(self._h, q_ids, q_mask, q_il, p_ids, p_mask, p_il,
                               g_ids, g_mask, g_labels, ctypes.byref(g_count)):
                return
            batch = {
                "query": {"input_ids": q_ids, "attention_mask": q_mask,
                          "instruction_lens": q_il},
                "passage": {"input_ids": p_ids, "attention_mask": p_mask,
                            "instruction_lens": p_il},
            }
            n = g_count.value
            if n:
                batch["generative"] = {"input_ids": g_ids[:n], "attention_mask": g_mask[:n],
                                       "labels": g_labels[:n]}
            yield batch

    def num_batches(self) -> int:
        return self._lib.gl_num_batches(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.gl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
