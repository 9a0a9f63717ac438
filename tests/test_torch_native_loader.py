"""The port's binding of the C++ input pipeline (training/native_loader.py)
against the JAX package's on tests/toy_data: the same batches, bit for bit,
over several epochs and settings; each row what the port's Python collator
makes of the same sample (as tests/test_native_loader.py holds the JAX
binding); the library built from native/gritloader.cpp into build/ under a
hashed name, nothing written under native/."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from gritlm_tpu.training.native_loader import NativeGritLoader as JaxNativeGritLoader
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import native_loader
from gritlm_tpu_torch.training.data import GritCollator, GritDataset, load_train_dirs
from gritlm_tpu_torch.training.native_loader import NativeGritLoader

TOY = os.path.join(os.path.dirname(__file__), "toy_data")
NATIVE = Path(__file__).resolve().parents[1] / "native"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")

SETTINGS = {
    "group 1": dict(batch_size=4, train_group_size=1, query_max_len=128, passage_max_len=128,
                    generative_max_len=96, seed=3),
    "group 3, take_nth 2": dict(batch_size=3, train_group_size=3, query_max_len=64,
                                passage_max_len=96, generative_max_len=48, seed=11,
                                take_nth=2),
}


@pytest.fixture(scope="module")
def loader():
    return NativeGritLoader([TOY], **SETTINGS["group 1"])


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), b
        for part in w:
            assert set(g[part]) == set(w[part]), (b, part)
            for k, arr in w[part].items():
                assert g[part][k].dtype == arr.dtype and g[part][k].shape == arr.shape
                np.testing.assert_array_equal(g[part][k], arr, err_msg=f"{b} {part} {k}")


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_batches_equal_the_jax_loaders(setting):
    """Three epochs (each reseeded from the seed and the epoch), every array
    equal in dtype, shape and value."""
    kw = SETTINGS[setting]
    port, jax_loader = NativeGritLoader([TOY], **kw), JaxNativeGritLoader([TOY], **kw)
    try:
        assert (port.n_emb, port.n_gen) == (jax_loader.n_emb, jax_loader.n_gen) == (40, 40)
        assert port.num_batches() == jax_loader.num_batches()
        for epoch in (0, 1, 5):
            _assert_batches_equal(list(port.epoch(epoch)), list(jax_loader.epoch(epoch)))
    finally:
        port.close()
        jax_loader.close()


def test_counts_and_shapes(loader):
    batches = list(loader.epoch(0))
    assert len(batches) == loader.num_batches() == 10
    b = batches[0]
    assert b["query"]["input_ids"].shape == (4, 128)
    assert b["passage"]["input_ids"].shape == (4, 128)  # group 1
    assert b["query"]["input_ids"].dtype == np.int32
    assert b["generative"]["labels"].dtype == np.int64


def test_rows_match_python_collator(loader):
    """Every native query row is a row the port's collator makes of some
    sample, with its mask, instruction length and passage."""
    emb_sets, gen_sets = load_train_dirs([TOY])
    ds = GritDataset(emb_sets, gen_sets, mode="unified", train_group_size=1, seed=0)
    coll = GritCollator(ByteTokenizer(), query_max_len=128, passage_max_len=128,
                        generative_max_len=96)
    py_rows = {}
    for i in range(ds.len_emb):
        b = coll([ds[i]])
        py_rows[b["query"]["input_ids"][0].tobytes()] = b
    matched = 0
    for nb in loader.epoch(1):
        for r in range(nb["query"]["input_ids"].shape[0]):
            pb = py_rows[nb["query"]["input_ids"][r].tobytes()]
            np.testing.assert_array_equal(nb["query"]["attention_mask"][r],
                                          pb["query"]["attention_mask"][0])
            assert nb["query"]["instruction_lens"][r] == pb["query"]["instruction_lens"][0]
            np.testing.assert_array_equal(nb["passage"]["input_ids"][r],
                                          pb["passage"]["input_ids"][0])
            matched += 1
    assert matched == 40


def test_generative_labels_match_python(loader):
    coll = GritCollator(ByteTokenizer(), generative_max_len=96)
    rows = [json.loads(line) for line in open(os.path.join(TOY, "toy_generative.jsonl"))]
    py = {}
    for row in rows:
        b = coll([(None, None, row["text"])])
        py[b["generative"]["input_ids"][0].tobytes()] = b["generative"]
    for nb in loader.epoch(2):
        g = nb["generative"]
        for r in range(g["input_ids"].shape[0]):
            want = py[g["input_ids"][r].tobytes()]
            np.testing.assert_array_equal(g["attention_mask"][r], want["attention_mask"][0])
            np.testing.assert_array_equal(g["labels"][r], want["labels"][0])


def test_library_builds_into_build_under_a_hashed_name(tmp_path, monkeypatch):
    """The library's name carries a hash of the source and the flags, so an
    edited source builds anew; nothing is written under native/; a failed
    build raises with the compiler's output."""
    before = sorted(p.name for p in NATIVE.iterdir())
    path = Path(native_loader.build_library())
    assert path.parent == native_loader.BUILD_DIR and path.parent.parent.name == "build"
    assert path.name.startswith("libgritloader-") and path.exists()
    assert sorted(p.name for p in NATIVE.iterdir()) == before

    src = tmp_path / "gritloader.cpp"
    src.write_text(native_loader.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native_loader, "SOURCE", src)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    assert native_loader._target().name != path.name
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.build_library()
    assert not list((tmp_path / "build").glob("*.so"))
