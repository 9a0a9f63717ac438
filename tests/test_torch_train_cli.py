"""The port's training data pipeline and CLI against the JAX package's:
`gritlm_tpu_torch.training.data` yields the JAX pipeline's numpy batches for
the same seed; `python -m gritlm_tpu_torch.training.run --device cpu`
writes the JAX CLI's files with its schema; a resumed run ends bit-equal to
an uninterrupted one; the HF export crosses between the two packages'
loaders both ways with equal values; every option the port does not run
raises NotImplementedError.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import loader as jax_loader
from gritlm_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer
from gritlm_tpu.training import data as jdata
from gritlm_tpu.training.arguments import RunArguments as JaxRunArguments
from gritlm_tpu.training.metrics_logger import MetricsLogger as JaxMetricsLogger
from gritlm_tpu_torch.models import loader
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import data as pdata
from gritlm_tpu_torch.training import metrics_logger
from gritlm_tpu_torch.training.run import main

TOY = os.path.join(os.path.dirname(__file__), "toy_data")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _args(outdir, max_steps, *extra):
    return ["--train_data", TOY, "--device", "cpu", "--model_preset", "tiny_mistral",
            "--mode", "unified", "--per_device_train_batch_size", "2",
            "--max_steps", str(max_steps), "--query_max_len", "128",
            "--passage_max_len", "128", "--generative_max_len", "64", "--gc_chunks", "2",
            "--save_steps", "3", "--logging_steps", "2", "--learning_rate", "1e-3",
            "--output_dir", str(outdir), *extra]


@pytest.mark.parametrize("mode", ["unified", "embedding", "generative"])
def test_data_pipeline_matches_jax(mode):
    """Same seed, same toy JSONL: identical numpy batches over two epochs,
    a fast-forwarded epoch included."""
    outs = []
    for mod, tok in ((jdata, JaxByteTokenizer()), (pdata, ByteTokenizer())):
        emb, gen = mod.load_train_dirs([TOY])
        emb = mod.filter_too_long_instructions(tok, emb, 96, 96)
        ds = mod.GritDataset(emb, gen, mode=mode, train_group_size=3, seed=7)
        coll = mod.GritCollator(tok, query_max_len=96, passage_max_len=96,
                                generative_max_len=80, take_nth=2 if mode == "unified" else 1)
        batches = list(mod.batch_iterator(ds, coll, 4, seed=7, epoch=0))
        batches += list(mod.batch_iterator(ds, coll, 4, seed=7, epoch=1, skip=3))
        outs.append(batches)
    assert len(outs[0]) == len(outs[1]) > 3
    for bj, bp in zip(*outs):
        assert bj.keys() == bp.keys()
        for part in bj:
            assert bj[part].keys() == bp[part].keys()
            for k in bj[part]:
                np.testing.assert_array_equal(bp[part][k], bj[part][k], err_msg=f"{part}/{k}")
                assert bp[part][k].dtype == bj[part][k].dtype


def test_cli_writes_the_jax_files(tmp_path):
    out = tmp_path / "run"
    r = main(_args(out, 4))
    assert r["steps"] == 4 and np.isfinite(r["final"]["loss"]) and r["final"]["loss_emb"] > 0
    # run_args.json: the JAX CLI's RunArguments fields, plus --device
    run_args = json.loads((out / "run_args.json").read_text())
    assert set(run_args) == set(JaxRunArguments().__dict__) | {"device"}
    assert json.loads((out / "dataset_num_samples.json").read_text()).keys() == {
        "embedding", "generative"}
    # metrics.jsonl: the rows the JAX MetricsLogger writes for the same metrics
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [row["step"] for row in rows] == [1, 2, 3, 4]
    jlog = JaxMetricsLogger(str(tmp_path / "jax_log"), 0)
    jlog.log(1, r["final"])
    jlog.close()
    jrow = json.loads((tmp_path / "jax_log" / "metrics.jsonl").read_text())
    assert set(rows[-1]) == set(jrow)
    # checkpoints/step_<n>/{state/, extra.json}, rotated to save_total_limit 2
    ck = out / "checkpoints"
    assert sorted(os.listdir(ck)) == ["step_3", "step_4"]
    for step in ("step_3", "step_4"):
        assert (ck / step / "state").is_dir()
        assert json.loads((ck / step / "extra.json").read_text()).keys() == {
            "epoch", "batch_in_epoch"}
    # export/: the JAX exporter's config.json and tensor names, shapes, dtypes
    jcfg = jax_tiny_mistral()
    jax_loader.save_checkpoint(str(tmp_path / "jax_export"), jcfg,
                               jax_init_params(jcfg, jax.random.PRNGKey(0)))
    for name in ("config.json",):
        assert (json.loads((out / "export" / name).read_text())
                == json.loads((tmp_path / "jax_export" / name).read_text()))
    from safetensors.numpy import load_file

    got = load_file(str(out / "export" / "model.safetensors"))
    want = load_file(str(tmp_path / "jax_export" / "model.safetensors"))
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}


def test_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """Killed after the step-3 checkpoint, resumed with auto: the final
    export is bit-equal to the uninterrupted run's (data cursor, optimizer,
    schedule and step all restored)."""
    ra = main(_args(tmp_path / "a", 6))
    orig = metrics_logger.MetricsLogger.log

    def bomb(self, step, metrics):
        if step >= 4:
            raise KeyboardInterrupt("simulated kill")
        return orig(self, step, metrics)

    monkeypatch.setattr(metrics_logger.MetricsLogger, "log", bomb)
    with pytest.raises(KeyboardInterrupt):
        main(_args(tmp_path / "b", 6))
    monkeypatch.setattr(metrics_logger.MetricsLogger, "log", orig)
    rb = main(_args(tmp_path / "b", 6, "--resume_from_checkpoint", "auto"))
    assert ra["steps"] == rb["steps"] == 6
    assert ra["final"] == rb["final"]
    _, pa = loader.load_checkpoint(ra["export"], device="cpu")
    _, pb = loader.load_checkpoint(rb["export"], device="cpu")
    for k in ("wq", "wo"):
        assert torch.equal(pa["layers"]["attn"][k], pb["layers"]["attn"][k])
    for k in ("gate", "up", "down"):
        assert torch.equal(pa["layers"]["mlp"][k], pb["layers"]["mlp"][k])
    assert torch.equal(pa["embed"]["embedding"], pb["embed"]["embedding"])


def _assert_same(port_tree, jax_tree, path=""):
    for k, v in jax_tree.items():
        if isinstance(v, dict):
            _assert_same(port_tree[k], v, f"{path}/{k}")
        else:
            np.testing.assert_array_equal(port_tree[k].float().numpy(),
                                          np.asarray(v, np.float32), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_crosses_between_packages(tmp_path, dtype):
    """A LoRA run's merged export loads in the JAX loader with the port
    loader's values; a JAX export (sharded, with an index) loads in the
    port's with the JAX values."""
    r = main(_args(tmp_path / "run", 2, "--lora", "--lora_r", "4", "--dtype", dtype))
    jcfg, jp = jax_loader.load_checkpoint(r["export"])
    cfg, pp = loader.load_checkpoint(r["export"], device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert pp["layers"]["attn"]["wq"].dtype == getattr(torch, dtype)
    _assert_same(pp, jp)

    jcfg = jax_tiny_mistral()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    jax_loader.save_checkpoint(str(tmp_path / "jax"), jcfg, jparams, max_shard_bytes=200_000)
    assert os.path.exists(tmp_path / "jax" / "model.safetensors.index.json")
    _, back = loader.load_checkpoint(str(tmp_path / "jax"), device="cpu")
    _assert_same(back, jparams)


def test_safetensors_by_hand_round_trip(tmp_path):
    """The hand-written format reads back what it wrote, and what the
    safetensors package writes (header offsets, dtypes, shapes)."""
    from safetensors.numpy import save_file

    tensors = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
               "b": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
               "c": torch.arange(5, dtype=torch.int64), "d": torch.ones(0, 3)}
    loader.write_safetensors(str(tmp_path / "x.safetensors"), tensors)
    back = loader.read_safetensors(str(tmp_path / "x.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    save_file({"e": np.arange(6, dtype=np.float32).reshape(2, 3),
               "f": np.array([7, 8], np.int32)}, str(tmp_path / "y.safetensors"))
    back = loader.read_safetensors(str(tmp_path / "y.safetensors"))
    assert torch.equal(back["e"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert torch.equal(back["f"], torch.tensor([7, 8], dtype=torch.int32))


NOT_PORTED = [
    (["--native_loader"], "item 13"),
    (["--seq_parallel"], "item 12"),
    (["--mesh_stage", "2"], "item 12"),
    (["--mesh_data", "2"], "item 12"),
    (["--mesh_fsdp", "2"], "item 12"),
    (["--mesh_model", "2"], "item 12"),
    (["--mesh_expert", "2"], "item 12"),
    (["--moe_impl", "dense"], "item 11"),
    (["--model_preset", "tiny_mixtral"], "item 11"),
]


@pytest.mark.parametrize("flags,item", NOT_PORTED, ids=[" ".join(f) for f, _ in NOT_PORTED])
def test_not_ported_flag_raises(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        main(_args(tmp_path / "run", 1, *flags))


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """Two CLI steps with the default full recompute."""
    return main(_args(tmp_path_factory.mktemp("remat") / "run", 2))


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policy_flag_runs(tmp_path, two_steps, policy):
    """--remat_policy (ported with the remat policies): two steps with
    finite losses, recorded in run_args.json, and the same losses as the
    full recompute's (the policy changes what is kept, not what is
    computed)."""
    r = main(_args(tmp_path / "run", 2, "--remat_policy", policy))
    assert r["steps"] == 2 and all(np.isfinite(v) for v in r["final"].values())
    assert json.loads((tmp_path / "run" / "run_args.json").read_text())[
        "remat_policy"] == policy
    assert r["final"] == two_steps["final"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """tiny_mistral's JAX weights in an HF checkpoint written by the port,
    with a BPE tokenizer.json beside them."""
    from tok_fixtures import make_bpe_tokenizer

    from gritlm_tpu_torch.config import tiny_mistral
    from gritlm_tpu_torch.models.convert import params_from_jax

    path = tmp_path_factory.mktemp("ckpt")
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(2))
    loader.save_checkpoint(str(path), tiny_mistral(), params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(), device="cpu"))
    make_bpe_tokenizer()._tok.save(str(path / "tokenizer.json"))
    return path


@pytest.mark.parametrize("flag", ["--qlora", "--model_name_or_path", "--projection"])
def test_ported_flag_runs(tmp_path, checkpoint, flag):
    """The flags the port runs since the quantized-weights slice.
    --qlora: LoRA over an int8 base; the merged export is dense (bf16
    kernels from the dequantized base, as the JAX package's) and loads in
    both packages' loaders with equal values. --model_name_or_path: the
    checkpoint's weights and tokenizer; one step (its update has LR 0)
    exports the checkpoint's weights bit for bit, and the data were
    filtered with the checkpoint's tokenizer. --projection 16: a fresh
    head drawn as init_projection(seed + 1) (a one-step run exports it as
    drawn), trained with the full parameters (the second update moves it),
    exported as
    projection.weight/.bias that both loaders read, and a from_pretrained
    of the export encodes to 16 columns."""
    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import tiny_mistral
    from gritlm_tpu_torch.models.transformer import init_projection
    from gritlm_tpu_torch.tokenizer import load_tokenizer

    if flag == "--projection":
        r = main(_args(tmp_path / "run", 2, "--projection", "16"))
        assert r["steps"] == 2 and all(np.isfinite(v) for v in r["final"].values())
        run_args = json.loads((tmp_path / "run" / "run_args.json").read_text())
        assert run_args["projection"] == 16
        _, jp = jax_loader.load_checkpoint(r["export"])
        _, pp = loader.load_checkpoint(r["export"], device="cpu")
        _assert_same(pp, jp)
        start = init_projection(tiny_mistral(), 16, run_args["seed"] + 1, device="cpu")
        assert tuple(pp["projection"]["kernel"].shape) == (64, 16)
        assert not torch.equal(pp["projection"]["kernel"], start["kernel"])
        one = main(_args(tmp_path / "one", 1, "--projection", "16"))  # update 1 has LR 0
        _, first = loader.load_checkpoint(one["export"], device="cpu")
        assert torch.equal(first["projection"]["kernel"], start["kernel"])
        emb = GritLM.from_pretrained(r["export"], device="cpu").encode(["a passage"])
        assert emb.shape == (1, 16)
        return
    if flag == "--qlora":
        r = main(_args(tmp_path / "run", 2, "--qlora", "--lora_r", "4"))
        assert r["steps"] == 2 and all(np.isfinite(v) for v in r["final"].values())
        _, jp = jax_loader.load_checkpoint(r["export"])
        _, pp = loader.load_checkpoint(r["export"], device="cpu")
        _assert_same(pp, jp)
        raw = loader.read_safetensors(str(tmp_path / "run" / "export" / "model.safetensors"))
        assert raw["model.layers.0.mlp.up_proj.weight"].dtype == torch.bfloat16
        assert raw["model.norm.weight"].dtype == torch.float32
        return
    r = main(_args(tmp_path / "run", 1, flag, str(checkpoint)))
    assert r["steps"] == 1
    assert json.loads((tmp_path / "run" / "run_args.json").read_text())[
        "model_name_or_path"] == str(checkpoint)
    _, want = loader.load_checkpoint(str(checkpoint), device="cpu")
    _, got = loader.load_checkpoint(r["export"], device="cpu")
    for path, a in _leaves(want):
        b = got
        for k in path:
            b = b[k]
        assert torch.equal(b, a), path
    tok = load_tokenizer(str(checkpoint))
    emb, _ = pdata.load_train_dirs([TOY])
    kept = sum(len(x) for x in pdata.filter_too_long_instructions(tok, emb, 128, 128))
    assert json.loads((tmp_path / "run" / "dataset_num_samples.json").read_text())[
        "embedding"] == kept


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_cli_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _args(tmp_path / "run", 1)
    i = argv.index("--device")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv[:i] + argv[i + 2:])
