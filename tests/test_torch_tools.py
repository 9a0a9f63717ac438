"""The port's checkpoint tools (`python -m gritlm_tpu_torch.tools`) against
the JAX package's: shard, add-lm-head and strip-prefix outputs cross both
packages' tools and loaders with equal bytes; export-hf reads the port's
training checkpoint; verify-checkpoint gives the JAX tool's verdict.

The JAX tools read and write safetensors through the `safetensors` package
(numpy, no bf16 here), so the crossing runs on float32 checkpoints; bf16
survives the port's tools byte for byte on its own.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import gritlm_tpu.tools as jax_tools
import gritlm_tpu_torch.tools as tools
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.eval.retrieval import evaluate_retrieval as jax_evaluate_retrieval
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.models import loader as jax_loader
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import loader, params_from_jax
from gritlm_tpu_torch.models.transformer import init_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_ckpt(path, key, with_lm_head=True):
    params = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(key),
                             with_lm_head=with_lm_head)
    jax_loader.save_checkpoint(str(path), jax_tiny_mistral(), params)
    return params


def _port_ckpt(path, seed, with_lm_head=True, cfg=None):
    cfg = cfg or tiny_mistral()
    params = init_params(cfg, seed, with_lm_head=with_lm_head, device="cpu")
    loader.save_checkpoint(str(path), cfg, params)
    return params


def _tensors(path):
    """name -> numpy array of every safetensors file under path."""
    out = {}
    for f in sorted(path.glob("*.safetensors")):
        out.update(load_file(str(f)))
    return out


def _flat(tree, prefix=""):
    """path -> tensor of a param tree."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}


def _same_tensors(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


SHARD = str(64 * 1024 / 2**30)  # 64 KiB shards: several files


def _run(cmd, src, out, extra):
    main = tools.main if cmd[0] == "port" else jax_tools.main
    main([cmd[1], "--model", str(src), "--out", str(out), *extra])


CROSS_CASES = {
    "shard": ("shard", ["--max_shard_gb", SHARD]),
    "add-lm-head": ("add-lm-head", ["--donor", "DONOR"]),
    "strip-prefix": ("strip-prefix", ["--prefix", "model."]),
    "strip-prefix-sharded": ("strip-prefix", ["--prefix", "model.", "--max_shard_gb", SHARD]),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_tools_cross_packages(tmp_path, case, writer):
    """The same input checkpoint (written by `writer`'s save_checkpoint)
    through both packages' tools: the same file names, index and tensors
    byte for byte; each output loads in both packages' loaders."""
    cmd, extra = CROSS_CASES[case]
    src, donor = tmp_path / "src", tmp_path / "donor"
    if writer == "jax":
        _jax_ckpt(src, 1, with_lm_head=(cmd != "add-lm-head"))
        _jax_ckpt(donor, 2)
    else:
        _port_ckpt(src, 1, with_lm_head=(cmd != "add-lm-head"))
        _port_ckpt(donor, 2)
    extra = [str(donor) if a == "DONOR" else a for a in extra]
    for pkg in ("jax", "port"):
        _run((pkg, cmd), src, tmp_path / pkg, extra)
    port, jaxo = tmp_path / "port", tmp_path / "jax"
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jaxo.iterdir())
    _same_tensors(_tensors(port), _tensors(jaxo))
    if (jaxo / "model.safetensors.index.json").exists():
        assert (json.loads((port / "model.safetensors.index.json").read_text())
                == json.loads((jaxo / "model.safetensors.index.json").read_text()))
    if cmd == "strip-prefix":
        assert all(not k.startswith("model.") for k in _tensors(port))
    cfg, tp = loader.load_checkpoint(str(port), device="cpu")
    _, jp = jax_loader.load_checkpoint(str(jaxo))
    jp = _flat(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu"))
    tp = _flat(tp)
    assert tp.keys() == jp.keys()
    for k in tp:
        torch.testing.assert_close(tp[k], jp[k], atol=0, rtol=0)
    if cmd == "add-lm-head":
        np.testing.assert_array_equal(_tensors(port)["lm_head.weight"],
                                      _tensors(donor)["lm_head.weight"])


@pytest.mark.parametrize("cmd", ["shard", "strip-prefix"])
def test_bf16_survives_byte_for_byte(tmp_path, cmd):
    """A bf16 checkpoint through the port's tools: every tensor's bytes."""
    cfg = dataclasses.replace(tiny_mistral(), dtype="bfloat16")
    _port_ckpt(tmp_path / "src", 3, cfg=cfg)
    tools.main([cmd, "--model", str(tmp_path / "src"), "--out", str(tmp_path / "out"),
                "--max_shard_gb", SHARD])
    src = tools._load_hf_tensors(str(tmp_path / "src"))
    out = tools._load_hf_tensors(str(tmp_path / "out"))
    if cmd == "strip-prefix":
        src = {k[len("model."):] if k.startswith("model.") else k: v for k, v in src.items()}
    assert src.keys() == out.keys() and len(list((tmp_path / "out").glob("*.safetensors"))) > 1
    for k in src:
        assert out[k].dtype == torch.bfloat16
        assert src[k].view(torch.uint8).numpy().tobytes() == out[k].view(torch.uint8).numpy(
        ).tobytes(), k


def test_add_lm_head_needs_a_donor_head(tmp_path):
    _port_ckpt(tmp_path / "base", 1, with_lm_head=False)
    _port_ckpt(tmp_path / "donor", 2, with_lm_head=False)
    with pytest.raises(KeyError, match="lm_head"):
        tools.main(["add-lm-head", "--model", str(tmp_path / "base"), "--donor",
                    str(tmp_path / "donor"), "--out", str(tmp_path / "out")])


def test_export_hf_from_a_training_checkpoint(tmp_path, capsys):
    """Two full-parameter steps of the port's training CLI, then export-hf
    of its step_2 checkpoint: the export holds the checkpoint's params (both
    packages' loaders read it); a LoRA checkpoint holds no model."""
    from gritlm_tpu_torch.training.checkpoint import STATE_FILE
    from gritlm_tpu_torch.training.run import main as train_main

    toy = str(__import__("pathlib").Path(__file__).parent / "toy_data")
    base = ["--train_data", toy, "--device", "cpu", "--model_preset", "tiny_mistral",
            "--mode", "unified", "--per_device_train_batch_size", "2", "--max_steps", "2",
            "--query_max_len", "128", "--passage_max_len", "128", "--generative_max_len", "64",
            "--save_steps", "2", "--learning_rate", "1e-3"]
    train_main(base + ["--output_dir", str(tmp_path / "run")])
    ckpt = tmp_path / "run" / "checkpoints" / "step_2"
    (tmp_path / "run" / "export" / "config.json").rename(tmp_path / "config.json")
    tools.main(["export-hf", "--checkpoint", str(ckpt), "--config", str(tmp_path / "config.json"),
                "--out", str(tmp_path / "hf")])
    assert "exported step=2" in capsys.readouterr().out
    saved = torch.load(ckpt / "state" / STATE_FILE, weights_only=True)["params"]
    cfg, back = loader.load_checkpoint(str(tmp_path / "hf"), device="cpu")
    back, want = _flat(back), _flat(saved)
    assert cfg == tiny_mistral() and back.keys() == want.keys()
    for k in back:
        torch.testing.assert_close(back[k], want[k], atol=0, rtol=0)
    _, jp = jax_loader.load_checkpoint(str(tmp_path / "hf"))
    np.testing.assert_array_equal(np.asarray(jp["layers"]["attn"]["wq"]),
                                  saved["layers"]["attn"]["wq"].numpy())
    # the state directory itself is accepted too
    tools.main(["export-hf", "--checkpoint", str(ckpt / "state"), "--config",
                str(tmp_path / "config.json"), "--out", str(tmp_path / "hf2")])
    assert _tensors(tmp_path / "hf2").keys() == _tensors(tmp_path / "hf").keys()
    train_main(base + ["--lora", "--output_dir", str(tmp_path / "lora")])
    with pytest.raises(ValueError, match="LoRA"):
        tools.main(["export-hf", "--checkpoint",
                    str(tmp_path / "lora" / "checkpoints" / "step_2"), "--config",
                    str(tmp_path / "config.json"), "--out", str(tmp_path / "hf3")])


@pytest.fixture(scope="module")
def fp32_ckpt(tmp_path_factory):
    """A tiny float32 checkpoint (the oracle's parity is for fp32) written by
    the JAX exporter, as the JAX tool's own test makes it."""
    path = tmp_path_factory.mktemp("tiny_hf_ckpt")
    _jax_ckpt(path, 7)
    return str(path)


def _verdict(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_verify_checkpoint_matches_jax(fp32_ckpt, capsys, tmp_path):
    pytest.importorskip("transformers")
    got = _verdict(tools.main, ["verify-checkpoint", "--model", fp32_ckpt, "--device", "cpu",
                                "--out", str(tmp_path / "v.json")], capsys)
    want = _verdict(jax_tools.main, ["verify-checkpoint", "--model", fp32_ckpt], capsys)
    assert got.keys() == want.keys() and got["ok"] is want["ok"] is True
    assert json.loads((tmp_path / "v.json").read_text()) == got
    assert got["load"] == want["load"]
    for v in (got, want):
        tp = v["torch_parity"]
        assert tp["ran"] and tp["pass"]
        assert tp["causal_logit_rel_diff"] < 2e-3 and tp["bidirectional_hidden_rel_diff"] < 2e-3
    for key in ("expected_gritlm7b", "matches_gritlm7b", "positives_rank_first"):
        assert got["cosine_fixture"][key] == want["cosine_fixture"][key]
    np.testing.assert_allclose(got["cosine_fixture"]["sims"], want["cosine_fixture"]["sims"],
                               atol=2e-4)
    # the JAX tool reads its metrics under keys evaluate_retrieval never
    # returns (its smoke always reports 0.0); the port's values are the
    # JAX evaluate_retrieval's own on the same weights
    corpus, queries, qrels = jax_tools._micro_corpus()
    m = jax_evaluate_retrieval(
        JaxGritLM.from_pretrained(fp32_ckpt, mode="unified"), corpus, queries, qrels,
        query_instruction=jax_tools._gritlm_instruction(
            "Retrieve the passage that answers the query"),
        max_length=256, top_k=10, k_values=(1, 10))
    rs = got["retrieval_smoke"]
    assert rs.keys() == want["retrieval_smoke"].keys()
    assert (rs["n_queries"], rs["n_docs"]) == (6, 18)
    assert rs["ndcg@10"] == round(m["ndcg_at_10"], 4) and rs["recall@1"] == round(
        m["recall_at_1"], 4)


def test_verify_checkpoint_skip_torch_and_bad_dir(fp32_ckpt, capsys, tmp_path, monkeypatch):
    v = _verdict(tools.main, ["verify-checkpoint", "--model", fp32_ckpt, "--skip_torch",
                              "--device", "cpu"], capsys)
    assert v["ok"] is True and v["torch_parity"] == {"ran": False, "reason": "--skip_torch"}
    # without transformers the leg reports why, as the JAX tool does
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    v = _verdict(tools.main, ["verify-checkpoint", "--model", fp32_ckpt, "--device", "cpu"],
                 capsys)
    assert v["ok"] is True and v["torch_parity"]["ran"] is False
    with pytest.raises(SystemExit):
        tools.main(["verify-checkpoint", "--model", str(tmp_path / "nope"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["load"]["ok"] is False


def test_verify_checkpoint_defaults_to_cuda(fp32_ckpt, capsys, monkeypatch):
    """No --device: the card, and a verdict of a failed load without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tools.main(["verify-checkpoint", "--model", fp32_ckpt])
    load = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["load"]
    assert load["ok"] is False and "CUDA" in load["error"]
