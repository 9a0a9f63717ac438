"""The port's retrieval evaluation (metrics, evaluate_retrieval over its fp32
index, the generative reranker), its MTEB adapter and CLI, and its pure
copies (aggregate, the instruction files) against the JAX package.

Both packages get the same tiny_mistral float32 weights (`params_from_jax`)
and the same corpus, queries and qrels; the port runs on the CPU, its
kernels as their plain versions. Tolerances: embeddings within 1e-5 (the
same float32 model, sums in another order); rerank yes-logits within 1e-4;
metrics, which depend only on the ranking, equal.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import gritlm_tpu.eval.aggregate as jax_aggregate
import gritlm_tpu.eval.mteb as jax_mteb_cli
import gritlm_tpu.eval.mteb_adapter as jax_adapter
import gritlm_tpu.eval.rerank as jax_rerank
import gritlm_tpu.eval.retrieval as jax_retrieval
import gritlm_tpu_torch.eval.aggregate as aggregate
import gritlm_tpu_torch.eval.mteb as mteb_cli
import gritlm_tpu_torch.eval.mteb_adapter as adapter
import gritlm_tpu_torch.eval.rerank as rerank
import gritlm_tpu_torch.eval.retrieval as retrieval
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.ops import scores_segmax

JAX_DIR = os.path.dirname(jax_adapter.__file__)
PORT_DIR = os.path.dirname(adapter.__file__)

CORPUS = {f"d{i}": {"title": f"t{i % 3}", "text": f"document {i} about topic {i * 7 % 13}"}
          for i in range(14)}
QUERIES = {f"q{i}": (f"t{i % 3} document {i} about topic {i * 7 % 13}" if i < 4
                     else f"what is topic {i}?") for i in range(7)}
QRELS = {f"q{i}": {f"d{i}": 1, f"d{(i + 5) % 14}": int(i % 2)} for i in range(7)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """(JAX GritLM, port GritLM) on the same tiny_mistral float32 weights."""
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return (JaxGritLM(jax_tiny_mistral(), params=jparams, mode="unified"),
            GritLM(tiny_mistral(), params=tparams, mode="unified", device="cpu"))


# hand-made results: relevant docs at ranks 1 and 3, one at rank 2, none
# retrieved, graded relevance, a query missing from the results
METRIC_CASES = {
    "ranks": ({"q1": {"d1": 0.9, "dX": 0.8, "d2": 0.7}, "q2": {"dY": 0.9, "d3": 0.8}},
              {"q1": {"d1": 1, "d2": 1}, "q2": {"d3": 1}}),
    "graded": ({"q": {"a": 0.1, "b": 0.5, "c": 0.3, "d": 0.2}},
               {"q": {"a": 2, "c": 1, "z": 3}}),
    "missing": ({"q1": {"x": 1.0}}, {"q1": {"x": 0}, "q2": {"y": 1}}),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_retrieval_metrics_match_jax(case):
    results, qrels = METRIC_CASES[case]
    got = retrieval.retrieval_metrics(results, qrels, (1, 3, 10))
    assert got == jax_retrieval.retrieval_metrics(results, qrels, (1, 3, 10))
    if case == "ranks":  # by hand, as the JAX package's own test
        assert got["ndcg_at_1"] == pytest.approx(0.5)
        assert got["mrr_at_3"] == pytest.approx(0.75)
        assert got["map_at_3"] == pytest.approx(((1 + 2 / 3) / 2 + 0.5) / 2, abs=1e-4)


@pytest.mark.parametrize("reranked", [False, True], ids=["dense", "reranked"])
def test_evaluate_retrieval_matches_jax(models, reranked):
    jm, tm = models
    kw = dict(query_instruction="<|user|>\nfind it\n<|embed|>\n",
              corpus_instruction="<|embed|>\n", batch_size=4, max_length=64, top_k=8,
              k_values=(1, 3, 10), rerank_depth=4)
    f32_before = scores_segmax.scores_segmax.f32_launches
    want = jax_retrieval.evaluate_retrieval(
        jm, CORPUS, QUERIES, QRELS,
        reranker=jax_rerank.GenerativeReranker(jm, max_length=96, batch_size=3)
        if reranked else None, **kw)
    got = retrieval.evaluate_retrieval(
        tm, CORPUS, QUERIES, QRELS,
        reranker=rerank.GenerativeReranker(tm, max_length=96, batch_size=3)
        if reranked else None, **kw)
    assert got == want
    assert ("rerank_ndcg_at_10" in got) == reranked
    assert got["recall_at_1"] > 0  # the planted queries find their own doc
    # the CPU index is fp32 (no kernel launch is counted on the plain path)
    assert scores_segmax.scores_segmax.f32_launches == f32_before
    docs = [CORPUS[d] for d in CORPUS]
    np.testing.assert_allclose(
        tm.encode_corpus(docs, instruction="<|embed|>\n", batch_size=4, max_length=64),
        jm.encode_corpus(docs, instruction="<|embed|>\n", batch_size=4, max_length=64),
        atol=1e-5, rtol=0)


def test_evaluate_retrieval_builds_fp32_index(models, monkeypatch):
    """The corpus goes into an fp32 FlatIndex on the model's device."""
    from gritlm_tpu_torch.index import FlatIndex

    seen = []
    real_init = FlatIndex.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        seen.append((self.dtype, self.device.type))

    monkeypatch.setattr(FlatIndex, "__init__", spy)
    retrieval.evaluate_retrieval(models[1], CORPUS, QUERIES, QRELS, max_length=64,
                                 top_k=5, k_values=(1,))
    assert seen == [(torch.float32, "cpu")]


def test_reranker_matches_jax(models, tmp_path, monkeypatch):
    jm, tm = models
    prompts = [rerank.DEFAULT_TEMPLATE.format(query=QUERIES[f"q{i}"], title=CORPUS[f"d{i}"]["title"],
                                              text=CORPUS[f"d{i}"]["text"]) for i in range(5)]
    jr = jax_rerank.GenerativeReranker(jm, max_length=96, batch_size=8)
    tr = rerank.GenerativeReranker(tm, max_length=96, batch_size=8, cache_dir=str(tmp_path))
    assert tr.yes_id == jr.yes_id
    np.testing.assert_allclose(tr._score_batch(prompts), jr._score_batch(prompts), atol=1e-4,
                               rtol=0)
    results = {q: {d: 1.0 - 0.01 * j for j, d in enumerate(CORPUS)} for q in QUERIES}
    want = jr.rerank(QUERIES, CORPUS, results, depth=5)
    got = tr.rerank(QUERIES, CORPUS, results, depth=5)
    for q in QUERIES:
        assert (sorted(got[q], key=lambda d: -got[q][d])
                == sorted(want[q], key=lambda d: -want[q][d]))
        np.testing.assert_allclose([got[q][d] for d in CORPUS], [want[q][d] for d in CORPUS],
                                   atol=1e-3, rtol=0)
    # the per-query cache is read back instead of scoring again
    assert sorted(os.listdir(tmp_path)) == sorted(f"{q}.json" for q in QUERIES)
    monkeypatch.setattr(tr, "_score_batch", lambda p: pytest.fail("scored a cached query"))
    assert tr.rerank(QUERIES, CORPUS, results, depth=5) == got


def _beir(root, task="SciFact"):
    d = root / task
    d.mkdir(parents=True)
    with open(d / "corpus.jsonl", "w") as f:
        for k, v in CORPUS.items():
            f.write(json.dumps({"_id": k, **v}) + "\n")
    with open(d / "queries.jsonl", "w") as f:
        for k, v in QUERIES.items():
            f.write(json.dumps({"_id": k, "text": v}) + "\n")
    (d / "qrels").mkdir()
    with open(d / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q, rel in QRELS.items():
            for doc, s in rel.items():
                f.write(f"{q}\t{doc}\t{s}\n")
    return root


@pytest.mark.parametrize("flags", [
    ["--no_instruction"],
    ["--rerank_top_k", "3", "--top_k", "6"],
    ["--num_shots", "1", "--instruction_format", "tulu"],
], ids=["dense", "rerank", "few_shot"])
def test_offline_cli_matches_jax(models, tmp_path, monkeypatch, flags):
    """The offline path (--local_data_dir) writes the JAX CLI's per-task JSON;
    a second run skips the existing task."""
    jm, tm = models
    data = _beir(tmp_path / "data")
    monkeypatch.setattr(jax_mteb_cli, "_load_model", lambda args: jm)
    monkeypatch.setattr(mteb_cli, "_load_model", lambda args: tm)
    out = {}
    for name, cli in (("jax", jax_mteb_cli), ("port", mteb_cli)):
        argv = ["--local_data_dir", str(data), "--task_names", "SciFact", "--batch_size", "4",
                "--max_length", "64", "--output_folder", str(tmp_path / name),
                "--rerank_cache_dir", str(tmp_path / f"cache_{name}"), *flags]
        if name == "port":
            argv += ["--device", "cpu"]
        res = cli.main(argv)
        assert set(res) == {"SciFact"}
        out[name] = json.loads((tmp_path / name / "SciFact.json").read_text())
        assert cli.main(argv) == {}  # skip-if-exists
    assert out["port"] == out["jax"]
    assert ("rerank_ndcg_at_10" in out["port"]["metrics"]) == ("--rerank_top_k" in flags)
    if "--rerank_top_k" in flags:
        for q in QUERIES:
            a = json.loads((tmp_path / "cache_port" / "SciFact" / f"{q}.json").read_text())
            b = json.loads((tmp_path / "cache_jax" / "SciFact" / f"{q}.json").read_text())
            assert a.keys() == b.keys()
            np.testing.assert_allclose(list(a.values()), [b[k] for k in a], atol=1e-4)


def test_cli_flags_match_jax():
    """The JAX CLI's flags, plus --device (default cuda)."""
    def flags(p):
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    port, jax_flags = flags(mteb_cli.get_parser()), flags(jax_mteb_cli.get_parser())
    assert set(port) - set(jax_flags) == {"device"} and port["device"] == "cuda"
    assert {k: port[k] for k in jax_flags} == jax_flags


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mteb_cli.main(["--model_preset", "tiny_mistral", "--task_names", "SciFact",
                       "--local_data_dir", str(_beir(tmp_path / "data")),
                       "--output_folder", str(tmp_path / "out")])


class _FakeMTEB:
    """Stands in for mteb.MTEB: drives the encoder as the harness's retrieval
    path does and writes the per-task JSON the skip logic looks for."""

    calls: list = []

    def __init__(self, tasks):
        self.task = tasks[0]

    def run(self, encoder, output_folder=None, eval_splits=None):
        q = encoder.encode_queries(["what is a volcano"])
        c = encoder.encode_corpus([{"title": "t", "text": "volcanoes erupt"},
                                   {"title": "", "text": "bread is baked"}])
        s = encoder.encode(["plain sentence"])
        _FakeMTEB.calls.append((self.task, encoder.q_instruction, encoder.c_instruction,
                                np.concatenate([q, c, s])))
        with open(os.path.join(output_folder, f"{self.task}.json"), "w") as f:
            json.dump({"task": self.task}, f)
        return [{"task": self.task}]


@pytest.mark.parametrize("few_shot", [False, True], ids=["zero_shot", "few_shot"])
def test_online_path_matches_jax(models, tmp_path, monkeypatch, few_shot):
    """The online path through a stub `mteb` module: the same tasks, bound
    instructions (e5 set, gritlm format) and embeddings as the JAX CLI."""
    jm, tm = models
    mod = types.ModuleType("mteb")
    mod.MTEB = _FakeMTEB
    monkeypatch.setitem(sys.modules, "mteb", mod)
    monkeypatch.setattr(jax_mteb_cli, "_load_model", lambda args: jm)
    monkeypatch.setattr(mteb_cli, "_load_model", lambda args: tm)
    calls = {}
    for name, cli in (("jax", jax_mteb_cli), ("port", mteb_cli)):
        _FakeMTEB.calls = []
        argv = ["--task_names", "SciFact,Banking77Classification", "--batch_size", "4",
                "--output_folder", str(tmp_path / name)] + (["--num_shots", "1"] if few_shot
                                                            else [])
        assert set(cli.main(argv)) == {"SciFact", "Banking77Classification"}
        calls[name] = _FakeMTEB.calls
        _FakeMTEB.calls = []
        assert cli.main(argv) == {} and _FakeMTEB.calls == []  # skip-if-exists
    assert [c[:3] for c in calls["port"]] == [c[:3] for c in calls["jax"]]
    for p, j in zip(calls["port"], calls["jax"]):
        np.testing.assert_allclose(p[3], j[3], atol=1e-5, rtol=0)
    assert calls["port"][0][1] != calls["port"][0][2]  # SciFact: asymmetric


def test_online_path_rejects_rerank(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "mteb", types.ModuleType("mteb"))
    monkeypatch.setattr(mteb_cli, "_load_model", lambda args: None)
    with pytest.raises(SystemExit, match="rerank"):
        mteb_cli.main(["--task_names", "SciFact", "--rerank_top_k", "5",
                       "--output_folder", str(tmp_path)])


def test_run_mteb_without_mteb_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "mteb", None)  # `import mteb` raises ImportError
    with pytest.raises(ImportError, match="mteb"):
        adapter.run_mteb(None, tasks=["SciFact"])
    with pytest.raises(ImportError, match="mteb"):
        jax_adapter.run_mteb(None, tasks=["SciFact"])


@pytest.mark.parametrize("name", ["mteb_instructions.json", "mteb_fewshot.json",
                                  "rerank_templates.json"])
def test_instruction_files_are_the_jax_files(name):
    with open(os.path.join(PORT_DIR, "instructions", name), "rb") as f:
        port = f.read()
    with open(os.path.join(JAX_DIR, "instructions", name), "rb") as f:
        assert port == f.read()


def _adapter_cases():
    sets = sorted(json.load(open(os.path.join(JAX_DIR, "instructions",
                                              "mteb_instructions.json"))))
    cases = {f"set_{s}": lambda m, s=s: m.load_instruction_set(s) for s in sets}
    cases.update({
        "quick_eval": lambda m: (m.QUICK_EVAL, m.DEFAULT_INSTRUCTIONS),
        "formats": lambda m: [m.format_instruction(i, f) for i in ("", "do x")
                              for f in ("gritlm", "zephyr", "tulu", "mistral")],
        "few_shot": lambda m: [m.apply_few_shot(m.load_instruction_set(s)[t], t, s)
                               for s in ("e5", "medi2")
                               for t in ("ArguAna", "Banking77Classification", "SciFact")],
        "few_shot_unknown": lambda m: m.apply_few_shot("base", "NotATask", "e5"),
        "load_instructions": lambda m: m.load_instructions(instruction_set="medi2"),
        "rerank_templates": lambda m: [m.load_rerank_template(t)
                                       for t in ("SciFact", "NFCorpus", "NotATask")],
    })
    return cases


ADAPTER_CASES = _adapter_cases()


@pytest.mark.parametrize("case", sorted(ADAPTER_CASES))
def test_mteb_adapter_matches_jax(case):
    """Instruction sets, formats, few-shot and rerank templates equal to the
    JAX module's (the rerank templates live in eval/rerank.py there too)."""
    def mod(m, r):
        return types.SimpleNamespace(**{k: getattr(m, k) for k in dir(m)},
                                     load_rerank_template=r.load_rerank_template)

    fn = ADAPTER_CASES[case]
    assert fn(mod(adapter, rerank)) == fn(mod(jax_adapter, jax_rerank))
    if case == "formats":
        with pytest.raises(ValueError):
            adapter.format_instruction("x", "nope")
    if case == "set_e5":
        with pytest.raises(ValueError):
            adapter.load_instruction_set("nope")


def test_mteb_encoder_matches_jax(models):
    jm, tm = models
    instr = {"query": "find docs", "corpus": ""}
    jenc = jax_adapter.MTEBEncoder(jm, instr, batch_size=4, max_length=64)
    tenc = adapter.MTEBEncoder(tm, instr, batch_size=4, max_length=64)
    assert (tenc.q_instruction, tenc.c_instruction) == (jenc.q_instruction, jenc.c_instruction)
    docs = [{"title": "t", "text": "hello"}, {"title": "", "text": "bread"}]
    for method, arg in (("encode", ["hi there"]), ("encode_queries", ["hello"]),
                        ("encode_corpus", docs)):
        np.testing.assert_allclose(getattr(tenc, method)(arg), getattr(jenc, method)(arg),
                                   atol=1e-5, rtol=0)


def _mteb_json(tmp_path, name, main, **extra):
    with open(tmp_path / f"{name}.json", "w") as f:
        json.dump({"test": main, **extra}, f)


def _aggregate_dir(root):
    """A results dir as MTEB writes it: flat, nested-by-language and
    cos_sim shapes, all 12 CQADupstack subforums, a broken file, an unknown
    task."""
    root.mkdir()
    _mteb_json(root, "SciFact", {"ndcg_at_10": 0.61, "evaluation_time": 3.0})
    _mteb_json(root, "STS17", {"en-en": {"cos_sim": {"spearman": 0.8}}})
    _mteb_json(root, "Banking77Classification", {"accuracy": 81.0})
    _mteb_json(root, "TwitterSemEval2015", {"cos_sim": {"ap": 0.7}})
    _mteb_json(root, "Unknown", {"main_score": 0.5})
    for i, sub in enumerate(jax_aggregate.CQADUPSTACK_SUBFORUMS):
        _mteb_json(root, sub, {"ndcg_at_10": 0.3 + 0.01 * i, "evaluation_time": 1.0},
                   mteb_version="1.0")
    (root / "Broken.json").write_text("{not json")
    return root


AGGREGATE_CASES = {
    "main_score": lambda m, d: [m.main_score(t, r) for t, r in (
        ("SciFact", {"dev": {"ndcg_at_10": 0.4}}), ("STS12", {"test": {"en": {"spearman": 0.9}}}),
        ("Nope", {"validation": {"main_score": 0.2}}), ("SciFact", {"train": 3}))],
    "merge_cqadupstack": lambda m, d: m.merge_cqadupstack(str(d), write=False),
    "collect_scores": lambda m, d: m.collect_scores(str(d)),
    "summarize": lambda m, d: m.summarize(m.collect_scores(str(d))),
    "markdown": lambda m, d: m.to_markdown(m.summarize(m.collect_scores(str(d))), "x"),
    "latex": lambda m, d: m.to_latex({"a_b": m.summarize(m.collect_scores(str(d))), "c": {}}),
    "tasks": lambda m, d: (m.TASKS_BY_TYPE, m.TASK_TO_TYPE, m.LMEVAL_DS_NAMES),
}


def _lmeval_inputs(tmp_path):
    paths = {}
    for i, model in enumerate(("m1", "m2")):
        p = tmp_path / f"{model}.json"
        p.write_text(json.dumps({"results": {"arc_easy": {"acc": 0.5 + i / 10},
                                             "boolq": {"acc": 0.6}, "x": {"f1": 1.0}}}))
        paths[model] = str(p)
    alpaca = tmp_path / "alpaca.jsonl"
    alpaca.write_text("".join(json.dumps({"output": "x" * n}) + "\n" for n in (5, 1, 9, 3)))
    return paths, str(alpaca)


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES) + ["lmeval", "cli"])
def test_aggregate_matches_jax(case, tmp_path, capsys):
    if case == "lmeval":
        paths, alpaca = _lmeval_inputs(tmp_path)
        assert aggregate.lmeval_table(paths) == jax_aggregate.lmeval_table(paths)
        assert aggregate.alpaca_median_length(alpaca) == jax_aggregate.alpaca_median_length(alpaca)
        return
    outs = []
    for name, m in (("port", aggregate), ("jax", jax_aggregate)):
        (tmp_path / name).mkdir()
        d = _aggregate_dir(tmp_path / name / "model")  # a dir of model dirs
        if case == "cli":
            m.main([str(tmp_path / name), "--tex", str(tmp_path / f"{name}.tex")])
            outs.append((capsys.readouterr().out.replace(str(tmp_path / name), "X"),
                         (tmp_path / f"{name}.tex").read_text(),
                         (d / "CQADupstackRetrieval.json").read_text()))
        else:
            outs.append(AGGREGATE_CASES[case](m, d))
    assert repr(outs[0]) == repr(outs[1])  # nan averages (types with no task) included
