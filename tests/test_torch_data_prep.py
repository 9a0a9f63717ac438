"""The port's data preparation (the format contract's checks and
reformatting, hard-negative mining, the QA dataset converters) against the
JAX package on the same inputs.

The pure modules must give equal outputs; mining runs both packages' GritLM
on the same tiny_mistral float32 weights (`params_from_jax`) over a bf16
index, and must give the same negatives up to ties (two candidates whose
scores agree within 1e-5 may swap).
"""

import json

import jax
import numpy as np
import pytest
import torch

import gritlm_tpu.data_prep as jdp
import gritlm_tpu.rag.prepare_qa as jqa
import gritlm_tpu_torch.data_prep as pdp
import gritlm_tpu_torch.rag.prepare_qa as pqa
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import params_from_jax
from gritlm_tpu_torch.tokenizer import ByteTokenizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


EMB_ROWS = [
    {"query": "q", "pos": ["p"], "neg": ["n"]},
    {"query": ["instr", "q"], "pos": [["i", "p"], "p2"], "neg": []},
    {"query": 3, "pos": [], "neg": "x"},
    {"query": ["a"], "pos": [1], "neg": [["a", "b", "c"]]},
    {},
]
GEN_ROWS = [{"text": "t"}, {"text": ["u", "a"]}, {"text": ["u"]}, {"text": []},
            {"text": ["u", 2]}, {"text": 5}]
FILES = {
    "valid_emb": [json.dumps(r) for r in EMB_ROWS[:2]],
    "valid_gen": [json.dumps(r) for r in GEN_ROWS[:2]] + [""],
    "mixed": [json.dumps(EMB_ROWS[0]), json.dumps(GEN_ROWS[0])],
    "broken": ["{not json", json.dumps(EMB_ROWS[2]), json.dumps(GEN_ROWS[3])],
}
PAIRS = [{"query": "q1", "pos": "p1", "neg": ["n1", "n2"]},
         {"query": "q2", "pos": ["p2", "p3"]}]
CHATS = [{"messages": [{"role": "system", "content": "s"}, {"role": "user", "content": "u1"},
                       {"role": "assistant", "content": "a1"},
                       {"role": "user", "content": "u2"}]},
         {"messages": [{"role": "assistant", "content": "a"}]},
         {"conv": [{"from": "human", "value": "h"}, {"from": "gpt", "value": "g"}]}]
TRAIN = ["the quick brown fox jumps over the lazy dog near the river bank today",
         "completely unrelated words here", ""]
EVAL = ["a quick brown fox jumps over the lazy dog near the river bank",
        "short", "the lazy dog near the river bank today and then some more words"]


def _files(tmp_path):
    out = {}
    for name, lines in FILES.items():
        p = tmp_path / f"{name}.jsonl"
        p.write_text("\n".join(lines) + "\n")
        out[name] = str(p)
    return out


FORMAT_CASES = {
    "validate_embedding_row": lambda m, fs, tok: [m.validate_embedding_row(r) for r in EMB_ROWS],
    "validate_generative_row": lambda m, fs, tok: [m.validate_generative_row(r)
                                                   for r in GEN_ROWS],
    "validate_file": lambda m, fs, tok: [{k: v for k, v in m.validate_file(p, 2).items()
                                          if k != "path"} for p in fs.values()],
    "reformat_pairs": lambda m, fs, tok: [list(m.reformat_pairs(PAIRS)), list(
        m.reformat_pairs(PAIRS, query_instruction="Q", passage_instruction="P"))],
    "reformat_chat": lambda m, fs, tok: [list(m.reformat_chat(CHATS[:2])), list(
        m.reformat_chat(CHATS[2:], messages_key="conv", role_key="from", content_key="value",
                        user_role="human", assistant_role="gpt"))],
    "length_stats": lambda m, fs, tok: [m.dataset_length_stats(fs[n], t)
                                        for n in ("valid_emb", "valid_gen") for t in (None, tok)],
    "decontamination": lambda m, fs, tok: [m.check_decontamination(TRAIN, EVAL, n=n, threshold=t)
                                           for n, t in ((8, 0.5), (3, 0.2), (20, 0.0))],
}


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_format_matches_jax(tmp_path, case):
    """data_prep.format: validation, reformatting, length statistics (token
    counts with each package's byte tokenizer) and decontamination."""
    fs = _files(tmp_path)
    got = FORMAT_CASES[case](pdp, fs, ByteTokenizer())
    assert got == FORMAT_CASES[case](jdp, fs, JaxByteTokenizer())
    if case == "validate_file":
        assert [v["valid"] for v in got] == [True, True, False, False]


def _qa_sources(root):
    (root / "triviaqa-unfiltered").mkdir(parents=True)
    nq_train = [{"question": f"nq q{i}?", "answer": [f"a{i}", f"b{i}"]} for i in range(12)]
    nq_dev = [{"question": "dev?", "answer": ["d"]}]
    (root / "NQ-open.train.jsonl").write_text("".join(json.dumps(r) + "\n" for r in nq_train))
    (root / "NQ-open.dev.jsonl").write_text("".join(json.dumps(r) + "\n" for r in nq_dev))
    tqa = [{"Question": f"tq {i}?", "Answer": {"Aliases": [f"x{i}", "ünï"]}} for i in range(9)]
    for split, rows in (("train", tqa[:6]), ("dev", tqa[6:])):
        (root / "triviaqa-unfiltered" / f"unfiltered-web-{split}.json").write_text(
            json.dumps({"Data": rows}))
    (root / "idx").mkdir()
    for split, idx in (("train", [0, 2, 4]), ("dev", [1, 3]), ("test", [0, 2])):
        (root / "idx" / f"TQA.{split}.idx.json").write_text(json.dumps(idx))
    return root


def _tree(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


QA_CASES = {
    "nq": lambda m, src, out: m.prepare_nq(str(src), str(out), dev_fraction_from_train=4),
    "nq_fewshot": lambda m, src, out: m.prepare_nq(str(src), str(out), fewshot_seed=3,
                                                   fewshot_k=5),
    "triviaqa": lambda m, src, out: m.prepare_triviaqa(str(src), str(out)),
    "triviaqa_index": lambda m, src, out: m.prepare_triviaqa(
        str(src), str(out), index_dir=str(src / "idx"), fewshot_seed=1, fewshot_k=2),
    "cli": lambda m, src, out: m.main(["triviaqa", "--orig_dir", str(src), "--output_dir",
                                       str(out), "--index_dir", str(src / "idx")]),
    "converters": lambda m, src, out: ([m.convert_nq({"question": "q", "answer": ("a",)}),
                                        m.convert_triviaqa({"Question": "q",
                                                            "Answer": {"Aliases": ["a"]}})],
                                       m.SOURCES),
}


@pytest.mark.parametrize("case", sorted(QA_CASES))
def test_prepare_qa_matches_jax(tmp_path, capsys, case):
    """rag.prepare_qa: the NQ and TriviaQA converters, splits and few-shot
    samples, and the CLI: the same counts and byte-equal files."""
    src = _qa_sources(tmp_path / "src")
    got = QA_CASES[case](pqa, src, tmp_path / "port")
    got_out = capsys.readouterr().out
    want = QA_CASES[case](jqa, src, tmp_path / "jax")
    assert got == want and got_out == capsys.readouterr().out
    if case != "converters":
        assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.fixture(scope="module")
def models():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(11))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return (JaxGritLM(jax_tiny_mistral(), params=jparams, mode="embedding"),
            GritLM(tiny_mistral(), params=tparams, mode="embedding", device="cpu"))


ROWS = [{"query": f"what about item {i}?",
         "pos": [f"passage {i} talks about item {i}"] + ([f"shared passage {i % 3}"] if i % 2
                                                         else []),
         "neg": ["old"]} for i in range(14)]


@pytest.mark.parametrize("skip_top,k", [(0, 3), (1, 2)])
def test_mine_hard_negatives_matches_jax(models, skip_top, k):
    """The same negatives up to ties; none of a row's own positives."""
    jm, tm = models
    kw = dict(k=k, skip_top=skip_top, query_instruction="<|embed|>\n", batch_size=4,
              max_length=64)
    got = pdp.mine_hard_negatives(tm, ROWS, **kw)
    want = jdp.mine_hard_negatives(jm, ROWS, **kw)
    emb = tm.encode(sorted({p for r in ROWS for p in r["pos"]}), max_length=64)
    by_text = dict(zip(sorted({p for r in ROWS for p in r["pos"]}), emb))
    for r, g, w in zip(ROWS, got, want):
        assert {key: v for key, v in g.items() if key != "neg"} == {
            key: v for key, v in r.items() if key != "neg"}
        assert len(g["neg"]) == k and not set(g["neg"]) & set(r["pos"])
        if g["neg"] != w["neg"]:  # a swap at a tie only
            q = tm.encode([r["query"]], instruction="<|embed|>\n", max_length=64)[0]
            gs = [float(by_text[t] @ q) for t in g["neg"]]
            ws = [float(by_text[t] @ q) for t in w["neg"]]
            np.testing.assert_allclose(gs, ws, atol=1e-5)


def test_mine_hard_negatives_mesh_raises(models):
    with pytest.raises(NotImplementedError, match="item 12"):
        pdp.mine_hard_negatives(models[1], ROWS, mesh=object())
