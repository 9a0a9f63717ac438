"""The port's training improves quality: the torch counterpart of
tests/test_train_learns.py, with the same gates.

About 300 unified GRIT steps of the port's `train_step` on the committed
toy JSONL (tiny_mistral, float32 on the CPU, the settings the JAX test
calibrated) must (a) drop both losses (embedding below 0.8x, generative
below 0.25x of the first step's), (b) raise held-out retrieval nDCG@10 over
the initial encoder by 0.03 or more, and (c) take greedy exact match on the
memorizable toy answers to 0.8 or more, above the initial model's. The
port's GritLM embeds and generates; the JAX package's `evaluate_retrieval`
only scores the numpy embeddings (its FlatIndex over them).
"""

import numpy as np
import pytest
import torch

from gritlm_tpu.eval.retrieval import evaluate_retrieval
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models.transformer import init_params
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training.data import GritCollator, GritDataset, load_train_dirs
from gritlm_tpu_torch.training.templates import gritlm_instruction
from gritlm_tpu_torch.training.train import TrainConfig, init_train_state, train_step

TOY_DIR = __file__.rsplit("/", 1)[0] + "/toy_data"

# the JAX test's held-out micro-task: the toy data's templates, unseen
# topics, and a same-topic distractor for every query
HELDOUT_TOPICS = [
    "quantum dots", "medieval castles", "ocean currents", "drum rhythms",
    "alpine meadows", "circuit boards", "paper cranes", "desert storms",
]


def _heldout_task():
    corpus, queries, qrels = {}, {}, {}
    for i, t in enumerate(HELDOUT_TOPICS):
        corpus[f"d{i}"] = {"title": "",
                           "text": f"A short note on {t}: interesting fact number {i}."}
        queries[f"q{i}"] = f"what should I know about {t} ({i})?"
        qrels[f"q{i}"] = {f"d{i}": 1}
    for j, t in enumerate(HELDOUT_TOPICS):
        corpus[f"f{j}"] = {"title": "", "text": f"Unrelated text about {t} ({j})."}
    return corpus, queries, qrels


def _retrieval_ndcg(cfg, params):
    model = GritLM(cfg, params=params, mode="unified", device="cpu")
    corpus, queries, qrels = _heldout_task()
    mets = evaluate_retrieval(
        model, corpus, queries, qrels,
        query_instruction=gritlm_instruction(
            "Given a question, retrieve the passage that answers it"),
        corpus_instruction=gritlm_instruction("Represent the passage for retrieval"),
        max_length=128, top_k=10, k_values=(10,),
    )
    return mets["ndcg_at_10"]


def _gen_exact_match(cfg, params, gen_rows):
    """Greedy decode of the training prompts against the gold answers."""
    model = GritLM(cfg, params=params, mode="unified", device="cpu")
    em = 0
    for r in gen_rows:
        user, gold = r["text"][0], r["text"][1].strip()
        prompt = "<s><|user|>\n" + user + "\n<|assistant|>\n"
        out = (model.generate(prompt, max_new_tokens=24, add_special_tokens=False) or "").strip()
        em += int(out == gold)
    return em / len(gen_rows)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


@pytest.mark.slow
def test_unified_training_improves_quality():
    torch.manual_seed(0)
    cfg = tiny_mistral()
    params0 = init_params(cfg, 0, device="cpu")
    params_init = _copy(params0)  # the optimizer updates params0 in place

    emb_sets, gen_sets = load_train_dirs([TOY_DIR])
    ds = GritDataset(emb_sets, gen_sets, mode="unified", train_group_size=4, seed=1)
    coll = GritCollator(ByteTokenizer(), query_max_len=96, passage_max_len=96,
                        generative_max_len=96)
    STEPS, BS = 300, 8
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.permutation(len(ds))
                            for _ in range(STEPS * BS // len(ds) + 1)])
    tc = TrainConfig(mode="unified", total_steps=STEPS, learning_rate=3e-3, warmup_ratio=0.0,
                     remat=False, temperature=0.05)
    state = init_train_state(params0, tc)
    first = last = None
    for s in range(STEPS):
        feats = [ds[int(i)] for i in order[s * BS:(s + 1) * BS]]
        state, m = train_step(state, coll(feats), cfg, tc)
        last = (float(m.loss_emb), float(m.loss_gen))
        if s == 0:
            first = last

    # (a) both losses drop
    assert last[0] < 0.8 * first[0], f"loss_emb {first[0]} -> {last[0]}"
    assert last[1] < 0.25 * first[1], f"loss_gen {first[1]} -> {last[1]}"
    params_tr = _copy(state.params)

    # (b) held-out retrieval improves over the initial encoder
    ndcg_init = _retrieval_ndcg(cfg, params_init)
    ndcg_tr = _retrieval_ndcg(cfg, params_tr)
    assert ndcg_tr > ndcg_init + 0.03, f"ndcg@10 {ndcg_init} -> {ndcg_tr}"

    # (c) greedy exact match on the memorizable toy answers
    gen_rows = [r for s_ in gen_sets for r in s_][:10]
    em_init = _gen_exact_match(cfg, params_init, gen_rows)
    em_tr = _gen_exact_match(cfg, params_tr, gen_rows)
    assert em_tr >= 0.8, f"trained EM {em_tr}"
    assert em_tr > em_init, f"EM {em_init} -> {em_tr}"
    print(f"losses emb {first[0]:.4f} -> {last[0]:.4f}, gen {first[1]:.4f} -> {last[1]:.4f}; "
          f"ndcg@10 {ndcg_init:.4f} -> {ndcg_tr:.4f}; exact match {em_init} -> {em_tr}")
