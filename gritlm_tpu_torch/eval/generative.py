"""Generative evaluation: chat formatting, loglikelihood scoring, task metrics
(port of gritlm_tpu.eval.generative).

The reference drives external harnesses for generative evals (open-instruct
fork + bigcode-evaluation-harness via scripts/generative_eval.sh, README.md:
411-447). Here the same task styles are first-class and run on the model's
device:

  - chat prompt formats gritlm/zephyr/tulu/mistral (eval_mteb.py:1050-1067)
  - batched continuation log-likelihood (one causal forward per option
    batch, K1 for the attention; label-masked logprob sum) → multiple-choice
    accuracy (MMLU-style)
  - greedy generation + answer extraction → GSM8K-style numeric EM and
    TyDiQA-style EM/F1
  - pass@1 execution in a subprocess for HumanEval-style code tasks

Everything batches over examples; generation goes through GritLM.generate
(prefill through K1, decode through K3).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# ------------------------------------------------------------- chat formats

CHAT_FORMATS = {
    "gritlm": ("<s>", "<|user|>\n", "\n<|assistant|>\n", "</s>"),
    "zephyr": ("<s>", "<|user|>\n", "</s>\n<|assistant|>\n", "</s>"),
    "tulu": ("<s>", "<|user|>\n", "\n<|assistant|>\n", "</s>"),
    "mistral": ("<s>", "[INST] ", " [/INST]", "</s>"),
}


def format_chat(
    turns: Sequence[str], fmt: str = "gritlm", add_bos: bool = False
) -> str:
    """[user, assistant, user, ...] → one prompt string ending after the last
    user turn's assistant-start marker (ready for generation). An odd-length
    list means the last user turn awaits a reply."""
    bos, user, asst, eos = CHAT_FORMATS[fmt]
    out = bos if add_bos else ""
    for i, t in enumerate(turns):
        if i % 2 == 0:
            out += f"{user}{t}{asst}"
        else:
            out += f"{t}{eos}"
    return out


# ------------------------------------------------- open-instruct task prompts
#
# The reference runs MMLU/GSM8K through an open-instruct fork with
# --use_chat_format --chat_formatting_function
# eval.templates.create_prompt_with_gritlm_chat_format
# (scripts/generative_eval.sh:8,27-37; README.md:436-445). The fork itself is
# not vendored in the reference tree, so these builders implement the
# open-instruct conventions (subject header + lettered choices + "Answer:"
# for MMLU; "Question:/Answer:" exemplar blocks for GSM8K CoT) wrapped in the
# gritlm chat turns; the JAX package's tests pin the exact strings as golden
# fixtures, and the port's tests hold these builders equal to them.

MMLU_HEADER = (
    "The following are multiple choice questions (with answers) about "
    "{subject}.\n\n"
)
MMLU_LETTERS = "ABCDEFGH"


def mmlu_prompt(
    subject: str, question: str, choices: Sequence[str],
    few_shot: Sequence[dict] = (), fmt: str = "gritlm",
) -> str:
    """open-instruct eval.mmlu chat prompt: one user turn holding the
    subject header, optional few-shot blocks (question + lettered choices +
    'Answer: <letter>'), then the target question ending in 'Answer:'. The
    model's answer is scored over the letter continuations ' A'..' D'."""
    def block(q, ch, ans=None):
        s = q.strip() + "\n"
        for j, c in enumerate(ch):
            s += f"{MMLU_LETTERS[j]}. {c}\n"
        s += "Answer:"
        if ans is not None:
            s += f" {MMLU_LETTERS[ans]}\n\n"
        return s

    body = MMLU_HEADER.format(subject=subject.replace("_", " "))
    for s in few_shot:
        body += block(s["question"], s["choices"], s["answer"])
    body += block(question, choices)
    return format_chat([body], fmt=fmt)


def gsm8k_prompt(
    question: str, few_shot: Sequence[dict] = (), fmt: str = "gritlm",
    cot: bool = True,
) -> str:
    """open-instruct eval.gsm chat prompt: the n-shot CoT exemplars and the
    target question ride in ONE user turn as 'Question:'/'Answer:' blocks
    (n_shot=8 in the reference run, scripts/generative_eval.sh:24), and the
    'Answer:' cue for the target question is appended AFTER the chat
    template (open-instruct run_eval: `prompt += "Answer:" if prompt[-1]
    in ["\\n", " "] else " Answer:"`)."""
    parts = ["Answer the following questions.\n"]
    for s in few_shot:
        sol = s.get("solution") if cot else None
        ans = sol if sol is not None else str(s["answer"])
        parts.append(f"Question: {s['question'].strip()}\nAnswer: {ans.strip()}")
    parts.append(f"Question: {question.strip()}")
    prompt = format_chat(["\n\n".join(parts)], fmt=fmt)
    return prompt + ("Answer:" if prompt[-1] in ("\n", " ") else " Answer:")


def eval_mmlu(
    model, examples: Sequence[dict], fmt: str = "gritlm",
    few_shot: Sequence[dict] = (), max_length: int = 2048,
    batch_size: int = 32,
) -> Dict[str, float]:
    """examples: {"subject": str, "question": str, "choices": [str],
    "answer": int}. open-instruct MMLU scoring: argmax over the LETTER
    continuations (' A'..' D'), batched across examples."""
    pairs_ctx: List[str] = []
    pairs_opt: List[str] = []
    owner: List[int] = []
    for i, ex in enumerate(examples):
        ctx = mmlu_prompt(ex.get("subject", "miscellaneous"), ex["question"],
                          ex["choices"], few_shot=few_shot, fmt=fmt)
        for j in range(len(ex["choices"])):
            pairs_ctx.append(ctx)
            pairs_opt.append(" " + MMLU_LETTERS[j])
            owner.append(i)
    scores = np.empty(len(pairs_ctx), np.float32)
    for a in range(0, len(pairs_ctx), batch_size):
        scores[a:a + batch_size] = _loglikelihood_batch(
            model, pairs_ctx[a:a + batch_size], pairs_opt[a:a + batch_size],
            max_length,
        )
    owner_arr = np.asarray(owner)
    correct = sum(
        int(int(np.argmax(scores[owner_arr == i])) == ex["answer"])
        for i, ex in enumerate(examples)
    )
    n = max(len(examples), 1)
    return {"accuracy": 100.0 * correct / n, "n": len(examples)}


# -------------------------------------------------------- loglikelihood core

@torch.inference_mode()
def _loglikelihood_batch(model, contexts: List[str], continuations: List[str],
                         max_length: int) -> np.ndarray:
    """Sum log P(continuation | context) per pair, one batched causal
    forward. Continuation token spans are found by tokenizing the context
    alone and subtracting lengths (same convention as lm-eval harnesses)."""
    from gritlm_tpu_torch.models.transformer import forward_lm

    tok = model.tokenizer
    full = [c + x for c, x in zip(contexts, continuations)]
    enc = tok(full, max_length=max_length, add_special_tokens=True)
    ids = torch.as_tensor(enc["input_ids"], device=model.device).long()
    mask = torch.as_tensor(enc["attention_mask"], device=model.device)
    ctx_lens = torch.as_tensor(
        [len(tok._encode_one(c, add_special_tokens=True)) for c in contexts],
        device=model.device,
    )
    logits, _, _ = forward_lm(model.params, model.config, ids,
                              attention_mask=mask, causal=True)
    logits = logits.float()
    # token t is predicted from position t-1; gather target logits and
    # subtract the row logsumexp instead of materializing [B,S,V] log-probs
    tgt = ids[:, 1:]
    picked = torch.gather(logits[:, :-1], -1, tgt[..., None])[..., 0]
    pred = picked - torch.logsumexp(logits[:, :-1], dim=-1)
    pos = torch.arange(ids.shape[1] - 1, device=ids.device)[None, :]
    span = (pos >= (ctx_lens[:, None] - 1)) & (mask[:, 1:] > 0)
    return (pred * span).sum(dim=1).cpu().numpy().astype(np.float32)


def score_continuations(
    model, context: str, options: Sequence[str],
    max_length: int = 1024, batch_size: int = 8,
) -> List[float]:
    scores: List[float] = []
    for i in range(0, len(options), batch_size):
        chunk = list(options[i:i + batch_size])
        scores.extend(_loglikelihood_batch(
            model, [context] * len(chunk), chunk, max_length))
    return scores


# ------------------------------------------------------------------- tasks

def eval_multiple_choice(
    model, examples: Sequence[dict], fmt: str = "gritlm",
    max_length: int = 1024, batch_size: int = 32,
) -> Dict[str, float]:
    """examples: {"question": str, "choices": [str], "answer": int}.
    MMLU-style: pick argmax continuation loglik of ' <choice>'. Every
    (example, choice) pair is one row of the flattened loglikelihood
    batch, so MMLU-scale runs fill the device across examples instead of
    looping example-by-example."""
    pairs_ctx: List[str] = []
    pairs_opt: List[str] = []
    owner: List[int] = []
    for i, ex in enumerate(examples):
        ctx = format_chat([ex["question"]], fmt=fmt)
        for c in ex["choices"]:
            pairs_ctx.append(ctx)
            pairs_opt.append(" " + c)
            owner.append(i)
    scores = np.empty(len(pairs_ctx), np.float32)
    for a in range(0, len(pairs_ctx), batch_size):
        scores[a:a + batch_size] = _loglikelihood_batch(
            model, pairs_ctx[a:a + batch_size], pairs_opt[a:a + batch_size],
            max_length,
        )
    owner_arr = np.asarray(owner)
    correct = 0
    for i, ex in enumerate(examples):
        s = scores[owner_arr == i]
        correct += int(int(np.argmax(s)) == ex["answer"])
    n = max(len(examples), 1)
    return {"accuracy": 100.0 * correct / n, "n": len(examples)}


_NUM_RE = re.compile(r"-?\$?[\d,]*\.?\d+")


def extract_last_number(text: str) -> Optional[str]:
    hits = _NUM_RE.findall(text)
    if not hits:
        return None
    return hits[-1].replace(",", "").replace("$", "").rstrip(".")


def eval_gsm8k(
    model, examples: Sequence[dict], fmt: str = "gritlm",
    few_shot: Sequence[dict] = (), max_new_tokens: int = 256,
    batch_size: int = 4, max_length: int = 2048,
) -> Dict[str, float]:
    """examples: {"question": str, "answer": str-or-number}. Few-shot CoT
    exemplars ride in one user turn as Question:/Answer: blocks
    (open-instruct eval.gsm convention, see gsm8k_prompt); the predicted
    answer is the last number in the generation."""
    prompts = [gsm8k_prompt(ex["question"], few_shot, fmt=fmt)
               for ex in examples]
    preds: List[str] = []
    for i in range(0, len(prompts), batch_size):
        outs = model.generate(prompts[i:i + batch_size],
                              max_new_tokens=max_new_tokens,
                              max_length=max_length)
        preds.extend(outs if isinstance(outs, list) else [outs])
    em = 0
    for ex, p in zip(examples, preds):
        gold = extract_last_number(str(ex["answer"]))
        got = extract_last_number(p)
        em += int(gold is not None and got == gold)
    n = max(len(examples), 1)
    return {"exact_match": 100.0 * em / n, "n": len(examples),
            "predictions": preds}


def eval_qa_generation(
    model, examples: Sequence[dict], fmt: str = "gritlm",
    max_new_tokens: int = 32, batch_size: int = 4, max_length: int = 2048,
) -> Dict[str, float]:
    """examples: {"question": str, "answers": [str]} (+ optional "context").
    TyDiQA-style generation scored with SQuAD EM/F1."""
    from gritlm_tpu_torch.rag.metrics import evaluate_answers

    prompts = []
    for ex in examples:
        q = ex["question"]
        if ex.get("context"):
            q = f"{ex['context']}\n\n{q}"
        prompts.append(format_chat([q], fmt=fmt))
    preds: List[str] = []
    for i in range(0, len(prompts), batch_size):
        outs = model.generate(prompts[i:i + batch_size],
                              max_new_tokens=max_new_tokens,
                              max_length=max_length)
        preds.extend(outs if isinstance(outs, list) else [outs])
    metrics = evaluate_answers(preds, [list(ex["answers"]) for ex in examples])
    metrics["n"] = len(examples)
    return metrics


# -------------------------------------------------------------- code (pass@1)

def run_candidate(candidate: str, test_code: str, timeout: float = 5.0) -> bool:
    """Execute candidate + tests in a fresh interpreter subprocess with a
    timeout (the bigcode-harness execution model, minimally). A direct
    `python -c` subprocess rather than multiprocessing: fork() of a process
    whose runtime has threads (CUDA, PyTorch's pools) is unsafe, and spawn
    re-imports the parent's __main__ (broken under `python -` / embedded
    runners).

    `timeout` bounds the CANDIDATE's execution, enforced inside the child
    via SIGALRM/setitimer — interpreter startup (seconds under host load)
    must not count against it. The outer subprocess.run timeout is only a
    generous backstop for a wedged interpreter."""
    import subprocess
    import sys

    prog = (
        "import signal\n"
        f"signal.setitimer(signal.ITIMER_REAL, {float(timeout)!r})\n"
        + candidate + "\n" + test_code
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", prog],
            capture_output=True, timeout=timeout + 60.0,
        )
        return proc.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def eval_code_pass1(
    model, examples: Sequence[dict], fmt: str = "gritlm",
    max_new_tokens: int = 256, max_length: int = 2048, timeout: float = 5.0,
    batch_size: int = 4,
) -> Dict[str, float]:
    """examples: {"prompt": str (function signature + docstring),
    "test": str (asserts)}. HumanEvalPack-style instruction prompt; the
    generated body is concatenated after the prompt and executed. Generation
    is batched (one decode loop per `batch_size` prompts); only the
    execution in subprocesses is sequential."""
    prompts = [
        format_chat(
            ["Complete the following Python function:\n\n" + ex["prompt"]],
            fmt=fmt,
        )
        for ex in examples
    ]
    preds: List[str] = []
    for i in range(0, len(prompts), batch_size):
        outs = model.generate(prompts[i:i + batch_size],
                              max_new_tokens=max_new_tokens,
                              max_length=max_length)
        preds.extend(outs if isinstance(outs, list) else [outs])
    passed = 0
    for ex, out in zip(examples, preds):
        code = ex["prompt"] + "\n" + _strip_markdown(out)
        passed += int(run_candidate(code, ex["test"], timeout))
    n = max(len(examples), 1)
    return {"pass@1": 100.0 * passed / n, "n": len(examples),
            "predictions": preds}


def _strip_markdown(text: str) -> str:
    m = re.search(r"```(?:python)?\n(.*?)```", text, re.DOTALL)
    return m.group(1) if m else text
