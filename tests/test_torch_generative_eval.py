"""The port's generative evaluation (prompt builders, the log-likelihood
scorer, multiple choice, GSM8K / QA / code generation, the candidate
runner) against the JAX package on tiny_mistral.

Both packages get the same float32 weights (`params_from_jax`) and the same
examples; the port runs on the CPU, its kernels as their plain versions.
Tolerances: log-likelihoods within 1e-4 (float32 forwards summing in
another order); accuracies and greedy predictions equal.
"""

import jax
import numpy as np
import pytest
import torch

import gritlm_tpu.eval.generative as jgen
import gritlm_tpu_torch.eval.generative as pgen
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    jparams = jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tiny_mistral(),
                              device="cpu")
    return (JaxGritLM(jax_tiny_mistral(), params=jparams, mode="unified"),
            GritLM(tiny_mistral(), params=tparams, mode="unified", device="cpu"))


SHOTS = [{"question": "1+1?", "choices": ["1", "2"], "answer": 1, "solution": "It is 2."},
         {"question": " Sky? ", "choices": ["blue", "red", "x"], "answer": 0}]
PROMPT_CASES = {
    "format_chat": lambda m: [m.format_chat(t, f, b) for f in m.CHAT_FORMATS
                              for t in (["hi"], ["hi", "yo", "again"], ["a", "b"])
                              for b in (False, True)],
    "mmlu_prompt": lambda m: [m.mmlu_prompt("high_school_math", "2+2?", ["3", "4", "5", "6"],
                                            few_shot=s, fmt=f)
                              for s in ((), SHOTS) for f in ("gritlm", "mistral")],
    "gsm8k_prompt": lambda m: [m.gsm8k_prompt(" Q? ", s, fmt=f, cot=c) for s in ((), SHOTS)
                               for f in ("gritlm", "mistral") for c in (True, False)],
    "extract_last_number": lambda m: [m.extract_last_number(t) for t in (
        "so the answer is 42.", "costs $1,234.50 total", "no digits", "-3 and 7.", "x .5")],
    "strip_markdown": lambda m: [m._strip_markdown(t) for t in (
        "```python\ndef f(): pass\n```", "```\nx=1\n```tail", "plain")],
    "constants": lambda m: (m.CHAT_FORMATS, m.MMLU_HEADER, m.MMLU_LETTERS),
}


@pytest.mark.parametrize("case", sorted(PROMPT_CASES))
def test_prompt_builders_match_jax(case):
    assert PROMPT_CASES[case](pgen) == PROMPT_CASES[case](jgen)


def test_loglikelihood_batch_matches_jax(models):
    jm, tm = models
    ctx = [pgen.format_chat(["Pick a word."]), "short", pgen.format_chat(["a longer one " * 3])]
    cont = [" apple", " banana split", " c"]
    got = pgen._loglikelihood_batch(tm, ctx, cont, 128)
    want = jgen._loglikelihood_batch(jm, ctx, cont, 128)
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # truncation at max_length drops the continuation's tail on both sides
    np.testing.assert_allclose(pgen._loglikelihood_batch(tm, ctx, cont, 24),
                               jgen._loglikelihood_batch(jm, ctx, cont, 24), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pgen.score_continuations(tm, ctx[0], cont, batch_size=2),
                               jgen.score_continuations(jm, ctx[0], cont, batch_size=2),
                               atol=1e-4, rtol=0)


MC = [{"question": f"question {i}?", "choices": [f"c{j}" for j in range(2 + i % 3)],
       "answer": i % 2} for i in range(6)]
MMLU = [{"subject": "astronomy", "question": f"q{i}", "choices": ["a", "b", "c", "d"],
         "answer": i % 4} for i in range(4)]


@pytest.mark.parametrize("task", ["multiple_choice", "mmlu"])
def test_choice_scoring_matches_jax(models, monkeypatch, task):
    """Equal accuracy, and the pairs' scores within 1e-4, batched across
    examples as in the JAX package."""
    jm, tm = models
    scores = {}
    for name, mod, model in (("jax", jgen, jm), ("port", pgen, tm)):
        real = mod._loglikelihood_batch
        seen = scores.setdefault(name, [])
        monkeypatch.setattr(mod, "_loglikelihood_batch",
                            lambda *a, real=real, seen=seen: seen.append(real(*a)) or seen[-1])
        if task == "mmlu":
            scores[name + "_m"] = mod.eval_mmlu(model, MMLU, few_shot=SHOTS[:1], batch_size=5)
        else:
            scores[name + "_m"] = mod.eval_multiple_choice(model, MC, batch_size=5)
    assert scores["port_m"] == scores["jax_m"]
    np.testing.assert_allclose(np.concatenate(scores["port"]), np.concatenate(scores["jax"]),
                               atol=1e-4, rtol=0)


def test_generation_tasks_match_jax(models):
    """Greedy GSM8K-style, QA and code generation: the same predictions and
    metrics (K1 prefill and K3 decode on CUDA, their plain versions here)."""
    jm, tm = models
    gsm = [{"question": f"What is {i} plus {i}?", "answer": str(2 * i)} for i in range(3)]
    qa = [{"question": "Capital of France?", "answers": ["Paris"]},
          {"question": "Who?", "answers": ["me", "you"], "context": "It was me."},
          {"question": "Color?", "answers": ["blue"]}]
    code = [{"prompt": "def f(x):\n    \"\"\"Return x + 1.\"\"\"\n", "test": "assert True"}]
    want = (jgen.eval_gsm8k(jm, gsm, few_shot=SHOTS[:1], max_new_tokens=6, batch_size=2),
            jgen.eval_qa_generation(jm, qa, max_new_tokens=5, batch_size=2),
            jgen.eval_code_pass1(jm, code, max_new_tokens=4, batch_size=2, timeout=20.0))
    got = (pgen.eval_gsm8k(tm, gsm, few_shot=SHOTS[:1], max_new_tokens=6, batch_size=2),
           pgen.eval_qa_generation(tm, qa, max_new_tokens=5, batch_size=2),
           pgen.eval_code_pass1(tm, code, max_new_tokens=4, batch_size=2, timeout=20.0))
    assert got == want
    assert len(got[0]["predictions"]) == 3 and got[1]["n"] == 3


@pytest.mark.parametrize("candidate,test,expect", [
    ("def f(x):\n    return x + 1", "assert f(1) == 2", True),
    ("def f(x):\n    return x", "assert f(1) == 2", False),
    ("def f(x):\n    while True: pass", "f(1)", False),  # the child's timer ends it
    ("def f(:", "", False),
])
def test_run_candidate_matches_jax(candidate, test, expect):
    """A `python -c` subprocess with the candidate's own timer; the same
    verdict as the JAX runner (timeouts short here, the child's interpreter
    start not counted)."""
    assert pgen.run_candidate(candidate, test, timeout=1.0) is expect
    assert jgen.run_candidate(candidate, test, timeout=1.0) is expect
