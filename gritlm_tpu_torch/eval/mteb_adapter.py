"""MTEB harness adapter (port of gritlm_tpu.eval.mteb_adapter).

Drives the stock `mteb` package (when installed and datasets are reachable)
with the port's GritLM encoder — the counterpart of evaluation/eval_mteb.py.
The giant per-model instruction dictionaries of the reference
(eval_mteb.py:10-839) are *data*: supply any of them as a JSON file via
`instruction_file`; a compact built-in set covers the QUICK_EVAL smoke
subset. Instruction formats gritlm/zephyr/tulu/mistral match
eval_mteb.py:1050-1067. The instruction, few-shot and rerank-template
files under `instructions/` are the port's own copies of the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

# 12-task quick smoke subset spanning all 7 MTEB task types
# (reference QUICK_EVAL, evaluation/eval_mteb.py:1018-1038)
QUICK_EVAL = [
    # classification
    "Banking77Classification",
    "EmotionClassification",
    # clustering
    "MedrxivClusteringS2S",
    # pair classification
    "TwitterSemEval2015",
    # reranking
    "AskUbuntuDupQuestions",
    # retrieval
    "ArguAna",
    "NFCorpus",
    "SciFact",
    # sts
    "BIOSSES",
    "STS17",
    "STSBenchmark",
    # summarization
    "SummEval",
]

# Compact instruction set for the smoke subset (task → instruction, or
# {"query": ..., "corpus": ...} for asymmetric retrieval tasks).
DEFAULT_INSTRUCTIONS: Dict[str, object] = {
    "Banking77Classification": "Given a online banking query, find the corresponding intents",
    "EmotionClassification": "Classify the emotion expressed in the given Twitter message into one of the six emotions: anger, fear, joy, love, sadness, and surprise",
    "MedrxivClusteringS2S": "Identify the main category of Medrxiv papers based on the titles",
    "TwitterSemEval2015": "Retrieve tweets that are semantically similar to the given tweet",
    "AskUbuntuDupQuestions": "Retrieve duplicate questions from AskUbuntu forum",
    "ArguAna": {"query": "Given a claim, find documents that refute the claim", "corpus": ""},
    "NFCorpus": {"query": "Given a question, retrieve relevant documents that best answer the question", "corpus": ""},
    "SciFact": {"query": "Given a scientific claim, retrieve documents that support or refute the claim", "corpus": ""},
    "BIOSSES": "Retrieve semantically similar text.",
    "STS17": "Retrieve semantically similar text.",
    "STSBenchmark": "Retrieve semantically similar text.",
    "SummEval": "Given a news summary, retrieve other semantically similar summaries",
}


def format_instruction(instruction: str, fmt: str = "gritlm") -> str:
    """Wrap a raw instruction in the model's chat/embed format (reference
    eval_mteb.py:1050-1067)."""
    if not instruction:
        if fmt == "gritlm":
            return "<|embed|>\n"
        return ""
    if fmt == "gritlm":
        return f"<|user|>\n{instruction}\n<|embed|>\n"
    if fmt == "zephyr":
        return f"<|user|>\n{instruction}</s>\n<|assistant|>\n"
    if fmt == "tulu":
        return f"<|user|>\n{instruction}\n<|assistant|>\n"
    if fmt == "mistral":
        return f"[INST] {instruction} [/INST] "
    raise ValueError(f"Unknown instruction format: {fmt}")


class MTEBEncoder:
    """The object handed to MTEB: encode / encode_queries / encode_corpus with
    a per-task instruction bound (reference binds via functools.partial,
    eval_mteb.py:1195-1199)."""

    def __init__(self, model, task_instruction, fmt: str = "gritlm",
                 batch_size: int = 32, max_length: int = 512):
        self.model = model
        self.batch_size = batch_size
        self.max_length = max_length
        if isinstance(task_instruction, dict):
            qi = task_instruction.get("query", "")
            ci = task_instruction.get("corpus", "")
        else:
            qi = ci = task_instruction or ""
        self.q_instruction = format_instruction(qi, fmt)
        self.c_instruction = format_instruction(ci, fmt)

    def encode(self, sentences, **kw):
        return self.model.encode(
            list(sentences), instruction=self.q_instruction,
            batch_size=self.batch_size, max_length=self.max_length,
        )

    def encode_queries(self, queries, **kw):
        return self.model.encode_queries(
            list(queries), instruction=self.q_instruction,
            batch_size=self.batch_size, max_length=self.max_length,
        )

    def encode_corpus(self, corpus, **kw):
        return self.model.encode_corpus(
            list(corpus), instruction=self.c_instruction,
            batch_size=self.batch_size, max_length=self.max_length,
        )


_INSTRUCTIONS_JSON = os.path.join(
    os.path.dirname(__file__), "instructions", "mteb_instructions.json"
)


def load_instruction_set(name: str = "e5") -> Dict[str, object]:
    """Full per-task instruction table for one of the shipped sets
    ('e5' — the GritLM eval default —, 'medi2', 'instructor-xl', …).
    The strings are benchmark prompt data from the reference's evaluation
    setup (eval_mteb.py:10-839), shipped as JSON. Nested
    {task_type: {task: instr}} flattens to {task: instr}; CQADupstack
    subforums inherit the CQADupstackRetrieval entry
    (eval_mteb.py:1173-1174)."""
    with open(_INSTRUCTIONS_JSON) as f:
        sets = json.load(f)
    if name not in sets:
        raise ValueError(f"unknown instruction set {name!r}; "
                         f"available: {sorted(sets)}")
    table: Dict[str, object] = {}
    for per_type in sets[name].values():
        table.update(per_type)
    from gritlm_tpu_torch.eval.aggregate import CQADUPSTACK_SUBFORUMS

    cqa = table.get("CQADupstackRetrieval")
    if cqa is not None:
        for sub in CQADUPSTACK_SUBFORUMS:
            table.setdefault(sub, cqa)
    else:
        # sets like medi2 enumerate the subforums instead of the parent
        for sub in CQADUPSTACK_SUBFORUMS:
            if sub in table:
                table["CQADupstackRetrieval"] = table[sub]
                break
    return table


_FEWSHOT_JSON = os.path.join(
    os.path.dirname(__file__), "instructions", "mteb_fewshot.json"
)


def apply_few_shot(
    instruction, task_name: str, instruction_set: str = "e5"
):
    """Append the per-task few-shot example sentence to an instruction
    (reference eval_mteb.py:1180-1191: retrieval instructions are
    {query, corpus} dicts, each side gets its own example pair formatted
    with the set's few-shot template; other task types append one pair)."""
    with open(_FEWSHOT_JSON) as f:
        data = json.load(f)
    shots = data["shots"].get(instruction_set, {})
    prompt = data["prompt"].get(instruction_set, {})
    for task_type, tasks in shots.items():
        if task_name not in tasks:
            continue
        ex = tasks[task_name]
        if isinstance(instruction, dict):
            tmpl = prompt.get("Retrieval", "")
            return {
                k: v + tmpl.format(*ex[k]) if k in ex else v
                for k, v in instruction.items()
            }
        tmpl = prompt.get("Other", "")
        return instruction + tmpl.format(*ex)
    return instruction


def load_instructions(
    instruction_file: Optional[str] = None,
    instruction_set: Optional[str] = None,
) -> Dict[str, object]:
    table = dict(DEFAULT_INSTRUCTIONS)
    if instruction_set:
        table.update(load_instruction_set(instruction_set))
    if instruction_file:
        with open(instruction_file) as f:
            table.update(json.load(f))
    return table


def run_mteb(
    model,
    tasks: Sequence[str] = tuple(QUICK_EVAL),
    output_dir: str = "results",
    fmt: str = "gritlm",
    instruction_file: Optional[str] = None,
    instruction_set: Optional[str] = "e5",
    batch_size: int = 32,
    max_length: int = 512,
    skip_existing: bool = True,
    few_shot: bool = False,
) -> Dict[str, object]:
    """Run MTEB tasks (requires the `mteb` package + dataset access).
    Per-task skip-if-exists mirrors eval_mteb.py:1107-1112; `few_shot`
    appends the set's in-instruction examples (eval_mteb.py:841-1078)."""
    try:
        import mteb
    except ImportError as e:
        raise ImportError(
            "the `mteb` package is not installed in this environment; "
            "use gritlm_tpu_torch.eval.retrieval.evaluate_retrieval for offline eval"
        ) from e

    instructions = load_instructions(instruction_file, instruction_set)
    results = {}
    for task_name in tasks:
        out_path = os.path.join(output_dir, f"{task_name}.json")
        if skip_existing and os.path.exists(out_path):
            continue
        instruction = instructions.get(task_name, "")
        if few_shot:
            instruction = apply_few_shot(
                instruction, task_name, instruction_set or "e5"
            )
        encoder = MTEBEncoder(
            model, instruction, fmt=fmt,
            batch_size=batch_size, max_length=max_length,
        )
        evaluation = mteb.MTEB(tasks=[task_name])
        res = evaluation.run(
            encoder, output_folder=output_dir, eval_splits=["test"]
        )
        results[task_name] = res
    return results
