"""QA answer metrics: SQuAD-style EM / substring match / token F1.

Same metric definitions as the reference (rag/tasks/evaluation.py:12-81),
implemented from the SQuAD specification: lowercase, strip punctuation,
drop English articles, collapse whitespace; best score over gold answers.
A copy of `gritlm_tpu.rag.metrics` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, Iterable, List


_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = str.maketrans("", "", string.punctuation)


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = s.translate(_PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def _best_over_golds(fn, prediction: str, golds: Iterable[str]) -> float:
    return max((fn(prediction, g) for g in golds), default=0.0)


def exact_match_score(prediction: str, golds: Iterable[str]) -> float:
    return _best_over_golds(
        lambda p, g: float(normalize_answer(p) == normalize_answer(g)),
        prediction, golds,
    )


def match_score(prediction: str, golds: Iterable[str]) -> float:
    """Gold answer contained in the prediction (lenient 'match' metric the
    reference reports alongside EM for generative answers)."""
    return _best_over_golds(
        lambda p, g: float(normalize_answer(g) in normalize_answer(p)),
        prediction, golds,
    )


def _f1(prediction: str, gold: str) -> float:
    p_toks = normalize_answer(prediction).split()
    g_toks = normalize_answer(gold).split()
    if not p_toks or not g_toks:
        return float(p_toks == g_toks)
    common = Counter(p_toks) & Counter(g_toks)
    n_same = sum(common.values())
    if n_same == 0:
        return 0.0
    precision = n_same / len(p_toks)
    recall = n_same / len(g_toks)
    return 2 * precision * recall / (precision + recall)


def f1_score(prediction: str, golds: Iterable[str]) -> float:
    return _best_over_golds(_f1, prediction, golds)


def evaluate_answers(
    predictions: List[str], gold_answers: List[List[str]]
) -> Dict[str, float]:
    assert len(predictions) == len(gold_answers)
    n = max(len(predictions), 1)
    em = sum(exact_match_score(p, g) for p, g in zip(predictions, gold_answers))
    mt = sum(match_score(p, g) for p, g in zip(predictions, gold_answers))
    f1 = sum(f1_score(p, g) for p, g in zip(predictions, gold_answers))
    return {
        "exact_match": 100.0 * em / n,
        "match": 100.0 * mt / n,
        "f1": 100.0 * f1 / n,
    }
