"""RAG task plugins: pluggable query/target extraction + per-task metrics.

Counterpart of the reference's task system (rag/tasks/base.py:17-122,
rag/tasks/qa.py:7-41, rag/tasks/__init__.py:3-10). Host-side pure Python —
tasks only shape examples and score strings; everything device-side lives in
the engine. Redesigned as a registry of small classes instead of a module
registry; data iteration is shard-strided by (rank, count), so the same code
path covers one host and many. A copy of `gritlm_tpu.rag.tasks` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
import random
from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Type

from gritlm_tpu_torch.rag.metrics import (
    exact_match_score,
    f1_score,
    match_score,
)

logger = logging.getLogger(__name__)

TASK_REGISTRY: Dict[str, Type["BaseTask"]] = {}


def register_task(name: str) -> Callable[[Type["BaseTask"]], Type["BaseTask"]]:
    def deco(cls: Type["BaseTask"]) -> Type["BaseTask"]:
        TASK_REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_task(name: str, **kwargs) -> "BaseTask":
    """Instantiate a registered task (reference get_task, rag/tasks/__init__.py:7-10)."""
    if name not in TASK_REGISTRY:
        raise ValueError(f"unknown task {name!r}; available: {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name](**kwargs)


def data_iterator(
    filenames,
    shard_rank: int = -1,
    shard_count: int = -1,
    repeat_if_less_than_shard_count: bool = False,
) -> Iterator[dict]:
    """Stream JSONL examples, rank-strided across hosts (semantics of
    BaseTask.data_iterator, rag/tasks/base.py:17-36: global line counter mod
    shard_count; keeps re-reading until every shard saw >=1 example when
    `repeat_if_less_than_shard_count`)."""
    if isinstance(filenames, str):
        filenames = [filenames]
    total = 0
    while True:
        for fname in filenames:
            with open(fname, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    total += 1
                    if shard_rank > -1 and total % shard_count != shard_rank:
                        continue
                    yield json.loads(line)
        if not (repeat_if_less_than_shard_count and total < shard_count):
            return


def batch_iterator(
    examples: Iterable[dict],
    batch_size: int,
    drop_last: bool = False,
    shuffle: bool = False,
    seed: Optional[int] = None,
) -> Iterator[Dict[str, list]]:
    """Columnar batches with a `__size__` count (rag/tasks/base.py:38-55)."""
    if shuffle:
        pool = list(examples)
        random.Random(seed).shuffle(pool)
        examples = iter(pool)
    batch: Dict[str, list] = defaultdict(list)
    n = 0
    for ex in examples:
        for k, v in ex.items():
            batch[k].append(v)
        n += 1
        if n == batch_size:
            batch["__size__"] = n
            yield dict(batch)
            batch, n = defaultdict(list), 0
    if n and not drop_last:
        batch["__size__"] = n
        yield dict(batch)


class BaseTask:
    """Minimal task: `query` + string `target` fields; accuracy metric
    (rag/tasks/base.py:13-85)."""

    name = "base"
    metrics: Sequence[str] = ("accuracy",)

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random(0)

    def process(self, example: dict) -> dict:
        if not isinstance(example.get("query"), str):
            raise ValueError("base task requires a string `query` field")
        if not isinstance(example.get("target"), str):
            raise ValueError("base task requires a string `target` field")
        example.setdefault("passages", [{"title": "", "text": ""}])
        return example

    def gold_answers(self, example: dict) -> List[str]:
        return [example["target"]]

    def evaluation(self, prediction: str, ground_truths: List[str]) -> Dict[str, float]:
        return {"accuracy": exact_match_score(prediction, ground_truths)}

    def evaluation_postprocessing(self, metrics, dataset_with_predictions):
        return metrics, dataset_with_predictions


@register_task("base")
class _Base(BaseTask):
    pass


@register_task("qa")
class QATask(BaseTask):
    """Open-domain QA: `question` + `answers` list; EM/match/F1
    (rag/tasks/qa.py:7-41)."""

    metrics = ("exact_match", "match", "f1")

    def process(self, example: dict) -> dict:
        if "target" not in example and "answers" in example:
            example["target"] = self.rng.choice(example["answers"])
        example.setdefault("passages", [{"title": "", "text": ""}])
        example.setdefault("metadata", {})
        example["query"] = example["question"]
        return example

    def gold_answers(self, example: dict) -> List[str]:
        return list(example.get("answers") or [example["target"]])

    def evaluation(self, prediction: str, ground_truths: List[str]) -> Dict[str, float]:
        return {
            "exact_match": exact_match_score(prediction, ground_truths),
            "match": match_score(prediction, ground_truths),
            "f1": f1_score(prediction, ground_truths),
        }


def filter_results_by_id(
    batch_metadata: Optional[List[dict]],
    passages: List[Sequence[dict]],
    scores: List[Sequence[float]],
    topk: int,
) -> tuple:
    """Drop self-retrievals (passage id == source example id) from top-k,
    re-appending violators at the end if too few survive
    (rag/tasks/base.py:87-122)."""
    if batch_metadata is None:
        logger.warning("filter_results_by_id: no metadata — returning top-k as-is")
        return [list(p[:topk]) for p in passages], [list(s[:topk]) for s in scores]

    out_p, out_s = [], []
    for meta, plist, slist in zip(batch_metadata, passages, scores):
        keep = [(p, s) for p, s in zip(plist, slist) if p.get("id") != meta.get("id")]
        dropped = [(p, s) for p, s in zip(plist, slist) if p.get("id") == meta.get("id")]
        if topk > len(keep):
            logger.warning("only %d passages left after self-filter (topk=%d)",
                           len(keep), topk)
        keep += dropped
        out_p.append([p for p, _ in keep][:topk])
        out_s.append([s for _, s in keep][:topk])
    return out_p, out_s
