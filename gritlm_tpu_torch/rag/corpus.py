"""Passage corpus loading for RAG.

Counterpart of the reference's load_passages / load_or_initialize_index
(rag/index.py:147-218): JSONL passages with title/section merging, optional
host-strided sharding, max-load and range limits, and synthetic passages for
latency benchmarking. Host-side pure Python; the device-side corpus matrix
lives in index.flat.FlatIndex. A copy of `gritlm_tpu.rag.corpus` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Sequence, Union

logger = logging.getLogger(__name__)


def _load_item(line: str) -> Optional[dict]:
    line = line.strip()
    if not line:
        logger.warning("empty line in passage file")
        return None
    item = json.loads(line)
    # "Title: Section" merge (rag/index.py:157-159)
    if "title" in item and item.get("section"):
        item["title"] = f"{item['title']}: {item['section']}"
    return item


def load_passages(
    filenames: Union[str, Sequence[str]],
    maxload: int = -1,
    shard_rank: int = 0,
    shard_count: int = 1,
) -> List[dict]:
    """Load JSONL passages; line i goes to shard `i % shard_count`
    (round-robin like the reference's rank striding, rag/index.py:165-173).
    With shard_count=1 (one process) every passage loads."""
    if isinstance(filenames, str):
        filenames = [filenames]
    passages: List[dict] = []
    counter = 0
    for fname in filenames:
        with open(fname, encoding="utf-8") as f:
            for line in f:
                if maxload > -1 and counter >= maxload:
                    break
                if counter % shard_count == shard_rank:
                    item = _load_item(line)
                    if item is not None:
                        passages.append(item)
                counter += 1
    return passages


def passage_text(p: dict) -> str:
    """'title text' string to embed/prompt with (rag/eval.py doc assembly)."""
    return (p.get("title", "") + " " + p.get("text", "")).strip()


def synthetic_passages(spec: Union[str, int], tokenizer=None) -> List[dict]:
    """Latency-mode corpus: a file path → one passage of its contents, or an
    int N → one passage of ~N tokens (reference `--customd`,
    rag/index.py:205-214 — it uses '<s>'*N; any fixed repeated token works)."""
    if isinstance(spec, str) and os.path.exists(spec):
        with open(spec) as f:
            return [{"title": "", "text": f.read()}]
    n = int(spec)
    if tokenizer is not None:
        unit = "lorem "
        per = max(tokenizer.tokenize_len(unit, add_special_tokens=False), 1)
        return [{"title": "", "text": unit * (n // per)}]
    return [{"title": "", "text": "lorem " * n}]


def limit_passages(
    passages: List[dict], limit: Optional[int] = None, limit_start: int = 0
) -> List[dict]:
    """Range-limit. NOTE: `limit` is an absolute END index, not a count —
    passages[limit_start:limit] — exactly the reference's --limit/--limit_start
    semantics (rag/index.py:202-205)."""
    if limit is None:
        return passages
    return passages[limit_start:limit]
