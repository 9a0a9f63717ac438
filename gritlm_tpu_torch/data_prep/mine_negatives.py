"""Hard-negative mining (port of gritlm_tpu.data_prep.mine_negatives).

Counterpart of the reference's mine_hard_negatives.py
(scripts/prepare_datasets/mine_hard_negatives.py:14-80): the GritLM encoder
embeds the deduplicated positive corpus once, a bf16 FlatIndex holds it on
the model's device, and each query's top-k (after skipping its own
positives and optionally the easiest ranks) becomes its `neg` list. The
search runs K9 (`ops/scores_segmax.py`) a query block at a time.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


def _text_of(item) -> str:
    return item[1] if isinstance(item, (list, tuple)) else item


def mine_hard_negatives(
    model,  # gritlm_tpu_torch.GritLM (embedding or unified mode)
    rows: Sequence[dict],  # contract rows with query + pos (neg overwritten)
    k: int = 7,
    skip_top: int = 0,
    query_instruction: Optional[str] = None,
    passage_instruction: Optional[str] = None,
    batch_size: int = 64,
    max_length: int = 512,
    mesh=None,
) -> List[dict]:
    """Return new contract rows whose `neg` lists are the corpus top-k
    (excluding each row's own positives; `skip_top` drops the easiest ranks
    like the reference's deduct_k_largest offset). The sharded index
    (`mesh=`) is not ported: it raises, as FlatIndex(mesh=...) does, until
    the multi-process slice (ROADMAP Queue 1 item 12)."""
    from gritlm_tpu_torch.index.flat import FlatIndex

    if mesh is not None:
        raise NotImplementedError(
            "mine_hard_negatives(mesh=...): the sharded index is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    # dedup the positive pool into the corpus, remembering which corpus ids
    # belong to each row (self-exclusion)
    corpus: List[str] = []
    seen: Dict[str, int] = {}
    own_ids: List[List[int]] = []
    for r in rows:
        ids = []
        for p in r["pos"]:
            t = _text_of(p)
            if t not in seen:
                seen[t] = len(corpus)
                corpus.append(t)
            ids.append(seen[t])
        own_ids.append(ids)

    emb = model.encode(
        corpus, instruction=passage_instruction or "", batch_size=batch_size,
        max_length=max_length, convert_to_tensor=True,
    )
    index = FlatIndex(emb.shape[1], capacity=len(corpus), device=model.device)
    index.add(emb)

    q_texts = [_text_of(r["query"]) for r in rows]
    q_emb = model.encode(
        q_texts, instruction=query_instruction or "", batch_size=batch_size,
        max_length=max_length, convert_to_tensor=True,
    )

    max_own = max((len(o) for o in own_ids), default=0)
    fetch = min(k + skip_top + max_own, len(corpus))
    _, ids = index.search(q_emb, k=fetch)

    out: List[dict] = []
    for r, own, row_ids in zip(rows, own_ids, ids):
        own_set = set(own)
        negs = [corpus[int(i)] for i in row_ids if int(i) not in own_set]
        negs = negs[skip_top:skip_top + k]
        if len(negs) < k:
            logger.warning("only %d/%d negatives for query %r…",
                           len(negs), k, _text_of(r["query"])[:40])
        new = dict(r)
        new["neg"] = negs
        out.append(new)
    return out
