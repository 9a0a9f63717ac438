"""Generative reranker: rescore the top-k retrieved docs by the model's
logit of answering "yes" to a relevance question (port of
gritlm_tpu.eval.rerank).

Mechanism of the reference's rerank path (scripts/AbsTaskRetrieval.py:276-345):
prompt = task-specific template(query, passage) asking for yes/no; score =
logit of the "yes" token at each row's last real token of one causal LM
forward (K1 for the attention); the top-`depth` docs per query are
re-sorted by that score and kept above the rest. Batched across candidate
docs; optional JSON cache per query.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

DEFAULT_TEMPLATE = (
    "<|user|>\nPassage: {title} {text}\n\nQuery: {query}\n\n"
    "Does the passage answer the query? Answer yes or no.\n<|assistant|>\n"
)

_TEMPLATES_JSON = os.path.join(
    os.path.dirname(__file__), "instructions", "rerank_templates.json"
)


def load_rerank_template(task_name: str) -> str:
    """Per-task rerank prompt (benchmark prompt data from the reference's
    rerank path, scripts/AbsTaskRetrieval.py:19-202). The reference templates
    use {query}/{passage}; normalized here to this module's
    {query}/{title} {text} slots. Falls back to DEFAULT_TEMPLATE."""
    with open(_TEMPLATES_JSON) as f:
        templates = json.load(f)
    t = templates.get(task_name)
    if t is None:
        return DEFAULT_TEMPLATE
    return t.replace("{passage}", "{title} {text}")


class GenerativeReranker:
    def __init__(
        self,
        model,  # GritLM (unified/generative mode: needs the LM head)
        template: str = DEFAULT_TEMPLATE,
        yes_token: str = "yes",
        max_length: int = 1024,
        batch_size: int = 8,
        cache_dir: Optional[str] = None,
    ):
        self.model = model
        self.template = template
        self.max_length = max_length
        self.batch_size = batch_size
        self.cache_dir = cache_dir
        ids = model.tokenizer._encode_one(yes_token, add_special_tokens=False)
        self.yes_id = ids[0]

    @torch.inference_mode()
    def _score_batch(self, prompts) -> np.ndarray:
        from gritlm_tpu_torch.models.transformer import forward_lm

        enc = self.model.tokenizer(
            prompts, max_length=self.max_length, add_special_tokens=True
        )
        ids = torch.as_tensor(enc["input_ids"], device=self.model.device)
        mask = torch.as_tensor(enc["attention_mask"], device=self.model.device)
        logits, _, _ = forward_lm(
            self.model.params, self.model.config, ids,
            attention_mask=mask, causal=True,
        )
        # each row's last real token: the largest position the mask keeps
        pos = torch.arange(mask.shape[1], device=mask.device)
        last = torch.where(mask > 0, pos[None, :], -1).argmax(dim=1)
        final = logits[torch.arange(logits.shape[0], device=logits.device), last]
        return final[:, self.yes_id].float().cpu().numpy()

    def rerank(
        self,
        queries: Dict[str, str],
        corpus: Dict[str, dict],
        results: Dict[str, Dict[str, float]],
        depth: int = 10,
    ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for qid, scored in results.items():
            top = sorted(scored.items(), key=lambda x: -x[1])
            head, tail = top[:depth], top[depth:]
            cache_file = (
                os.path.join(self.cache_dir, f"{qid}.json") if self.cache_dir else None
            )
            if cache_file and os.path.exists(cache_file):
                with open(cache_file) as f:
                    yes_scores = json.load(f)
            else:
                prompts = [
                    self.template.format(
                        query=queries[qid],
                        title=corpus[d].get("title", ""),
                        text=corpus[d].get("text", corpus[d] if isinstance(corpus[d], str) else ""),
                    )
                    for d, _ in head
                ]
                scores = []
                for i in range(0, len(prompts), self.batch_size):
                    scores.extend(self._score_batch(prompts[i : i + self.batch_size]))
                yes_scores = {d: float(s) for (d, _), s in zip(head, scores)}
                if cache_file:
                    os.makedirs(self.cache_dir, exist_ok=True)
                    with open(cache_file, "w") as f:
                        json.dump(yes_scores, f)
            # the reranked head stays strictly above the tail: offset by the tail max
            floor = max((s for _, s in tail), default=0.0)
            span = max(yes_scores.values()) - min(yes_scores.values()) or 1.0
            new = {
                d: floor + 1.0 + (yes_scores[d] - min(yes_scores.values())) / span
                for d, _ in head
            }
            new.update({d: s for d, s in tail})
            out[qid] = new
        return out
