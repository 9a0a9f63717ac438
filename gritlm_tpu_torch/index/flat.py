"""Exact (flat) inner-product index on one device (port of
gritlm_tpu.index.flat).

The corpus is one `[capacity, dim]` tensor on the device, padded to a
multiple of `pad_to` rows; rows past `n_docs` score -inf. Passage payloads
(title/text dicts) stay on the host: search returns doc ids into that
table. Search runs query blocks of `QUERY_BLOCK` rows through K9
(`ops/scores_segmax.py`: fp32 scores of the bf16 corpus, -inf past
`n_docs`, per-128-column segment maxima) and then the segment-pruned exact
top-k.

`save`/`load` keep the JAX package's on-disk format (`embeddings.{i}.npy`
float32, `passages.{i}.jsonl`, `meta.json`), so an index saved by either
package loads in the other. The mesh-sharded index is not ported
(`mesh=` raises).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gritlm_tpu_torch.models.transformer import resolve_device
from gritlm_tpu_torch.ops import scores_segmax as k9


class FlatIndex:
    """Exact MIPS index over pooled embeddings, stored bf16 by default.

    `search_mode="approx"` is accepted for the JAX package's interface and
    runs the same exact search: `jax.lax.approx_max_k` has no PyTorch
    counterpart (and JAX itself computes it exactly on every backend but the
    TPU), and an exact top-k meets any recall target."""

    # Queries run in blocks of this size, so the [Qblk, N] fp32 score buffer
    # stays bounded while the corpus streams through K9.
    QUERY_BLOCK = 256

    def __init__(
        self,
        dim: int,
        capacity: int,
        mesh=None,
        dtype=torch.bfloat16,
        pad_to: int = 1024,
        search_mode: str = "exact",  # 'exact' | 'approx' (the same exact search)
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError("FlatIndex(mesh=...): the sharded index is not ported yet")
        self.dim = dim
        self.capacity = int(math.ceil(capacity / pad_to) * pad_to)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.search_mode = search_mode
        self.n_docs = 0
        self.passages: List[Dict[str, Any]] = []
        self.embeddings = torch.zeros((self.capacity, dim), dtype=self.dtype,
                                      device=self.device)

    # ------------------------------------------------------------------ build

    def add(self, embeddings, passages: Optional[Sequence[dict]] = None) -> None:
        """Append a block of embeddings (numpy or torch, any float dtype),
        written in place into the preallocated corpus tensor."""
        block = torch.as_tensor(embeddings)
        n = block.shape[0]
        if self.n_docs + n > self.capacity:
            raise ValueError(f"Index full: {self.n_docs}+{n} > capacity {self.capacity}")
        self.embeddings[self.n_docs:self.n_docs + n].copy_(block)
        if passages is not None:
            self.passages.extend(passages)
        self.n_docs += n

    # ----------------------------------------------------------------- search

    def _search_block(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        # Segment-pruned exact top-k over K9's segment maxima: the k segments
        # with the largest maxima cover the whole top-k (the proof is at
        # gritlm_tpu/index/flat.py, EXACT_SEGMENT). Values are exact; which
        # index wins a tie at the k-th value may differ from a global sort.
        scores, segmax_t = k9.scores_segmax(q, self.embeddings, self.n_docs)
        Q, N = scores.shape
        SEG = k9.SEGMENT
        ns = -(-N // SEG)
        if ns <= 2 * k:  # tiny corpus: the global sort is cheap
            return torch.topk(scores, k, dim=1)
        if N % SEG:
            # pad the score row with -inf to the next segment multiple, so
            # the pruned path below still applies
            scores = F.pad(scores, (0, ns * SEG - N), value=float("-inf"))
        seg = scores.view(Q, ns, SEG)
        _, segidx = torch.topk(segmax_t.T, k, dim=1)  # [Q, k] surviving segments
        cand = torch.gather(seg, 1, segidx[:, :, None].expand(Q, k, SEG))  # [Q, k, SEG]
        v, ii = torch.topk(cand.reshape(Q, k * SEG), k, dim=1)
        segno = torch.gather(segidx, 1, ii // SEG)
        return v, segno * SEG + ii % SEG

    @torch.inference_mode()
    def search(self, queries, k: int, mode: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k] float32, ids [Q, k] int32) on the host.

        `queries` is numpy or a torch tensor; a tensor already on the
        index's device is used where it lies (encode -> search pays no host
        round trip). Queries are cast to the corpus dtype. mode: 'exact'
        (segment-pruned exact top-k) or 'approx' (the same exact search, see
        the class docstring); default the index's `search_mode`."""
        mode = mode or self.search_mode
        if mode not in ("exact", "approx"):
            raise ValueError(f"FlatIndex.search: mode {mode!r}")
        k = min(k, max(self.n_docs, 1))
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.asarray(queries, np.float32))
        queries = queries.to(device=self.device, dtype=self.dtype)
        vals, ids = [], []
        for a in range(0, queries.shape[0], self.QUERY_BLOCK):
            v, i = self._search_block(queries[a:a + self.QUERY_BLOCK].contiguous(), k)
            vals.append(v)
            ids.append(i.to(torch.int32))
        return torch.cat(vals).cpu().numpy(), torch.cat(ids).cpu().numpy()

    def search_passages(self, queries, k: int) -> Tuple[List[List[dict]], np.ndarray]:
        """The top-k passage dicts per query, and their scores."""
        scores, ids = self.search(queries, k)
        docs = [[self.passages[int(i)] for i in row] for row in ids]
        return docs, scores

    # ------------------------------------------------------------- save/load

    def save(self, path: str, total_shards: Optional[int] = None) -> None:
        """embeddings.{i}.npy (float32) + passages.{i}.jsonl + meta.json,
        the JAX package's layout."""
        os.makedirs(path, exist_ok=True)
        total_shards = total_shards or 1
        emb = self.embeddings[: self.n_docs].float().cpu().numpy()
        bounds = np.linspace(0, self.n_docs, total_shards + 1, dtype=int)
        for s in range(total_shards):
            lo, hi = bounds[s], bounds[s + 1]
            np.save(os.path.join(path, f"embeddings.{s}.npy"), emb[lo:hi])
            with open(os.path.join(path, f"passages.{s}.jsonl"), "w") as f:
                for p in self.passages[lo:hi]:
                    f.write(json.dumps(p) + "\n")
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"dim": self.dim, "n_docs": self.n_docs, "shards": total_shards}, f)

    @classmethod
    def load(cls, path: str, mesh=None, dtype=torch.bfloat16, device=None) -> "FlatIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["dim"], max(meta["n_docs"], 1), mesh=mesh, dtype=dtype, device=device)
        for s in range(meta["shards"]):
            emb = np.load(os.path.join(path, f"embeddings.{s}.npy"))
            passages = []
            pfile = os.path.join(path, f"passages.{s}.jsonl")
            if os.path.exists(pfile):
                with open(pfile) as f:
                    passages = [json.loads(line) for line in f if line.strip()]
            idx.add(emb, passages or None)
        return idx


def load_passages_jsonl(path: str, max_passages: Optional[int] = None) -> List[dict]:
    """Load a JSONL passage corpus (one dict per line)."""
    out = []
    with open(path) as f:
        for line in f:
            if max_passages is not None and len(out) >= max_passages:
                break
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
