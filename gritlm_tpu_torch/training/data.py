"""Training data pipeline: JSONL datasets, GRIT collator, homogeneous sampler.

A copy of `gritlm_tpu.training.data` (numpy only; the port imports nothing
of the JAX package), importing the port's own tokenizer and templates.

Re-expresses the reference's CustomDataset / CustomCollator /
CustomRandomSampler semantics (gritlm/training/data.py) as a pure-Python +
numpy pipeline emitting **static-shape** batches (always padded to the
configured max lens) so every training step hits one compiled program —
the TPU-first difference from the reference's dynamic per-batch padding.

JSONL format contract (reference README.md:297-303):
  embedding:  {"query": str|[instr, text], "pos": [...], "neg": [...]}
  generative: {"text": str|[user, assistant, user, assistant, ...]}
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gritlm_tpu_torch.tokenizer import prefix_token_len
from gritlm_tpu_torch.training import templates as T


# ---------------------------------------------------------------------------
# Loading


def load_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_train_dirs(train_data: Sequence[str]) -> Tuple[List[List[dict]], List[List[dict]]]:
    """Load *.jsonl files (or dirs of them); split into embedding datasets
    (have 'query'+'pos'+'neg') and generative datasets (have 'text'),
    one dataset per file (needed for homogeneous batching)."""
    files: List[str] = []
    for p in train_data:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            files.append(p)
    emb_sets, gen_sets = [], []
    for f in files:
        rows = load_jsonl(f)
        if not rows:
            continue
        if "text" in rows[0]:
            gen_sets.append(rows)
        else:
            emb_sets.append(rows)
    return emb_sets, gen_sets


def filter_too_long_instructions(
    tokenizer, emb_sets: List[List[dict]], query_max_len: int, passage_max_len: int
) -> List[List[dict]]:
    """Drop embedding samples whose instruction prefix alone fills the query/
    passage window or whose text is empty (reference
    filter_too_long_instructions, run.py:38-52)."""

    def prefix_len(sample) -> int:
        _, prefix = T.format_embed(sample)
        return tokenizer.tokenize_len(prefix, add_special_tokens=False)

    def ok(row) -> bool:
        q = row["query"]
        if isinstance(q, (list, tuple)):
            if not q[1]:
                return False
            if prefix_len(q) >= query_max_len:
                return False
        for p in list(row["pos"]) + list(row["neg"]):
            if isinstance(p, (list, tuple)):
                if not p[1]:
                    return False
                if prefix_len(p) >= passage_max_len:
                    return False
        return True

    return [[r for r in s if ok(r)] for s in emb_sets]


# ---------------------------------------------------------------------------
# Dataset


@dataclasses.dataclass
class GritDataset:
    """Pairs one embedding sample with one generative sample per index in
    unified mode (total_len = max of the two; out-of-range indices re-draw
    randomly — reference data.py:16-141). Sampling is driven by an explicit
    numpy Generator: deterministic given (seed, epoch), no global RNG.
    """

    emb_sets: List[List[dict]]
    gen_sets: List[List[dict]]
    mode: str = "unified"  # unified | embedding | generative
    train_group_size: int = 2
    max_char_len: int = 20480  # max_seq_len * 10 on-the-fly truncation
    seed: int = 42
    process_index: int = 0
    process_count: int = 1
    use_unique_indices: bool = False

    def __post_init__(self):
        self.emb = [r for s in self.emb_sets for r in s]
        self.gen = [r for s in self.gen_sets for r in s]
        self.len_emb, self.len_gen = len(self.emb), len(self.gen)
        if self.mode == "embedding":
            self.total_len = self.len_emb
        elif self.mode == "generative":
            self.total_len = self.len_gen
        else:
            self.total_len = max(self.len_emb, self.len_gen)
        self.rng = np.random.default_rng(self.seed + 7919 * self.process_index)
        self._unique_pool: List[int] = []

    def __len__(self) -> int:
        return self.total_len

    # per-source lengths for the homogeneous sampler (concatenated order)
    @property
    def ds_lens(self) -> List[int]:
        if self.mode == "generative":
            return [len(s) for s in self.gen_sets]
        return [len(s) for s in self.emb_sets]

    def _truncate(self, x):
        if isinstance(x, str):
            return x[: self.max_char_len]
        return [y[: self.max_char_len] for y in x]

    def _draw_unique(self, n: int) -> int:
        """Rank-strided no-replacement sampling of the smaller dataset
        (use_unique_indices; reference data.py:56-76)."""
        if not self._unique_pool:
            idxs = list(range(n))[self.process_index :: self.process_count]
            self.rng.shuffle(idxs)
            self._unique_pool = idxs
        return self._unique_pool.pop()

    def __getitem__(self, item: int):
        query = passages = generative = None
        if self.mode in ("unified", "embedding") and self.len_emb:
            i = item
            if self.mode == "unified" and self.use_unique_indices and self.len_emb < self.len_gen:
                i = self._draw_unique(self.len_emb)
            elif i >= self.len_emb:
                i = int(self.rng.integers(0, self.len_emb))
            row = self.emb[i]
            query = self._truncate(row["query"])
            pos = self._truncate(row["pos"][int(self.rng.integers(0, len(row["pos"])))])
            negs_src = row["neg"]
            need = self.train_group_size - 1
            if need > 0 and len(negs_src) == 0:
                raise ValueError("Embedding sample has no negatives")
            if len(negs_src) < need:
                reps = -(-need // len(negs_src))
                pool = list(negs_src) * reps
            else:
                pool = list(negs_src)
            sel = self.rng.choice(len(pool), size=need, replace=False) if need else []
            negs = [self._truncate(pool[j]) for j in sel]
            passages = [pos] + negs
        if self.mode in ("unified", "generative") and self.len_gen:
            i = item
            if self.mode == "unified" and self.use_unique_indices and self.len_gen < self.len_emb:
                i = self._draw_unique(self.len_gen)
            elif i >= self.len_gen:
                i = int(self.rng.integers(0, self.len_gen))
            generative = self.gen[i]["text"]
        return query, passages, generative


# ---------------------------------------------------------------------------
# Collator


def _pad_to(ids: List[int], width: int, pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = ids[:width]
    out = np.full((width,), pad_id, np.int32)
    mask = np.zeros((width,), np.int32)
    out[: len(ids)] = ids
    mask[: len(ids)] = 1
    return out, mask


@dataclasses.dataclass
class GritCollator:
    """Turns a list of (query, passages, generative) samples into fixed-shape
    numpy batches with instruction_lens (embedding pooling masks) and -100
    label masking of user turns / pads (reference data.py:143-281).

    Generative prompts are tokenized whole-string (matching inference) with
    segment boundaries recovered by longest-common-token-prefix alignment,
    so label masking is token-exact even under BPE merges that span a
    boundary — instead of the reference's re-tokenized length arithmetic.
    """

    tokenizer: Any
    query_max_len: int = 256
    passage_max_len: int = 2048
    generative_max_len: int = 2048
    prefixlm: bool = False
    take_nth: int = 1  # generative batch = every nth sample (per_device_generative_bs)

    def _encode_embed(self, samples, width: int):
        ids_rows, mask_rows, instr_lens = [], [], []
        for s in samples:
            prompt, prefix = T.format_embed(s)
            ids = self.tokenizer._encode_one(prompt, add_special_tokens=False)
            # longest-common-prefix alignment instead of len(tokenize(prefix))
            # — token-exact even when a BPE merge spans the instruction/text
            # boundary (the reference asserts the prefix assumption instead,
            # gritlm/training/data.py:262-266)
            plen = prefix_token_len(self.tokenizer, prefix, ids,
                                    add_special_tokens=False)
            ids_row, mask_row = _pad_to(ids, width, self.tokenizer.pad_token_id)
            if plen >= int(mask_row.sum()):
                raise ValueError(f"No text to embed: {prompt!r}")
            ids_rows.append(ids_row)
            mask_rows.append(mask_row)
            instr_lens.append(plen)
        return {
            "input_ids": np.stack(ids_rows),
            "attention_mask": np.stack(mask_rows),
            "instruction_lens": np.asarray(instr_lens, np.int32),
        }

    def _encode_generative(self, samples, width: int):
        ids_rows, mask_rows, label_rows = [], [], []
        for turns in samples:
            _, segments = T.format_generative(turns)
            if self.prefixlm:
                # mask everything before the final assistant segment
                last_loss = max(i for i, (_, l) in enumerate(segments) if l)
                segments = [
                    (s, l and i == last_loss) for i, (s, l) in enumerate(segments)
                ]
            # Whole-string tokenization (so training sees exactly the token
            # stream inference-time generate() produces for the same chat
            # prompt — the reference also tokenizes the full prompt once,
            # gritlm/training/data.py:229-259), with segment boundaries
            # recovered by longest-common-token-prefix alignment of each
            # cumulative prefix. Token-exact under BPE merges that span a
            # segment boundary: a straddling token is attributed to the
            # LATER segment (loss on a token carrying assistant chars).
            full = "".join(s for s, _ in segments)
            ids = self.tokenizer._encode_one(full, add_special_tokens=False)
            labels: List[int] = [-100] * len(ids)
            cum, lo = "", 0
            for seg, is_loss in segments:
                cum += seg
                hi = max(lo, prefix_token_len(self.tokenizer, cum, ids,
                                              add_special_tokens=False))
                if is_loss:
                    labels[lo:hi] = ids[lo:hi]
                lo = hi
            # (for the final segment cum == full, so hi == len(ids) exactly)
            ids_row, mask_row = _pad_to(ids, width, self.tokenizer.pad_token_id)
            lab_row = np.full((width,), -100, np.int64)
            lab = labels[:width]
            lab_row[: len(lab)] = lab
            ids_rows.append(ids_row)
            mask_rows.append(mask_row)
            label_rows.append(lab_row)
        return {
            "input_ids": np.stack(ids_rows),
            "attention_mask": np.stack(mask_rows),
            "labels": np.stack(label_rows),
        }

    def __call__(self, features) -> Dict[str, Dict[str, np.ndarray]]:
        queries = [f[0] for f in features]
        passages = [f[1] for f in features]
        generative = [f[2] for f in features]
        if self.take_nth > 1:
            generative = generative[:: self.take_nth]

        batch: Dict[str, Dict[str, np.ndarray]] = {}
        if queries and queries[0] is not None:
            flat_passages = [p for group in passages for p in group]
            batch["query"] = self._encode_embed(queries, self.query_max_len)
            batch["passage"] = self._encode_embed(flat_passages, self.passage_max_len)
        gen = [g for g in generative if g is not None]
        if gen:
            batch["generative"] = self._encode_generative(gen, self.generative_max_len)
        return batch


# ---------------------------------------------------------------------------
# Sampler


def homogeneous_batches(
    ds_lens: Sequence[int], batch_size: int, rng: np.random.Generator
) -> Iterator[List[int]]:
    """Batch indices such that almost every batch draws from a single source
    dataset (keeps in-batch negatives hard); leftovers form mixed batches;
    batch order shuffled (reference CustomRandomSampler, data.py:283-350)."""
    offsets = np.cumsum([0] + list(ds_lens[:-1]))
    batches: List[np.ndarray] = []
    leftovers: List[np.ndarray] = []
    for n, off in zip(ds_lens, offsets):
        idx = rng.permutation(n) + off
        nfull = n // batch_size
        for b in range(nfull):
            batches.append(idx[b * batch_size : (b + 1) * batch_size])
        if n % batch_size:
            leftovers.append(idx[nfull * batch_size :])
    if leftovers:
        order = rng.permutation(len(leftovers))
        pool = np.concatenate([leftovers[i] for i in order])
        nfull = len(pool) // batch_size
        for b in range(nfull):
            batches.append(pool[b * batch_size : (b + 1) * batch_size])
        # drop the final incomplete mixed batch (reference behavior)
    for i in rng.permutation(len(batches)):
        yield [int(x) for x in batches[i]]


def batch_iterator(
    dataset: GritDataset,
    collator: GritCollator,
    batch_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
    skip: int = 0,
) -> Iterator[Dict[str, Dict[str, np.ndarray]]]:
    """`skip` fast-forwards past the first N batches of this epoch (resume):
    the dataset rows are still drawn (GritDataset.rng is a stream seeded once
    at construction, so skipped draws must happen for later batches to be
    byte-identical to an uninterrupted run — cf. the reference's
    skip_first_batches + RNG-state resume, gradcache_trainer.py:464-508), but
    tokenization/collation — the actual cost — is skipped."""
    rng = np.random.default_rng(seed + 1000003 * epoch)
    ds_lens = list(dataset.ds_lens or [len(dataset)])
    # unified mode: len(dataset) = max(len_emb, len_gen). When the generative
    # corpus is larger, cover indices past the embedding range with a virtual
    # tail segment so every generative row gets sampled (embedding rows for
    # those indices re-draw randomly in __getitem__ — the behavior of the
    # reference's default sampler over range(total_len); its custom sampler
    # silently dropped the generative tail, run.py:333-343)
    tail = len(dataset) - sum(ds_lens)
    if tail > 0:
        ds_lens.append(tail)
    for n, batch_idx in enumerate(homogeneous_batches(ds_lens, batch_size, rng)):
        if n < skip:
            for i in batch_idx:
                dataset[i]  # consume the RNG stream, drop the sample
            continue
        yield collator([dataset[i] for i in batch_idx])
