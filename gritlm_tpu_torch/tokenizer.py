"""Tokenizer adapters (the PyTorch port's own copy of gritlm_tpu.tokenizer;
numpy only, `tokenizers` imported lazily).

The framework only needs a narrow protocol (batch encode with right padding +
truncation, per-string token counts for instruction-length masking, decode).
Two implementations:

  - HFTokenizer: wraps a `tokenizers.Tokenizer` loaded from tokenizer.json
    (what Mistral/GritLM checkpoints ship; pad falls back to eos exactly like
    the reference gritlm/gritlm.py:62-64).
  - ByteTokenizer: dependency-free byte-level tokenizer for tests and smoke
    runs (no network, no vocab files).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np


class BatchEncoding(dict):
    """dict of np arrays with attribute access (input_ids, attention_mask)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _pad_batch(seqs: List[List[int]], pad_id: int, max_length: Optional[int],
               pad_to: Optional[int] = None) -> BatchEncoding:
    if max_length is not None:
        seqs = [s[:max_length] for s in seqs]
    width = max((len(s) for s in seqs), default=0)
    if pad_to is not None:
        width = max(width, 1)
        width = ((width + pad_to - 1) // pad_to) * pad_to
        if max_length is not None:
            width = min(width, max_length)
    width = max(width, 1)
    ids = np.full((len(seqs), width), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), width), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = s[:width]
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return BatchEncoding(input_ids=ids, attention_mask=mask)


class ByteTokenizer:
    """UTF-8 bytes + <s>/</s>. ids: 0..255 bytes, 256 = bos, 257 = eos = pad."""

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 257
        self.vocab_size = 258
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self.pad_token = "</s>"

    def _encode_one(self, text: str, add_special_tokens: bool) -> List[int]:
        ids: List[int] = []
        rest = text
        if add_special_tokens:
            ids.append(self.bos_token_id)
        # honor literal <s>/</s> markers in templates
        out: List[int] = []
        i = 0
        b = rest
        while i < len(b):
            if b.startswith("<s>", i):
                out.append(self.bos_token_id)
                i += 3
            elif b.startswith("</s>", i):
                out.append(self.eos_token_id)
                i += 4
            else:
                out.extend(b[i].encode("utf-8"))
                i += 1
        return ids + out

    def __call__(self, texts: Union[str, Sequence[str]], max_length: Optional[int] = None,
                 padding: bool = True, truncation: bool = True,
                 add_special_tokens: bool = True, pad_to: Optional[int] = None) -> BatchEncoding:
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self._encode_one(t, add_special_tokens) for t in texts]
        return _pad_batch(seqs, self.pad_token_id,
                          max_length if truncation else None, pad_to)

    def tokenize_len(self, text: str, add_special_tokens: bool = False) -> int:
        return len(self._encode_one(text, add_special_tokens))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        bs = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                bs.append(t)
            elif not skip_special_tokens:
                bs.extend((self.bos_token if t == 256 else self.eos_token).encode())
        return bs.decode("utf-8", errors="ignore")


class HFTokenizer:
    """Wraps a fast `tokenizers.Tokenizer` (tokenizer.json)."""

    def __init__(self, tok, bos_token_id=None, eos_token_id=None, pad_token_id=None,
                 add_bos_token: bool = True):
        self._tok = tok
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        # pad falls back to eos (reference gritlm/gritlm.py:62-64)
        self.pad_token_id = pad_token_id if pad_token_id is not None else eos_token_id
        self.add_bos_token = add_bos_token
        self.vocab_size = tok.get_vocab_size()

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizer":
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
        bos = eos = pad = None
        add_bos = True
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                tc = json.load(f)

            def _tid(name):
                v = tc.get(name)
                if isinstance(v, dict):
                    v = v.get("content")
                return tok.token_to_id(v) if v else None

            bos, eos, pad = _tid("bos_token"), _tid("eos_token"), _tid("pad_token")
            add_bos = tc.get("add_bos_token", True)
        if bos is None:
            bos = tok.token_to_id("<s>")
        if eos is None:
            eos = tok.token_to_id("</s>")
        return cls(tok, bos, eos, pad, add_bos)

    def _encode_one(self, text: str, add_special_tokens: bool) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_special_tokens and self.add_bos_token and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, texts: Union[str, Sequence[str]], max_length: Optional[int] = None,
                 padding: bool = True, truncation: bool = True,
                 add_special_tokens: bool = True, pad_to: Optional[int] = None) -> BatchEncoding:
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self._encode_one(t, add_special_tokens) for t in texts]
        return _pad_batch(seqs, self.pad_token_id,
                          max_length if truncation else None, pad_to)

    def tokenize_len(self, text: str, add_special_tokens: bool = False) -> int:
        return len(self._encode_one(text, add_special_tokens))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)


def prefix_token_len(tokenizer, prefix: str, full_ids: Sequence[int],
                     add_special_tokens: bool = False) -> int:
    """Count of `full_ids` tokens lying entirely inside the string `prefix`.

    The reference assumes tokenize(prefix) is a token-prefix of
    tokenize(prefix + text) and uses len(tokenize(prefix)) directly
    (gritlm/gritlm.py:144-153; the training collator computes instruction
    lens the same way and asserts on it, gritlm/training/data.py:184-205,
    262-266). A BPE merge spanning the prefix/text boundary breaks that
    assumption silently. Here we detect the divergence and correct to the
    longest common token prefix: only tokens fully inside the instruction
    are masked, and a boundary-straddling token keeps its text content in
    the pooling / loss."""
    pref_ids = tokenizer._encode_one(prefix, add_special_tokens)
    k = 0
    n = min(len(pref_ids), len(full_ids))
    while k < n and int(full_ids[k]) == int(pref_ids[k]):
        k += 1
    return k


def instruction_token_lens(tokenizer, instruction: str, input_ids: np.ndarray,
                           attention_mask: np.ndarray,
                           add_special_tokens: bool = True) -> np.ndarray:
    """Per-row instruction token lengths for a padded batch whose rows all
    share the same instruction prefix (the GritLM.encode case). Vectorized
    fast path: when tokenize(instruction) is a token-prefix of every row
    (always true for char/byte-level tokenizers, almost always for real BPE),
    this is one numpy comparison; rows where a merge crossed the boundary get
    the corrected longest-common-prefix length. Each row is guaranteed at
    least one unmasked valid token (reference pooling-mask assert,
    gritlm/training/model.py:158)."""
    pref = np.asarray(
        tokenizer._encode_one(instruction, add_special_tokens), np.int64
    )
    ids = np.asarray(input_ids)
    L = min(len(pref), ids.shape[1])
    if L == 0:
        return np.zeros((ids.shape[0],), np.int64)
    eq = ids[:, :L] == pref[None, :L]
    lens = np.where(eq.all(axis=1), L, eq.argmin(axis=1))
    valid = np.asarray(attention_mask).sum(axis=1)
    return np.minimum(lens, np.maximum(valid - 1, 0))


def load_tokenizer(path_or_none: Optional[str]):
    """Load an HF fast tokenizer from a checkpoint dir, or the byte fallback."""
    if path_or_none and os.path.exists(os.path.join(path_or_none, "tokenizer.json")):
        return HFTokenizer.from_pretrained(path_or_none)
    return ByteTokenizer()
