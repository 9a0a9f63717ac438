"""Training-data format contract: validation, reformatting, hygiene (port of
gritlm_tpu.data_prep.format; the length statistics count tokens with the
port's tokenizer, gritlm_tpu_torch.tokenizer).

The reference's 40+ one-off dataset scripts (scripts/prepare_datasets/,
scripts/reformat_*.py; SURVEY §2.6) reduce to one format contract
(README.md:295-303):

  embedding:  {"query": str | [instr, text],
               "pos": [str | [instr, text], ...],
               "neg": [str | [instr, text], ...]}
  generative: {"text": str | [user, assistant, user, assistant, ...]}

This module validates JSONL files against that contract, reformats common
public shapes (anchor/positive/negative pair sets, chat message lists) into
it, and provides the hygiene checks the reference ships as scripts
(check_ds_length.py, check_decontamination.py).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------- validation

def _is_text(x) -> bool:
    return isinstance(x, str)


def _is_instr_pair(x) -> bool:
    return (isinstance(x, (list, tuple)) and len(x) == 2
            and all(isinstance(e, str) for e in x))


def _is_item(x) -> bool:
    return _is_text(x) or _is_instr_pair(x)


def validate_embedding_row(row: dict) -> List[str]:
    """Return a list of problems (empty = valid)."""
    errs = []
    if not _is_item(row.get("query")):
        errs.append("query must be str or [instruction, text]")
    for field in ("pos", "neg"):
        v = row.get(field)
        if not isinstance(v, list):
            errs.append(f"{field} must be a list")
        elif not all(_is_item(e) for e in v):
            errs.append(f"{field} items must be str or [instruction, text]")
    if isinstance(row.get("pos"), list) and len(row["pos"]) == 0:
        errs.append("pos must be non-empty")
    return errs


def validate_generative_row(row: dict) -> List[str]:
    errs = []
    t = row.get("text")
    if _is_text(t):
        return errs
    if not isinstance(t, list) or not t:
        errs.append("text must be str or non-empty list of strings")
    elif not all(isinstance(e, str) for e in t):
        errs.append("text list elements must be strings")
    elif len(t) % 2 != 0:
        errs.append("text list must alternate [user, assistant, ...] "
                    "(even length)")
    return errs


def validate_file(path: str, max_errors: int = 20) -> Dict[str, object]:
    """Validate one JSONL file; auto-detects embedding vs generative from the
    first row (mixed files are an error, matching the loader's per-directory
    split, training/data.py:43-56)."""
    n, kind, errors = 0, None, []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            row_kind = "generative" if "text" in row else "embedding"
            kind = kind or row_kind
            if row_kind != kind:
                errors.append(f"line {lineno}: mixed {row_kind} row in "
                              f"{kind} file")
            check = (validate_generative_row if row_kind == "generative"
                     else validate_embedding_row)
            errors.extend(f"line {lineno}: {e}" for e in check(row))
            n += 1
            if len(errors) >= max_errors:
                break
    return {"path": path, "kind": kind, "rows": n, "errors": errors,
            "valid": not errors}


# -------------------------------------------------------------- reformatting

def reformat_pairs(
    rows: Iterable[dict],
    query_key: str = "query",
    pos_key: str = "pos",
    neg_key: str = "neg",
    query_instruction: Optional[str] = None,
    passage_instruction: Optional[str] = None,
) -> Iterable[dict]:
    """Anchor/positive/negative shapes (E5, MEDI, sentence-transformers pair
    sets — reference reformat_e5.py/reformat_medi*.py) → contract rows,
    optionally attaching instructions as [instr, text]."""
    def wrap(x, instr):
        return [instr, x] if instr is not None else x

    for r in rows:
        pos = r[pos_key]
        neg = r.get(neg_key, [])
        if isinstance(pos, str):
            pos = [pos]
        if isinstance(neg, str):
            neg = [neg]
        yield {
            "query": wrap(r[query_key], query_instruction),
            "pos": [wrap(p, passage_instruction) for p in pos],
            "neg": [wrap(n, passage_instruction) for n in neg],
        }


def reformat_chat(
    rows: Iterable[dict], messages_key: str = "messages",
    role_key: str = "role", content_key: str = "content",
    user_role: str = "user", assistant_role: str = "assistant",
) -> Iterable[dict]:
    """OpenAI/tulu/ultrachat message lists (reference reformat_tuluv2.py,
    reformat_ultrachat.py) → {"text": [user, assistant, ...]}; drops system
    turns and any trailing unanswered user turn."""
    for r in rows:
        out: List[str] = []
        for m in r[messages_key]:
            role = m[role_key]
            if role == user_role:
                if len(out) % 2 == 0:
                    out.append(m[content_key])
            elif role == assistant_role and len(out) % 2 == 1:
                out.append(m[content_key])
        if len(out) % 2 == 1:
            out = out[:-1]
        if out:
            yield {"text": out}


# ------------------------------------------------------------------- hygiene

def dataset_length_stats(path: str, tokenizer=None) -> Dict[str, float]:
    """Char (and, with a tokenizer, token) length stats per file — the
    reference's check_ds_length.py / compute_target_len.py."""
    lens_c: List[int] = []
    lens_t: List[int] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "text" in row:
                t = row["text"]
                s = t if isinstance(t, str) else " ".join(t)
            else:
                q = row["query"]
                s = q if isinstance(q, str) else q[1]
            lens_c.append(len(s))
            if tokenizer is not None:
                lens_t.append(tokenizer.tokenize_len(s, add_special_tokens=False))

    def stats(xs):
        if not xs:
            return {}
        xs = sorted(xs)
        return {"mean": sum(xs) / len(xs), "p50": xs[len(xs) // 2],
                "max": xs[-1], "n": len(xs)}

    out = {"chars": stats(lens_c)}
    if lens_t:
        out["tokens"] = stats(lens_t)
    return out


_WS = re.compile(r"\s+")


def _ngrams(s: str, n: int) -> set:
    toks = _WS.sub(" ", s.lower()).split()
    return {" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1)}


def check_decontamination(
    train_texts: Sequence[str], eval_texts: Sequence[str], n: int = 8,
    threshold: float = 0.5,
) -> List[Tuple[int, int, float]]:
    """Flag train rows sharing ≥`threshold` of an eval row's n-grams
    (reference check_decontamination.py checks GSM8K leakage). Returns
    (train_idx, eval_idx, overlap) triples."""
    eval_grams = [_ngrams(t, n) for t in eval_texts]
    hits = []
    for ti, t in enumerate(train_texts):
        tg = _ngrams(t, n)
        if not tg:
            continue
        for ei, eg in enumerate(eval_grams):
            if not eg:
                continue
            ov = len(tg & eg) / len(eg)
            if ov >= threshold:
                hits.append((ti, ei, ov))
    return hits
