"""QA dataset preparation: NQ-open / TriviaQA → the task JSONL contract
(port of gritlm_tpu.rag.prepare_qa).

CLI: python -m gritlm_tpu_torch.rag.prepare_qa {nq,triviaqa} --orig_dir DIR
--output_dir DIR [--index_dir DIR] [--fewshot_seed N]

Counterpart of the reference's rag/prepare_qa.py + rag/download_corpus.py
(rag/prepare_qa.py:18-288, rag/download_corpus.py:26-60). Conversion and
splitting run on local files (this environment has no network egress — the
registry below records where the public files live; fetch them out of band
with any downloader and point these functions at the directory).

Output contract per line: {"question": str, "answers": [str, ...]} — exactly
what rag.tasks.QATask consumes. Few-shot splits use the same fixed Atlas
64-example indices as the reference so results are comparable.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterable, List, Optional

# Public source locations (reference rag/prepare_qa.py:255-265,
# rag/download_corpus.py:7-60). Recorded for provenance; not fetched here.
SOURCES = {
    "nq-open-train": "https://raw.githubusercontent.com/google-research-datasets/natural-questions/master/nq_open/NQ-open.train.jsonl",
    "nq-open-dev": "https://raw.githubusercontent.com/google-research-datasets/natural-questions/master/nq_open/NQ-open.dev.jsonl",
    "triviaqa-unfiltered": "http://nlp.cs.washington.edu/triviaqa/data/triviaqa-unfiltered.tar.gz",
    "atlas-base": "https://dl.fbaipublicfiles.com/atlas",
    "wiki-corpora": [
        "corpora/wiki/enwiki-dec2017",
        "corpora/wiki/enwiki-dec2018",
        "corpora/wiki/enwiki-aug2019",
    ],
}


def convert_nq(ex: dict) -> dict:
    """NQ-open line {"question", "answer": [...]} → contract row
    (rag/prepare_qa.py:165-166)."""
    return {"question": ex["question"], "answers": list(ex["answer"])}


def convert_triviaqa(ex: dict) -> dict:
    """TriviaQA entry → contract row using answer aliases
    (rag/prepare_qa.py:154-162)."""
    return {"question": ex["Question"], "answers": list(ex["Answer"]["Aliases"])}


def write_jsonl(rows: Iterable[dict], path: str) -> int:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
            n += 1
    return n


def _read_jsonl(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def prepare_nq(
    orig_dir: str,
    output_dir: str,
    dev_fraction_from_train: int = 8757,
    fewshot_seed: Optional[int] = None,
    fewshot_k: int = 64,
) -> Dict[str, int]:
    """NQ-open local files → train/dev/test(+64-shot) JSONL. The reference
    carves its dev split off the end of train and uses the official dev as
    test (rag/prepare_qa.py:192-218); we mirror that split protocol."""
    train_raw = _read_jsonl(os.path.join(orig_dir, "NQ-open.train.jsonl"))
    test_raw = _read_jsonl(os.path.join(orig_dir, "NQ-open.dev.jsonl"))
    train = [convert_nq(e) for e in train_raw]
    test = [convert_nq(e) for e in test_raw]
    # never let the carved dev split swallow a small train file
    n_dev = min(dev_fraction_from_train, len(train) // 2)
    dev = train[-n_dev:] if n_dev else []
    train_main = train[:-n_dev] if n_dev else train

    counts = {
        "train": write_jsonl(train_main, os.path.join(output_dir, "train.jsonl")),
        "dev": write_jsonl(dev, os.path.join(output_dir, "dev.jsonl")),
        "test": write_jsonl(test, os.path.join(output_dir, "test.jsonl")),
    }
    if fewshot_seed is not None:
        rng = random.Random(fewshot_seed)
        shots = rng.sample(train_main, min(fewshot_k, len(train_main)))
        counts[f"train.{fewshot_k}-shot"] = write_jsonl(
            shots, os.path.join(output_dir, f"train.{fewshot_k}-shot.jsonl")
        )
    return counts


def prepare_triviaqa(
    orig_dir: str,
    output_dir: str,
    index_dir: Optional[str] = None,
    fewshot_seed: Optional[int] = None,
    fewshot_k: int = 64,
) -> Dict[str, int]:
    """TriviaQA-unfiltered local files → split JSONL. With `index_dir`
    (Atlas TQA.{split}.idx.json files) the reference's exact index-based
    splits are reproduced (rag/prepare_qa.py:169-189); without it,
    train/dev come from the official files directly."""
    with open(os.path.join(orig_dir, "triviaqa-unfiltered",
                           "unfiltered-web-train.json")) as f:
        orig_train = json.load(f)["Data"]
    with open(os.path.join(orig_dir, "triviaqa-unfiltered",
                           "unfiltered-web-dev.json")) as f:
        orig_dev = json.load(f)["Data"]

    if index_dir:
        idx = {}
        for split in ("train", "dev", "test"):
            with open(os.path.join(index_dir, f"TQA.{split}.idx.json")) as f:
                idx[split] = json.load(f)
        data = {
            "train": [convert_triviaqa(orig_train[k]) for k in idx["train"]],
            "dev": [convert_triviaqa(orig_train[k]) for k in idx["dev"]],
            "test": [convert_triviaqa(orig_dev[k]) for k in idx["test"]],
        }
    else:
        data = {
            "train": [convert_triviaqa(e) for e in orig_train],
            "dev": [convert_triviaqa(e) for e in orig_dev],
        }
    if fewshot_seed is not None:
        rng = random.Random(fewshot_seed)
        data[f"train.{fewshot_k}-shot"] = rng.sample(
            data["train"], min(fewshot_k, len(data["train"]))
        )
    return {
        split: write_jsonl(rows, os.path.join(output_dir, f"{split}.jsonl"))
        for split, rows in data.items()
    }


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", choices=["nq", "triviaqa"])
    ap.add_argument("--orig_dir", required=True,
                    help="directory with the official files (see SOURCES)")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--index_dir", default=None)
    ap.add_argument("--fewshot_seed", type=int, default=None)
    args = ap.parse_args(argv)
    if args.dataset == "nq":
        counts = prepare_nq(args.orig_dir, args.output_dir,
                            fewshot_seed=args.fewshot_seed)
    else:
        counts = prepare_triviaqa(args.orig_dir, args.output_dir,
                                  index_dir=args.index_dir,
                                  fewshot_seed=args.fewshot_seed)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
