"""MTEB result aggregation: CQADupstack merge, per-type averages, tables
(port of gritlm_tpu.eval.aggregate; numpy-free and device-free).

Counterpart of the reference's scripts/merge_cqadupstack.py and
scripts/mteb_to_tex.py: consumes the per-task JSON files MTEB writes under
`results/<model>/`, merges the 12 CQADupstack subforums into one virtual
task, extracts each task's main score, and emits per-task-type averages plus
the 56-task English average as markdown/LaTeX tables.

CLI: python -m gritlm_tpu_torch.eval.aggregate <results_dir> [--tex out.tex]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------- task lists
# Public MTEB v1 English benchmark composition (56 tasks, 7 types).

CQADUPSTACK_SUBFORUMS = [
    f"CQADupstack{n}Retrieval"
    for n in ("Android", "English", "Gaming", "Gis", "Mathematica", "Physics",
              "Programmers", "Stats", "Tex", "Unix", "Webmasters", "Wordpress")
]

TASKS_BY_TYPE: Dict[str, List[str]] = {
    "Classification": [
        "AmazonCounterfactualClassification", "AmazonPolarityClassification",
        "AmazonReviewsClassification", "Banking77Classification",
        "EmotionClassification", "ImdbClassification",
        "MassiveIntentClassification", "MassiveScenarioClassification",
        "MTOPDomainClassification", "MTOPIntentClassification",
        "ToxicConversationsClassification",
        "TweetSentimentExtractionClassification",
    ],
    "Clustering": [
        "ArxivClusteringP2P", "ArxivClusteringS2S", "BiorxivClusteringP2P",
        "BiorxivClusteringS2S", "MedrxivClusteringP2P", "MedrxivClusteringS2S",
        "RedditClustering", "RedditClusteringP2P", "StackExchangeClustering",
        "StackExchangeClusteringP2P", "TwentyNewsgroupsClustering",
    ],
    "PairClassification": [
        "SprintDuplicateQuestions", "TwitterSemEval2015", "TwitterURLCorpus",
    ],
    "Reranking": [
        "AskUbuntuDupQuestions", "MindSmallReranking", "SciDocsRR",
        "StackOverflowDupQuestions",
    ],
    "Retrieval": [
        "ArguAna", "ClimateFEVER", "CQADupstackRetrieval", "DBPedia", "FEVER",
        "FiQA2018", "HotpotQA", "MSMARCO", "NFCorpus", "NQ", "QuoraRetrieval",
        "SCIDOCS", "SciFact", "Touche2020", "TRECCOVID",
    ],
    "STS": [
        "BIOSSES", "SICK-R", "STS12", "STS13", "STS14", "STS15", "STS16",
        "STS17", "STS22", "STSBenchmark",
    ],
    "Summarization": ["SummEval"],
}

TASK_TO_TYPE = {t: ty for ty, ts in TASKS_BY_TYPE.items() for t in ts}

# main metric per task type (MTEB conventions)
_MAIN_METRIC = {
    "Classification": ("accuracy",),
    "Clustering": ("v_measure",),
    "PairClassification": ("ap", "cos_sim.ap", "max.ap"),
    "Reranking": ("map", "map_at_1000"),
    "Retrieval": ("ndcg_at_10",),
    "STS": ("spearman", "cos_sim.spearman"),
    "Summarization": ("spearman", "cos_sim.spearman"),
}

_NOAVG_KEYS = ("evaluation_time", "mteb_version", "mteb_dataset_name",
               "dataset_revision")
_SPLIT_PREF = ("test", "dev", "validation", "train")


# ------------------------------------------------------------------- parsing

def _dig(d: dict, dotted: str):
    for part in dotted.split("."):
        if not isinstance(d, dict) or part not in d:
            return None
        d = d[part]
    return d


def _pick_split(results: dict) -> Optional[dict]:
    for s in _SPLIT_PREF:
        if isinstance(results.get(s), dict):
            return results[s]
    return None


def main_score(task_name: str, results: dict) -> Optional[float]:
    """Extract the task's main score from an MTEB result JSON (handles both
    flat `{test: {ndcg_at_10: …}}` and nested `{test: {en: {…}}}` /
    `{test: {cos_sim: {…}}}` shapes)."""
    split = _pick_split(results)
    if split is None:
        return None
    task_type = TASK_TO_TYPE.get(task_name)
    metrics = _MAIN_METRIC.get(task_type, ("main_score",)) + ("main_score",)
    candidates = [split]
    for lang in ("en", "en-en", "default"):
        if isinstance(split.get(lang), dict):
            candidates.append(split[lang])
    for c in candidates:
        for m in metrics:
            v = _dig(c, m)
            if isinstance(v, (int, float)):
                return float(v)
    return None


def merge_cqadupstack(results_dir: str, write: bool = True) -> Optional[dict]:
    """Average the 12 subforum results into CQADupstackRetrieval.json
    (reference merge_cqadupstack.py: per-split metric mean; evaluation_time
    summed; requires all 12 present)."""
    files = {
        os.path.splitext(os.path.basename(f))[0]: f
        for f in glob.glob(os.path.join(results_dir, "CQADupstack*Retrieval.json"))
    }
    present = [files[t] for t in CQADUPSTACK_SUBFORUMS if t in files]
    if len(present) != len(CQADUPSTACK_SUBFORUMS):
        return None
    merged: dict = {}

    def acc(dst: dict, src: dict, w: float):
        for k, v in src.items():
            if isinstance(v, dict):
                acc(dst.setdefault(k, {}), v, w)
            elif isinstance(v, (int, float)) and k not in _NOAVG_KEYS:
                dst[k] = dst.get(k, 0.0) + v * w
            elif k == "evaluation_time":
                dst[k] = dst.get(k, 0.0) + v
            elif k not in dst:
                dst[k] = v

    w = 1.0 / len(present)
    for f in present:
        with open(f, encoding="utf-8") as fh:
            acc(merged, json.load(fh), w)
    merged["mteb_dataset_name"] = "CQADupstackRetrieval"
    if write:
        out = os.path.join(results_dir, "CQADupstackRetrieval.json")
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(merged, fh, indent=1)
    return merged


# ----------------------------------------------------------------- summaries

def collect_scores(results_dir: str) -> Dict[str, float]:
    """task name → main score for every known task JSON in the directory."""
    merge_cqadupstack(results_dir, write=True)
    scores: Dict[str, float] = {}
    for f in glob.glob(os.path.join(results_dir, "*.json")):
        name = os.path.splitext(os.path.basename(f))[0]
        if name not in TASK_TO_TYPE:
            continue
        with open(f, encoding="utf-8") as fh:
            try:
                res = json.load(fh)
            except json.JSONDecodeError:
                continue
        s = main_score(name, res)
        if s is not None:
            scores[name] = 100.0 * s if s <= 1.0 else s
    return scores


def summarize(scores: Dict[str, float]) -> Dict[str, Tuple[float, int, int]]:
    """Per-type (avg, n_done, n_total) + 'Average' over all done tasks."""
    out: Dict[str, Tuple[float, int, int]] = {}
    done_all: List[float] = []
    for ty, tasks in TASKS_BY_TYPE.items():
        vals = [scores[t] for t in tasks if t in scores]
        done_all += vals
        out[ty] = (sum(vals) / len(vals) if vals else float("nan"),
                   len(vals), len(tasks))
    n_total = sum(len(t) for t in TASKS_BY_TYPE.values())
    out["Average"] = (sum(done_all) / len(done_all) if done_all else float("nan"),
                      len(done_all), n_total)
    return out


def to_markdown(summary: Dict[str, Tuple[float, int, int]],
                model: str = "model") -> str:
    lines = [f"| {model} | score | tasks |", "|---|---|---|"]
    for ty, (avg, n, total) in summary.items():
        lines.append(f"| {ty} | {avg:.2f} | {n}/{total} |")
    return "\n".join(lines)


def to_latex(summaries: Dict[str, Dict[str, Tuple[float, int, int]]]) -> str:
    """Multi-model LaTeX table (reference mteb_to_tex.py output shape)."""
    types = list(TASKS_BY_TYPE) + ["Average"]
    head = " & ".join(["Model"] + types) + r" \\"
    rows = []
    for model, s in summaries.items():
        cells = [model.replace("_", r"\_")]
        for ty in types:
            avg = s.get(ty, (float("nan"), 0, 0))[0]
            cells.append("-" if avg != avg else f"{avg:.1f}")
        rows.append(" & ".join(cells) + r" \\")
    return "\n".join(
        [r"\begin{tabular}{l" + "c" * len(types) + "}", r"\toprule", head,
         r"\midrule", *rows, r"\bottomrule", r"\end{tabular}"]
    )


LMEVAL_DS_NAMES = {
    "arc_challenge": "ARC-C", "arc_easy": "ARC-E", "boolq": "BoolQ",
    "piqa": "PIQA", "winogrande": "Winogrande",
}


def lmeval_table(results_files: Dict[str, str]) -> str:
    """LaTeX table from LM-eval-harness `rank_eval.json` files, one column
    per model ({model_name: path}) — reference scripts/lmeval_to_tex.py:
    per-dataset `acc`*100 plus a trailing Average row."""
    import json as _json
    import statistics

    per_ds: Dict[str, list] = {}
    avgs = []
    for _, path in results_files.items():
        with open(path) as f:
            results = _json.load(f)["results"]
        accs = []
        for ds, v in sorted(results.items()):
            if "acc" in v:
                name = LMEVAL_DS_NAMES.get(ds, ds)
                per_ds.setdefault(name, []).append(round(v["acc"] * 100, 2))
                accs.append(v["acc"])
        avgs.append(round(statistics.mean(accs) * 100, 2) if accs else
                    float("nan"))
    lines = ["Model & " + " & ".join(results_files) + r" \\"]
    for ds, vals in sorted(per_ds.items()):
        lines.append(ds + " & " + " & ".join(str(x) for x in vals) + r" \\")
    lines.append("Average & " + " & ".join(str(x) for x in avgs) + r" \\")
    return "\n".join(lines)


def alpaca_median_length(path: str) -> int:
    """Median AlpacaEval generation length in characters (reference
    scripts/alpaca_median.py — used to report length-controlled wins)."""
    import json as _json

    with open(path) as f:
        data = [_json.loads(line) for line in f if line.strip()]
    lengths = sorted(len(d["output"]) for d in data)
    return lengths[len(lengths) // 2]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("results_dir",
                    help="per-model results dir, or a dir of model dirs")
    ap.add_argument("--tex", default=None, help="write a LaTeX table here")
    args = ap.parse_args(argv)

    subdirs = [d for d in sorted(glob.glob(os.path.join(args.results_dir, "*")))
               if os.path.isdir(d)]
    model_dirs = subdirs or [args.results_dir]
    summaries = {}
    for d in model_dirs:
        scores = collect_scores(d)
        if not scores:
            continue
        model = os.path.basename(d.rstrip("/"))
        summaries[model] = summarize(scores)
        print(to_markdown(summaries[model], model))
        print()
    if args.tex and summaries:
        with open(args.tex, "w") as f:
            f.write(to_latex(summaries))
        print(f"wrote {args.tex}")


if __name__ == "__main__":
    main()
