"""One-command MTEB evaluation CLI: `python -m gritlm_tpu_torch.eval.mteb ...`

Port of `gritlm_tpu.eval.mteb`, with the same flags, files and JSON keys
plus `--device` (default cuda; `--device cpu` runs the kernels' plain
versions). CLI counterpart of the reference's `python evaluation/eval_mteb.py`
(the reference's evaluation/eval_mteb.py:1081-1102 get_args, 1104-1262
main flow): per-task instruction sets (e5/medi2/instructor/...), instruction
formats (gritlm/zephyr/tulu/mistral), few-shot variants, skip-if-exists,
result JSON per task.

Two execution paths:
  - the stock `mteb` package when installed (dataset downloads required) —
    identical to the reference flow;
  - `--local_data_dir DIR` for air-gapped runs: BEIR-layout retrieval tasks
    (DIR/<task>/{corpus.jsonl,queries.jsonl,qrels.tsv}) scored by the
    self-contained nDCG/MAP/recall/MRR implementation (eval/retrieval.py:
    an fp32 FlatIndex searched by K9's fp32 kernel), matching the
    reference's patched AbsTaskRetrieval offline semantics; with
    `--rerank_top_k` the generative reranker rescores each query's head.

Example:
  python -m gritlm_tpu_torch.eval.mteb --model_name_or_path ckpt/ \\
      --task_names SciFact --instruction_set e5 --output_folder results/
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger("gritlm_tpu_torch.eval.mteb")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name_or_path", default=None, type=str)
    p.add_argument("--model_preset", default=None, type=str,
                   help="config preset w/ random init (tiny smoke runs)")
    p.add_argument("--attn", default="bbcc", type=str,
                   help="only first two letters matter for embedding")
    p.add_argument("--task_types", default=None,
                   help="comma separated; requires the mteb package")
    p.add_argument("--task_names", default=None, help="comma separated")
    p.add_argument("--instruction_set", default="e5", type=str,
                   help="e5 | medi2 | instructor-xl | bge | e5-mistral | none")
    p.add_argument("--instruction_format", default="gritlm", type=str,
                   help="gritlm | zephyr | tulu | mistral")
    p.add_argument("--no_instruction", action="store_true")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--max_length", default=None, type=int)
    p.add_argument("--num_shots", default=None, type=int,
                   help="few-shot in-instruction examples (1 supported)")
    p.add_argument("--dtype", default=None, type=str)
    p.add_argument("--output_folder", default=None, type=str)
    p.add_argument("--overwrite_results", action="store_true")
    p.add_argument("--pooling_method", default="mean", type=str)
    p.add_argument("--embedding_head", default=None, type=int,
                   help="projection head dim (reference --embedding_head)")
    p.add_argument("--save_qrels", action="store_true")
    p.add_argument("--top_k", default=10, type=int)
    p.add_argument("--rerank_top_k", default=0, type=int,
                   help="rescore the top-k retrieved docs per query with the "
                        "generative yes-logit reranker (offline path; loads "
                        "the LM head — reference AbsTaskRetrieval.py:276-345)")
    p.add_argument("--rerank_cache_dir", default=None, type=str,
                   help="per-query yes-score JSON cache dir")
    p.add_argument("--local_data_dir", default=None, type=str,
                   help="BEIR-layout local tasks dir (offline path)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device (default: the GPU)")
    return p


def _load_model(args):
    from gritlm_tpu_torch import GritLM

    # reranking scores a "yes" logit → needs the LM head (unified mode)
    mode = "unified" if getattr(args, "rerank_top_k", 0) else "embedding"
    kwargs = dict(mode=mode, pooling_method=args.pooling_method,
                  attn=args.attn, projection=args.embedding_head, device=args.device)
    if args.model_name_or_path:
        return GritLM.from_pretrained(args.model_name_or_path,
                                      dtype=args.dtype, **kwargs)
    if args.model_preset:
        import dataclasses

        from gritlm_tpu_torch import config as cfgmod

        cfg = getattr(cfgmod, args.model_preset)()
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        return GritLM(cfg, **kwargs)
    raise SystemExit("pass --model_name_or_path or --model_preset")


def _load_local_task(task_dir: str):
    """BEIR layout: corpus.jsonl ({_id,title,text}), queries.jsonl
    ({_id,text}), qrels.tsv or qrels/test.tsv (qid\\tdocid\\tscore)."""
    corpus, queries, qrels = {}, {}, {}
    with open(os.path.join(task_dir, "corpus.jsonl")) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                corpus[str(d["_id"])] = {
                    "title": d.get("title", ""), "text": d.get("text", "")
                }
    with open(os.path.join(task_dir, "queries.jsonl")) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                queries[str(d["_id"])] = d["text"]
    qrels_path = os.path.join(task_dir, "qrels.tsv")
    if not os.path.exists(qrels_path):
        qrels_path = os.path.join(task_dir, "qrels", "test.tsv")
    with open(qrels_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3 or parts[0].lower() in ("query-id", "qid"):
                continue
            qid, did, score = parts[0], parts[1], parts[2]
            qrels.setdefault(qid, {})[did] = int(float(score))
    return corpus, queries, qrels


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)

    from gritlm_tpu_torch.eval.mteb_adapter import (
        QUICK_EVAL,
        apply_few_shot,
        format_instruction,
        load_instructions,
    )

    model_name = ((args.model_name_or_path or args.model_preset or "model")
                  .rstrip("/").split("/")[-1])
    output_folder = args.output_folder or f"results/{model_name}"
    os.makedirs(output_folder, exist_ok=True)

    task_names = (args.task_names.split(",") if args.task_names
                  else list(QUICK_EVAL))
    # quick skip-if-exists for a single task (reference eval_mteb.py:1107-1112)
    if (args.task_names and len(task_names) == 1
            and not args.overwrite_results
            and os.path.exists(
                os.path.join(output_folder, f"{task_names[0]}.json"))):
        logger.info("results for %s exist, skipping", task_names[0])
        return {}

    instruction_set = (None if args.no_instruction
                       or args.instruction_set == "none"
                       else args.instruction_set)
    model = _load_model(args)
    max_length = args.max_length or 512

    # ---- offline path: local BEIR-layout retrieval tasks
    if args.local_data_dir:
        from gritlm_tpu_torch.eval.retrieval import evaluate_retrieval

        instructions = load_instructions(None, instruction_set)
        results = {}
        for task in task_names:
            out_path = os.path.join(output_folder, f"{task}.json")
            if os.path.exists(out_path) and not args.overwrite_results:
                logger.info("skip existing %s", task)
                continue
            instr = instructions.get(task, "")
            if args.num_shots:
                instr = apply_few_shot(instr, task, instruction_set or "e5")
            if isinstance(instr, dict):
                qi, ci = instr.get("query", ""), instr.get("corpus", "")
            else:
                qi = ci = instr
            corpus, queries, qrels = _load_local_task(
                os.path.join(args.local_data_dir, task)
            )
            reranker = None
            if args.rerank_top_k:
                from gritlm_tpu_torch.eval.rerank import (
                    GenerativeReranker,
                    load_rerank_template,
                )

                reranker = GenerativeReranker(
                    model, template=load_rerank_template(task),
                    max_length=max(max_length * 2, 512),
                    batch_size=args.batch_size,
                    cache_dir=(os.path.join(args.rerank_cache_dir, task)
                               if args.rerank_cache_dir else None),
                )
            metrics = evaluate_retrieval(
                model, corpus, queries, qrels,
                query_instruction=format_instruction(
                    qi, args.instruction_format),
                corpus_instruction=format_instruction(
                    ci, args.instruction_format),
                batch_size=args.batch_size, max_length=max_length,
                # retrieval must fetch at least as many candidates as the
                # reranker is asked to rescore
                top_k=max(args.top_k, 10, args.rerank_top_k),
                reranker=reranker, rerank_depth=args.rerank_top_k or 10,
            )
            logger.info("%s: %s", task, metrics)
            with open(out_path, "w") as f:
                json.dump({"task": task, "metrics": metrics}, f, indent=2)
            results[task] = metrics
        return results

    # ---- online path: the stock mteb harness (reference flow)
    if args.rerank_top_k:
        raise SystemExit(
            "--rerank_top_k is wired into the offline retrieval path only; "
            "pass --local_data_dir (the stock mteb harness drives its own "
            "search and exposes no rerank hook)")
    from gritlm_tpu_torch.eval.mteb_adapter import run_mteb

    return run_mteb(
        model,
        tasks=task_names,
        output_dir=output_folder,
        fmt=args.instruction_format,
        instruction_set=instruction_set,
        batch_size=args.batch_size,
        max_length=max_length,
        skip_existing=not args.overwrite_results,
        few_shot=bool(args.num_shots),
    )


if __name__ == "__main__":
    main()
