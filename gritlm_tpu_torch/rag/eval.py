"""One-command RAG evaluation: `python -m gritlm_tpu_torch.rag.eval ...`

Port of `gritlm_tpu.rag.eval` (the reference's `python rag/eval.py`), with
the same flags, file names and JSON keys plus `--device`: build or load a
passage index, answer QA eval sets under one of the 7 cache modes, write
`{tag}-metrics.json`; or run the reference's synthetic-latency protocol
(--latency --customq N --customd N -> `{tag}-latency.json` keyed
"{q}-{d}-{maxtoks}-{device}").

Example (toy smoke on the CPU):
  python -m gritlm_tpu_torch.rag.eval --model_preset tiny_mistral --device cpu \\
      --passages passages.jsonl --eval_data qa.jsonl \\
      --cache doc --max_new_tokens 8 --save_dir rag_out

A checkpoint directory (`--model_name_or_path`, HF safetensors with its
tokenizer) or a preset with random weights (`--model_preset`); int8 serving
weights with `--weight_quant`; greedy prompt-lookup speculative decoding
of the answers with `--speculative` (it sets --min_new_tokens to 0).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger("gritlm_tpu_torch.rag.eval")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # model
    p.add_argument("--model_name_or_path", default=None, type=str,
                   help="HF-style checkpoint dir")
    p.add_argument("--model_preset", default=None, type=str,
                   help="config preset w/ random init (tiny smoke runs)")
    p.add_argument("--pooling_method", default="mean", type=str)
    p.add_argument("--attn", default="bbcc", type=str)
    p.add_argument("--dtype", default=None, type=str)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the GPU)")
    # index / passages
    p.add_argument("--passages", nargs="+", default=None,
                   help="jsonl passage files to index")
    p.add_argument("--load_index_path", default=None, type=str)
    p.add_argument("--save_index_path", default=None, type=str)
    p.add_argument("--save_index_n_shards", default=1, type=int)
    p.add_argument("--limit", type=int, default=None,
                   help="limit number of passages to index")
    p.add_argument("--limit_start", type=int, default=0)
    p.add_argument("--embedbs", default=128, type=int,
                   help="batch size for embedding docs")
    # eval
    p.add_argument("--eval_data", nargs="+", default=[])
    p.add_argument("--task", type=str, default="qa", choices=["qa", "base"])
    p.add_argument("--n_context", type=int, default=1,
                   help="top-k passages for the reader (1 supported, "
                        "matching the reference's assert)")
    p.add_argument("--min_new_tokens", type=int, default=1)
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--cache", type=str, default=None,
                   help="None / query / doc / querydoc / docquery")
    p.add_argument("--prompt", type=str, default="default",
                   help="no-cache prompt order: default|query (query-then-"
                        "doc) or doc (doc-then-query)")
    p.add_argument("--per_gpu_batch_size", default=1, type=int)
    p.add_argument("--max_length", default=None, type=int)
    p.add_argument("--save_dir", default=None, type=str)
    p.add_argument("--no_retrieval", action="store_true")
    p.add_argument("--cache_docs", action="store_true",
                   help="precompute every doc's KV cache at index build "
                        "(host store; implied by --cache *doc*)")
    p.add_argument("--move_cache_to_cpu", action="store_true",
                   help="accepted for reference-CLI compatibility; the doc "
                        "store is always host-resident here")
    # latency protocol
    p.add_argument("--latency", action="store_true")
    p.add_argument("--customq", default=None, type=str,
                   help="synthetic query token length")
    p.add_argument("--customd", default=None, type=str,
                   help="synthetic doc token length")
    p.add_argument("--n_latency_queries", default=4, type=int,
                   help="batch size per timed answer call")
    p.add_argument("--latency_reps", default=10, type=int,
                   help="timed batched calls per cell")
    p.add_argument("--idxdtype", default="float32", type=str)
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV caches")
    p.add_argument("--weight_quant", action="store_true",
                   help="w8a16 serving: int8 weights + lm head")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding for the answer step "
                        "(greedy-only; forces --min_new_tokens 0)")
    p.add_argument("--spec_k", type=int, default=7,
                   help="speculative lookahead tokens per verify step")
    p.add_argument("--spec_ngram", type=int, default=3,
                   help="trailing n-gram length for prompt lookup")
    return p


def _load_model(args):
    import dataclasses

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch import config as cfgmod

    kwargs = dict(mode="unified", pooling_method=args.pooling_method, attn=args.attn,
                  kv_quant=args.kv_quant, weight_quant=args.weight_quant, device=args.device)
    if args.model_name_or_path:
        return GritLM.from_pretrained(args.model_name_or_path, dtype=args.dtype, **kwargs)
    if args.model_preset:
        cfg = getattr(cfgmod, args.model_preset)()
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        return GritLM(cfg, **kwargs)
    raise SystemExit("pass --model_name_or_path or --model_preset")


def _mode_for(args):
    from gritlm_tpu_torch.rag.engine import CacheMode

    if args.no_retrieval:
        return CacheMode.NO_RETRIEVAL
    if args.cache in (None, "None"):
        return (CacheMode.PROMPT_DOC_QUERY if args.prompt == "doc"
                else CacheMode.PROMPT_QUERY_DOC)
    return CacheMode(args.cache)


def _dataset_tag(args, data_path: str) -> str:
    name, _ = os.path.splitext(os.path.basename(data_path))
    tag = (f"{name}-{args.cache if args.cache is not None else 'nocache'}-"
           f"{args.max_new_tokens}maxtoks-{args.prompt}prompt")
    if args.no_retrieval:
        tag += "-noretrieval"
    return tag


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    if args.cache == "None":
        args.cache = None
    if args.n_context != 1:
        raise SystemExit("Only 1 passage per query supported for now "
                         "(matches the reference assert, rag/eval.py:221)")

    from gritlm_tpu_torch.eval.latency import measure_latency, synthetic_text
    from gritlm_tpu_torch.index.flat import FlatIndex
    from gritlm_tpu_torch.rag.corpus import limit_passages, load_passages
    from gritlm_tpu_torch.rag.engine import RAGEngine
    from gritlm_tpu_torch.rag.tasks import data_iterator, get_task

    model = _load_model(args)
    if args.max_length:
        encode_max_length = args.max_length
    elif args.customd:
        encode_max_length = max(int(args.customd) + 64, 128)
    else:
        encode_max_length = 2048
    engine = RAGEngine(model, max_new_tokens=args.max_new_tokens,
                       min_new_tokens=0 if args.speculative else args.min_new_tokens,
                       encode_max_length=encode_max_length, speculative=args.speculative,
                       spec_ngram=args.spec_ngram, spec_k=args.spec_k)

    cache_docs = args.cache_docs or (args.cache is not None and "doc" in args.cache)
    if not args.no_retrieval:
        if args.load_index_path:
            engine.index = FlatIndex.load(args.load_index_path, device=model.device)
            logger.info("loaded index: %d passages", len(engine.index.passages))
            store_path = os.path.join(args.load_index_path, "doc_store.npz")
            if cache_docs and os.path.exists(store_path):
                n = engine.load_doc_store(store_path)
                # the store must match this run's KV precision
                entry0 = next(iter(engine._doc_store.values()), None)
                store_quant = entry0 is not None and entry0[3] is not None
                if entry0 is not None and store_quant != bool(args.kv_quant):
                    logger.warning(
                        "doc_store.npz is %s but --kv_quant=%s — ignoring the store and "
                        "precomputing fresh caches",
                        "int8" if store_quant else "bf16", args.kv_quant)
                    engine._doc_store = {}
                    engine.precompute_all_doc_caches(batch_size=min(args.embedbs, 8))
                else:
                    logger.info("loaded doc-cache store: %d entries "
                                "(corpus KV precompute skipped)", n)
            elif cache_docs:
                engine.precompute_all_doc_caches(batch_size=min(args.embedbs, 8))
        else:
            if args.latency and args.customd:
                passages = [{"title": "",
                             "text": synthetic_text(model.tokenizer, int(args.customd))}
                            for _ in range(16)]
            elif args.passages:
                passages = load_passages(args.passages)
                passages = limit_passages(passages, args.limit, args.limit_start)
            else:
                raise SystemExit("pass --passages, --load_index_path, "
                                 "--no_retrieval, or --latency --customd N")
            logger.info("indexing %d passages (cache_docs=%s)", len(passages), cache_docs)
            engine.build_index(passages, batch_size=args.embedbs, cache_docs=cache_docs,
                               cache_batch_size=min(args.embedbs, 8))
        if args.save_index_path:
            os.makedirs(args.save_index_path, exist_ok=True)
            engine.index.save(args.save_index_path, args.save_index_n_shards)
            if engine._doc_store:
                engine.save_doc_store(os.path.join(args.save_index_path, "doc_store.npz"))
                logger.info("saved doc-cache store (%d entries)", len(engine._doc_store))

    save_dir = args.save_dir or "gritlmresults"
    os.makedirs(save_dir, exist_ok=True)
    task = get_task(args.task)
    all_metrics = {}

    eval_sets = args.eval_data or (["synthetic"] if args.latency else [])
    for data_path in eval_sets:
        tag = _dataset_tag(args, data_path)

        if args.latency:
            latency_path = os.path.join(save_dir, f"{tag}-latency.json")
            latency = {}
            if os.path.exists(latency_path):
                with open(latency_path) as f:
                    latency = json.load(f)
            key = f"{args.customq}-{args.customd}-{args.max_new_tokens}-{model.device.type}"
            if key in latency:
                logger.info("latency results for %s already exist", key)
                continue
            query = (synthetic_text(model.tokenizer, int(args.customq))
                     if args.customq else "What is the answer?")
            stats = measure_latency(engine, query, _mode_for(args),
                                    n_queries=args.n_latency_queries, reps=args.latency_reps,
                                    max_new_tokens=args.max_new_tokens)
            stats.update(q_len=args.customq, d_len=args.customd)
            latency[key] = stats
            with open(latency_path, "w") as f:
                json.dump(latency, f, indent=2)
            logger.info("%s → %s", key, stats)
            all_metrics[tag] = stats
            continue

        examples = [task.process(e) for e in data_iterator(data_path)]
        queries = [e["query"] for e in examples]
        golds = [task.gold_answers(e) for e in examples]
        logger.info("evaluating %s: %d queries, mode=%s", data_path, len(queries),
                    _mode_for(args).value)
        metrics = engine.evaluate(queries, golds, mode=_mode_for(args),
                                  max_new_tokens=args.max_new_tokens,
                                  batch_size=args.per_gpu_batch_size)
        msg = f"Dataset: {tag}"
        for k, v in metrics.items():
            if isinstance(v, float):
                msg += f" | {v:.3f} {k}"
        logger.info(msg)
        with open(os.path.join(save_dir, f"{tag}-metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        all_metrics[tag] = metrics
    return all_metrics


if __name__ == "__main__":
    main()
