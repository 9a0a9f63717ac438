"""Serving CLI: drive the continuous-batching engine (port of gritlm_tpu.serve).

Dense or paged KV pools, int8 KV, chunked prefill, sampled requests, the
prompt-lookup speculative verify pool (--speculative, greedy), and unified
pools that serve embedding requests beside generation, on one CUDA device
(or the CPU with --device cpu, where the kernels run their plain versions).
The engine samples (ServingEngine(sampling=True)) when any request has a
temperature above 0.

Request file: one JSON object per line.

  {"id": "g0", "prompt": "<s><|user|>\\nHi\\n<|assistant|>\\n",
   "max_new_tokens": 32, "temperature": 0.7, "top_k": 0, "top_p": 0.9,
   "seed": 0, "priority": 0}
  {"id": "e0", "type": "embed", "text": "a passage to embed",
   "instruction": "<|user|>\\nRepresent this\\n<|embed|>\\n"}

Output file: one JSON object per line, in finish order.

  {"id": "g0", "type": "generate", "text": "...", "token_ids": [...],
   "finish_reason": "eos"}
  {"id": "e0", "type": "embed", "embedding": [...]}

Usage:
  python -m gritlm_tpu_torch.serve --model_preset tiny_mistral \\
      --requests reqs.jsonl --out done.jsonl --slots 8 --max_len 2048

A checkpoint directory (`--model_name_or_path`, HF safetensors with its
tokenizer) or a preset with random weights (`--model_preset`); w8a16 or
w4a16 weights with `--weight_quant` (or `--weight_quant 4`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gritlm_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--model_name_or_path", default=None, type=str,
                   help="HF-layout checkpoint dir")
    p.add_argument("--model_preset", default=None, type=str,
                   help="config preset w/ random init (tiny smoke runs)")
    p.add_argument("--dtype", default=None, type=str)
    p.add_argument("--requests", required=True, type=str,
                   help="JSONL request file (see module docstring)")
    p.add_argument("--out", required=True, type=str,
                   help="JSONL output file (finish order)")
    p.add_argument("--slots", type=int, default=8,
                   help="decode slot pool size (max concurrent requests)")
    p.add_argument("--max_len", type=int, default=4096)
    p.add_argument("--chunk_size", type=int, default=16,
                   help="decode steps per device chunk")
    p.add_argument("--prompt_buckets", type=str, default="64,128,256,512,1024,2048",
                   help="comma-separated prefill bucket lengths")
    p.add_argument("--embed_batch", type=int, default=None,
                   help="rows per embedding dispatch (default: --slots)")
    p.add_argument("--kv_quant", action="store_true", help="int8 KV pool")
    p.add_argument("--weight_quant", default=False, nargs="?", const=True,
                   type=lambda s: int(s), help="w8a16 serving weights (pass 4 for int4)")
    p.add_argument("--paged", action="store_true",
                   help="shared page pool instead of dense slots")
    p.add_argument("--page_size", type=int, default=256)
    p.add_argument("--pool_pages", type=int, default=None)
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative verify pool (greedy)")
    p.add_argument("--spec_k", type=int, default=7)
    p.add_argument("--spec_ngram", type=int, default=3)
    p.add_argument("--prefill_chunk", type=int, default=None,
                   help="stall-free chunked prefill (tokens per chunk)")
    p.add_argument("--no_overlap", action="store_true",
                   help="strict admit-before-decode scheduling")
    p.add_argument("--pooling_method", default="mean", type=str)
    p.add_argument("--attn", default="bbcc", type=str)
    p.add_argument("--max_new_tokens", type=int, default=64,
                   help="default for requests that do not set it")
    p.add_argument("--stream", action="store_true",
                   help="print tokens to stderr as they generate")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: cuda; cpu runs the kernels' plain versions)")
    return p


def _load_model(args):
    from gritlm_tpu_torch import GritLM

    kwargs = dict(mode="unified", pooling_method=args.pooling_method, attn=args.attn,
                  kv_quant=args.kv_quant, weight_quant=args.weight_quant, device=args.device)
    if args.model_name_or_path:
        return GritLM.from_pretrained(args.model_name_or_path, dtype=args.dtype, **kwargs)
    if args.model_preset:
        import dataclasses

        from gritlm_tpu_torch import config as cfgmod

        cfg = getattr(cfgmod, args.model_preset)()
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        return GritLM(cfg, **kwargs)
    raise SystemExit("pass --model_name_or_path or --model_preset")


def _to_requests(rows: List[dict], model, default_new: int):
    """JSONL rows -> (Request | EmbedRequest) list, tokenized with the model's
    tokenizer (instruction masking as in encode)."""
    import numpy as np

    from gritlm_tpu_torch.serving import EmbedRequest, Request
    from gritlm_tpu_torch.tokenizer import instruction_token_lens

    out = []
    for i, row in enumerate(rows):
        rid = row.get("id", f"req{i}")
        if row.get("type") == "embed":
            instr = row.get("instruction", "")
            enc = model.tokenizer([instr + row["text"] + model.embed_eos],
                                  max_length=model.seq_buckets[-1])
            ids = np.asarray(enc["input_ids"])
            mask = np.asarray(enc["attention_mask"])
            n = int(mask[0].sum())
            ilen = 0
            if instr:
                ilen = int(instruction_token_lens(model.tokenizer, instr, ids, mask)[0])
            out.append(EmbedRequest(input_ids=ids[0, :n].tolist(), instr_len=ilen,
                                    request_id=rid, priority=int(row.get("priority", 0)),
                                    adapter=row.get("adapter")))
        else:
            ids = model.tokenizer._encode_one(row["prompt"], add_special_tokens=False)
            out.append(Request(input_ids=list(ids),
                               max_new_tokens=int(row.get("max_new_tokens", default_new)),
                               request_id=rid, temperature=float(row.get("temperature", 0.0)),
                               top_k=int(row.get("top_k", 0)),
                               top_p=float(row.get("top_p", 1.0)),
                               seed=int(row.get("seed", 0)),
                               priority=int(row.get("priority", 0)),
                               adapter=row.get("adapter")))
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)

    from gritlm_tpu_torch.serving import ServingEngine

    model = _load_model(args)
    with open(args.requests) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    reqs = _to_requests(rows, model, args.max_new_tokens)
    sampling = any(getattr(r, "temperature", 0.0) > 0.0 for r in reqs)

    on_token = None
    if args.stream:
        on_token = lambda rid, tok: print(f"{rid}\t{tok}", file=sys.stderr, flush=True)

    eng = ServingEngine(
        model.config, model.params,
        max_batch=args.slots, max_len=args.max_len, kv_quant=args.kv_quant,
        eos_id=model.tokenizer.eos_token_id, pad_id=model.tokenizer.pad_token_id,
        chunk_size=args.chunk_size,
        prompt_buckets=tuple(int(b) for b in args.prompt_buckets.split(",")),
        overlap=not args.no_overlap, paged=args.paged, page_size=args.page_size,
        pool_pages=args.pool_pages, sampling=sampling, speculative=args.speculative,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram, prefill_chunk=args.prefill_chunk,
        pooling_method=args.pooling_method, embed_causal=model.embed_causal,
        embed_batch=args.embed_batch, on_token=on_token, device=model.device,
    )
    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0
    embs = eng.take_embeddings()

    n_tok = sum(len(c.token_ids) for c in done)
    with open(args.out, "w") as f:
        for c in done:
            f.write(json.dumps({
                "id": c.request_id, "type": "generate",
                "text": model.tokenizer.decode(c.token_ids), "token_ids": c.token_ids,
                "finish_reason": c.finish_reason,
            }) + "\n")
        for e in embs:
            f.write(json.dumps({
                "id": e.request_id, "type": "embed",
                "embedding": [float(x) for x in e.embedding],
            }) + "\n")
    summary = {
        "requests": len(reqs), "completions": len(done), "embeddings": len(embs),
        "generated_tokens": n_tok, "wall_seconds": round(wall, 3),
        "tokens_per_second": round(n_tok / wall, 1) if wall > 0 else 0.0,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
