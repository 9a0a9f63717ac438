#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gritlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from gritlm_tpu_torch/csrc, holds
each against its plain PyTorch version at Mistral-7B shapes, drives the
port's paths through the kernels on a full-width Mistral-7B with random
bf16 weights (GritLM.encode and greedy GritLM.generate; FlatIndex.search
over a 1M-row index; RAGEngine.build_index and answer_batch in all seven
cache modes; the continuous-batching ServingEngine with dense, paged and
int8 pools, and RAGEngine.serve; speculative decoding in generate and in
dense and paged verify pools, and sampling pools; w8a16 and w4a16
quantized weights in generate and serving; GRIT training with LoRA, QLoRA, GradCache and full
parameters through `python -m gritlm_tpu_torch.training.run`'s main; the
embedding projection head in encode and in training; then a Mixtral-8x7B
of random bf16 weights at its published width, depth cut to 4, through
encode, generate and the serving engine, and at depth 4 with int8
weights, and GRIT training on it (LoRA at depth 4, the load-balancing
aux loss, gshard's capacity drops, `training.run --moe_impl
--native_loader`); per-request LoRA adapters in the serving engine and the
remat policies of LoRA training; then head dims 64 and 96 in flash
attention, flash decode and paged decode, and Llama-3.2-1B at its
published width and depth through encode, generate, the serving engine
and RAG; the flash backward at head dims 64 and 96 and GRIT training of
Llama-3.2-1B at its published width and depth; the evaluation path: the
MTEB CLI with the generative reranker over an fp32 index, the generative
benchmarks, hard-negative mining and the checkpoint tools; the fp32 forms
of K1, K2, K3 and K8 and GritLM at fp32 activations at Mistral-7B width;
the fp32 forms of K4 and K5, fp32 activations through K6 and K7, and GRIT
training at fp32 through `training.run --dtype float32`), and times each
kernel beside its bound, its plain version and one PyTorch library call.

Cuts for the 1200 s limit (each path still driven; printed figures at the
cut size): phases 13 and 15 run Mixtral at MOE_DEPTH 4 layers (16 before
phase 19 was added, 8 before phase 20), phase 14's remat policies at
REMAT_DEPTH 2 (8 before phase 19, 4 before phase 20), phase 14's adapter
pools and phase 12's pools phase 7's 8-request cut (phase 14's took its
24 before phase 19), phase 12's lockstep speculative generate 16 tokens
(64 before phase 19, 32 before phase 20), phase 10's LoRA steps on one
batch 4 (6 before) and those and its QLoRA steps at TRAIN_BATCH_DEPTH 16
layers (32 before phase 20), the decode chunks' profiler windows 8 steps,
phase 10's LoRA CLI run at depth 4 (32 layers and a 13.5 GiB export before
phase 20), phase 17's LoRA steps on one batch 4 (6 before phase 20).

Phases (in the order 1-7, 12, 14, 8, 9, 11, 18's eval leg, 19, 16, 13, 15,
10, 17, 18's tools leg, 20), any failure exits non-zero:
  1. device and build: card name and power limit, nvcc's register and
     shared-memory report; for the redesigned kernels (K1, K4/K5, K9 on
     wgmma; K3, K8, K6 and K7 on mma.sync; K2 on bulk copies and clusters)
     their registers and spill bytes
     (the wgmma kernels' dynamic shared memory too), failing on a spill or
     a serialised wgmma (each library's ptxas report is kept beside it in
     the build cache, so a cached build is checked too); the fp32 forms of
     K1, K2, K3, K8, K4 and K5 apart from the bf16 ones, a spill failing
  2. each kernel against its plain version on the card (K1 and its LSE at
     three shapes; K9 at three shapes: a masked tail, Q = 3, a partial
     last segment, and K9 [f32] at the same three within K9_F32_ATOL, each
     rerun bit-equal; K3 at Sq 1 and 64, its int8 cache, and the serving
     decode chunk's call (B 8, Smax 4096, mask-bounded, ragged rows); K8
     at the serving shape, bf16 and int8, Sq 1 and a causal Sq 8 chunk, and
     against K3 on the same logical cache laid out dense; K2 at B 8 S 512
     mean and weightedmean and at K2_SHAPES: B 1 S 4096, B 64 S 128 with an
     empty row, D 3584, rows that are views into wider ones; normalized and
     not, every call rerun and required bit-equal); the fp32 forms within
     F32_ATOL, every call rerun bit-equal (f32_cases, f32_checks): K1 [f32]
     at the three K1 shapes with its LSE at Dh 128, 64 and 96 (padded) and
     a row with every key masked (0, LSE NEG_INF), K2 [f32] at B 8 S 512
     and K2_SHAPES, K3 [f32] at K3's four shapes and the verify chunk (Sq
     8, [B] offsets, fp32 and int8 caches, bit-equal to K8 [f32]), K8
     [f32] at K8_SHAPES on pages of 32 and 256 slots, bit-equal to K3
     [f32] on the same logical cache
  3. encode at full width (launch counts set to 0 before encode, read after
     phase 4); then GritLM(projection=1024) on the same weights (counts set
     to 0 before, read after): 16 sentences to [16, 1024] without K2, at
     cosine >= COSINE_MIN to an fp32 rms_norm -> @ W + b -> pool ->
     normalize of the same hidden state
  4. greedy generate at full width: prefill through K1 (bucket >= 128) and
     through K3 (bucket 64), generate from an encode(get_cache=True), and
     generate over the int8 KV cache
  5. search at index size: 1,000,000 random unit bf16 rows of width 4096 in
     a FlatIndex of capacity 2^20, exact top-100 for 256 queries through K9
     (counts set to 0 before, read after), values held against a plain
     top-k; K9 and the library timed by CUDA events at Q 256, 128 and 4
     (GB/s, a reading above the card's peak marked invalid; torch.profiler
     beside); search ms per 256-query block
  6. RAG at full width (counts set to 0 before, read after): build_index
     over the 16 sentences with doc caches, self-retrieval at top-1,
     answer_batch of 4 queries in all seven cache modes, the device doc
     pool against the host store in DOC mode
  7. serving at full width (counts set to 0 before each run, read after):
     ServingEngine(max_batch=8, max_len=4096, chunk_size=16) over 24
     generation requests (prompts of 32-1900 tokens, 8-64 new tokens) and 8
     embedding requests, with a dense bf16, a paged bf16 (page 256) and a
     paged int8 pool, and a dense pool with prefill_chunk=256 (8 requests);
     completions, K3/K8 in the decode chunks, pool embeddings against
     GritLM.encode, a teacher-forced check of 4 requests per run (TIE_TOL),
     tokens/s, time to first token, device ms per decode step at B = 8 and
     its idle share, the paged pool's peak KV reservation; then
     RAGEngine.serve of 4 queries, dense and paged
  8. the reference latency protocol through eval.latency.run_sweep: 16
     synthetic docs of 250 and of 2000 tokens, 250-token queries, five
     modes, batch 4, 16 new tokens, 1 warm-up and 3 timed calls
  9. kernel times (device time from torch.profiler, and per-call time
     between CUDA events, 25 calls after warm-up; K1 and SDPA also by CUDA
     events around replays of ten captured calls, the table's figure, and
     around calls launched back to back; K3 and SDPA by CUDA events around
     graph replays over enough cache layers that every read is cold, at Sq
     1 and 64, the int8 cache and the serving chunk's call, and K8 and SDPA
     the same way at its four phase-2 shapes; K3's and K8's device
     operations a call counted, more than one failing; K2 and its library
     call by CUDA events around graph replays over copies of the hidden
     state so that every read is cold, at B 8 S 512 mean (the table's row)
     and weightedmean, B 1 S 4096 and B 64 S 128, its device operations a
     call counted from a captured graph, more than one failing; K9 [f32] at
     Q 256 against 2^18 fp32 rows of 4096 beside torch.mm in fp32 with TF32
     off, its bound from the card's SM count and clock; the fp32 forms as
     their bf16 forms (f32_times: K3 [f32] at k3_times' shapes and the
     verify chunk, K8 [f32] at Sq 1 and 8 and over int8 pages, K2 [f32] at
     B 8 S 512, K1 [f32] at B 4 S 512 beside SDPA at fp32, whose backend is
     printed), each bound at the fp32 FMA rate), encode and
     decode rates, and a profile (device time by kernel, idle share) of one
     encode and one short generate
 10. training at full width (after the inference model is freed):
     K4 and K5 against the plain backward at B 2, S 2048, H 32, Hkv 8
     (causal with right padding, bidirectional with padding, causal with a
     512 window, a fully masked row with exactly zero gradients; the first
     case rerun bit-equal) and FlashAttentionFn against autograd through
     the plain forward; then,
     with the counts set to 0 before and read after: LoRA GRIT training at
     Mistral-7B width and depth 4 through training.run.main
     --model_name_or_path on synthetic JSONL filling the default lengths
     (query 256, passage 2048, generative 2048; batch 4, group 2; 3 steps,
     a checkpoint at step 2, a resumed run from it, the HF export read back
     equal by load_checkpoint); 4 LoRA steps on one batch at
     TRAIN_BATCH_DEPTH 16 (the loss falls); GradCache
     (gc_chunks 2 against 1 at depth 4: loss_emb and the gradients'
     cosine); full-parameter training at depth 4 (peak memory; phase 17
     trains full parameters at full depth); K4 and K5
     timed at the passage shape (B 8, S 2048, bidirectional) and the
     generative shape (B 4, S 2048, causal) beside the backward of
     scaled_dot_product_attention, each by CUDA events around calls
     launched back to back and by torch.profiler, with the achieved
     TFLOP/s (a reading above the card's peak fails) and the library's
     kernel names; K1 with its LSE at both shapes by events beside SDPA's
     forward; 3 QLoRA steps (int8 base,
     make_lora_train_state(quantize=True)) at 16 layers: ms per step, peak
     memory against LoRA's, finite losses; `training.run
     --model_name_or_path <a depth-4 checkpoint> --projection 1024` with
     full parameters, 3 steps: finite losses, the head moved from its draw,
     and the export encodes to 1024 columns through from_pretrained
 11. quantized weights at full width (runs after phase 9, before phase 10
     frees the inference model; counts set to 0 before each run and read
     after): K6 (w8a16) and K7 (w4a16) against their plain versions at
     Mistral-7B's projections (K6 at M 1-512, K7 at M 1-16), a layer view
     of a stack read in place, rejected geometries raising; greedy generate
     (B 2, 32 tokens) with GritLM(weight_quant=8), with =4, and w8 over the
     int8 KV cache, each teacher-forced (within TIE_TOL, INT8_KV_TIE_TOL over
     the int8 cache); the weight bytes and
     device/host ms per decode step against bf16; 8 generation and 4
     embedding requests through a dense w4 ServingEngine (K7 in the decode
     chunks); K6 and K7 timed at M 8 over the five projection shapes (the
     gate/up shape, 4096 -> 14336, is the kernel table's), and at gate/up
     also at M 1 and 16 (both), 64 and 128 (both) and 256 and 512 (K6:
     its staged template's rows), beside their bounds
     and torch.matmul of the dequantized weight, by CUDA graph replays over
     weight copies that keep each call's weight out of L2

 12. speculative decoding and serving sampling at full width (after phase
     7): K3 with per-row offsets at the dense verify chunk's shape (B 8, Sq
     8, Smax 4096, offsets SERVING_LENS - 8), bf16 and int8, against its
     plain version and bit-equal to K8 on the same logical cache, timed
     cold by CUDA graph replays beside SDPA with the same per-row causal
     mask (the kernels line's "K3 verify" row, `flash_decode_verify`); then,
     counts set to 0 before each run and read after: lockstep speculative
     generate at B = 1 and 2 on prompts that quote a passage (32 tokens,
     teacher-forced within TIE_TOL; verify steps, tokens a verify, ms per
     token host and device beside plain greedy); phase 7's first 8
     requests (its 8-request cut, for the time budget since phase 16) and
     4 doc-continuation requests (hist_ids = the document) through dense
     and paged speculative pools (spec_k 7): completions, TIE_TOL, K3 with
     per-row offsets (dense) or K8 (paged) in the verify chunks, tokens a
     row's verify, device ms per verify step at B = 8, tokens/s beside
     phase 7's, and a replay of the 8 on the dense pool with each one's
     greedy continuation in its lookup corpus (the most a verify accepts);
     the 8 requests mixed greedy / T 0.7 top_p 0.9 / T 1.0
     top_k 50 through dense and paged sampling pools (both on prompt
     buckets 256-2048, so they prefill alike): completions, greedy
     rows within TIE_TOL, the sampled streams equal between the pools, and
     the share of tokens 4 sampled requests run alone share with the pool's
     (printed, not gated)
 13. Mixtral MoE serving at Mixtral-8x7B width (after phase 11, with the
     Mistral model freed; counts set to 0 before each run, summed after):
     `mixtral_8x7b()` at depth MOE_DEPTH (4; 32 layers would need 93.4 GB
     of bf16 weights), random bf16 weights; encode of the 16
     sentences with moe_impl "dense" and "dropless" (sentences/s), held
     against each other and against the plain K1 + K2 path at cosine >=
     COSINE_MIN with the routes of one run pinned in the other (`Routes`;
     the cosine with each run's own routes and the routes that differ are
     printed: with random bf16 weights a router's top two are often within
     rounding of the third, and a flipped route moves a token far); greedy
     generate at B 2, 32 tokens, teacher-forced within TIE_TOL with the
     generate's routes pinned (with its own routes: printed, and a token
     above TIE_TOL fails unless a route flipped at or before it); phase 7's
     serving workload cut to 8 generation and 4 embedding requests on a
     dense and a paged pool (page 256), its checks pinned to the routes
     the engine took (`RouteBook`), the streams that differ between the
     pools with the first differing token's deficit, one decode chunk per
     moe_impl (dense, auto, dropless) under set_sync_debug_mode("error"),
     the decode step (also with moe_impl "dropless") and the chunk's
     device ms and idle share; RAGEngine in DOC mode over the 16
     sentences' doc caches (self-retrieval of 4 queries); then
     GritLM(weight_quant=8) at depth MOE_W8_DEPTH (4, quantized from a bf16
     model of that depth) through greedy generate (16 tokens, TIE_TOL) and
     its decode step. K1, K2, K3, K8 and K6 must each launch.
 14. per-request LoRA adapters and the remat policies at Mistral-7B width
     (after phase 12; counts set to 0 before each run and read after):
     four adapters (r 16, alpha 64 on q/k/v/o/gate/up/down, B nonzero:
     draw_adapters) stacked onto the base; phase 7's 8-request cut on
     adapters round-robin over None, a, b, c, d and its 8 embedding
     requests (every second on an adapter) through dense, paged (page 256),
     speculative (spec_k 7) and chunked-prefill (256) pools: completions,
     every token teacher-forced
     within ADAPTER_TIE_TOL through the pool's own math and (dense pool,
     printed) over its adapter merged into the base, each targeted
     projection of the adapter branch within ADAPTER_RTOL of the merged
     weight's, pool embeddings at cosine >= COSINE_MIN to GritLM.encode,
     each adapter moving some request off the base, K1, K2 and K3 or K8
     launched; the int8 base with the four adapters (8 requests, K6 in the
     decode chunks); the decode step at B = 8
     with every row on its own adapter (eight adapters) against no
     adapters (device and host ms, idle share), and one adapter decode
     chunk, dense and paged, under set_sync_debug_mode("error"); then
     phase 10's LoRA step at depth REMAT_DEPTH (2) under the remat
     policies None, "dots" and "dots_no_batch" (3 steps each: ms a step,
     peak GiB, losses and adapters against the full recompute's, K1
     relaunched by the recompute) and `training.run --remat_policy dots`
     (LoRA, depth 4, 2 steps)
 15. MoE GRIT training at Mixtral-8x7B width (after phase 13; counts set
     to 0 before, read after): LoRA (r 16, alpha 64: wq/wk/wv/wo) at depth
     MOE_DEPTH (4) on phase 10's batch (25,600 tokens a step),
     moe_impl "auto" (dropless), 3 steps: ms a step, tokens/s, peak GiB
     (a fourth step profiled: device time by kernel, idle share), and
     loss_gen equal to the step's next-token loss plus coef x
     load_balancing_loss recomputed in fp32 from the step's own router
     logits (MOE_AUX_RTOL); at depth 2 with full parameters: the router's
     gradient with the default aux coefficient minus with 0 against coef x
     the aux loss's gradient (ROUTER_GRAD_RTOL), the expert stacks'
     gradients nonzero under dense, dropless and gshard; gshard LoRA steps
     on a 4 x 512 generative batch dropping routes at capacity 0.25 and
     none at 4.0, one step traced through utils.profiling.trace (device
     events required); one full-width layer's output and gradients under
     the three impls (MOE_LAYER_RTOL); `training.run --model_name_or_path
     <depth-2 checkpoint> --lora --moe_impl dropless --native_loader`, 2
     steps; the native loader's host ms a batch beside the Python
     pipeline's
 16. head dims 64 and 96, and Llama-3.2-1B (after phase 11, with the
     Mistral model freed): K1 (phase 2's three shapes with their LSE), K3
     (Sq 1 and 64, int8, the serving call, the verify chunk with [B]
     offsets bit-equal to K8) and K8 (bf16 and int8 pages of 256, Sq 1
     and 8) against their plain versions at (Dh, H, Hkv) = (64, 32, 8),
     (64, 14, 2) and (96, 16, 8); then LLAMA_32_1B (the published
     config.json through ModelConfig.from_hf_config: D 2048, 16 layers,
     32/8 heads, Dh 64, V 128256, tied embeddings, llama3 RoPE scaling),
     random bf16 weights, counts set to 0 before each run and summed
     after: encode of the 16 sentences at cosine >= COSINE_MIN to the
     plain versions, sentences/s; greedy generate at B = 2 (32 tokens,
     TIE_TOL), the decode step's device / host ms and idle share; phase
     7's 24 + 8 requests on dense, paged and paged-int8 pools (TIE_TOL,
     INT8_KV_TIE_TOL over int8 KV; pool embeddings at cosine >= 0.9999),
     tokens/s and TTFT p50; RAG in the seven cache modes (rag_phase); K1,
     K2, K3, K8 and K9 must each launch; the kernels line's [dh64] rows
     timed at the Llama heads: K1 at B4 S512 and causal B8 S2048 with its
     LSE, K3 at Sq 1 B4, Sq 64, int8, the B8 serving call and the verify
     chunk, K8 at B8 page 256 (bf16, int8, Sq 1 and 8), each beside SDPA
 17. head dims 64 and 96 in training, and Llama-3.2-1B GRIT training (after
     phase 10, whose models are freed, and last): K4 and K5 (and K1's LSE)
     against the plain backward at (Dh, H, Hkv) = (64, 32, 8), (64, 14, 2)
     and (96, 16, 8), phase 10's four cases (Dh 96 through the zero pad to
     128), and FlashAttentionFn against autograd through the plain forward;
     then LLAMA_32_1B with random bf16 weights (seed 42) written as a
     checkpoint, counts set to 0 before and read after: LoRA through
     training.run.main --model_name_or_path on phase 10's synthetic JSONL
     at the reference's lengths (query 256, passage 2048, generative 2048;
     batch 4, group 2; 3 steps, a checkpoint at step 2, a resumed run, the
     export read back equal and holding the JAX exporter's tensor names, no
     lm_head), 4 LoRA steps on one batch (the loss falls), 2 of them with
     the fused LM-head loss (--fused_ce; peak GiB), 3 QLoRA steps, 3
     full-parameter steps at full depth (16 layers), each with ms a step,
     valid tokens/s and peak GiB; K1, K4 and K5 must each launch (all at Dh
     64); then K4 and K5 at Dh 64 timed as in phase 10 (the kernels line's
     [dh64] backward rows), K1 at Dh 96 (B4 S512, H 16, Hkv 8, through the
     pad) and the Dh-96 backward through the pad, each beside SDPA; the
     full-parameter state is saved as a training checkpoint for phase 18
 18. the evaluation path. Its eval leg runs after phase 11, once the
     Mistral-7B inference model is freed (eval_phase): at Mistral-7B width
     with random bf16 weights (seed 0), `python -m gritlm_tpu_torch.eval.mteb`'s
     main on a planted BEIR task (1,024 docs, 128 queries, 64 of them each
     its relevant doc's own text) with the reranker at top 10, through K1,
     K2 and K9 [f32] alone (the retrieval eval's fp32 index), planted
     dense recall@1 = 1, the search ids against a plain fp32 top-k, the
     reranked head above its tail, then eval.aggregate; the generative
     benchmarks (multiple choice batched against sequential,
     score_continuations against a plain log-softmax, GSM8K and QA
     generation through K1 and K3), hard-negative mining through K9's bf16
     kernel and data_prep.validate_file; rates of each. Its tools leg runs
     after phase 17, on phase 17's Llama-3.2-1B export and full-parameter
     checkpoint (tools_phase): verify-checkpoint --fp32 on the card at its
     default --parity_tol (2e-3) through K1 [f32], K2 [f32] and K9 [f32],
     shard, strip-prefix and export-hf, each read back and checked
 19. GritLM at fp32 activations (after phase 18's eval leg, the bf16
     Mistral model freed; f32_phase): the same fp32 model at full width and
     depth 2 on the card against the CPU (plain versions; embeddings and
     logits within F32_EXACT_RTOL), then `mistral_7b()` at fp32 from seed 0
     (27 GiB) through encode (sentences/s, the cosine to phase 3's bf16
     embeddings printed), greedy generate at B 2 (TIE_TOL), the decode
     step, and phase 7's 8-request cut through dense, paged, int8-KV and
     speculative pools; only fp32 forms of K1, K2, K3 and K8 may launch
 20. GRIT training at fp32 (after phase 18's tools leg, last; TF32 off;
     f32_train_phase): K4 [f32] and K5 [f32] against the plain backward at
     B 8 S 2048 bidirectional and B 4 S 2048 causal (32/8 heads, Dh 128),
     a window with right padding, a fully masked row, Dh 64 and 96
     (BWD_F32_RTOL, reruns bit-equal), and timed beside SDPA's fp32
     backward (its backend printed) at the same two shapes and at Dh 64;
     fp32 activations through K6 and K7 at decode rows (Llama-3.2-1B width
     and depth, w8 and w4, greedy generate held to the same model with x
     cast to bf16 before the product); then, counts set to 0 before each
     run and read after, `training.run --dtype float32` 3 steps on one
     synthetic batch repeated (25,600 tokens a step): Llama-3.2-1B with
     LoRA, QLoRA and full parameters, Mistral-7B width at depth 4 with LoRA
     in GradCache chunks of 2 (held to an unchunked step); every loss finite
     and falling, only the fp32 forms of K1, K4 and K5 launched; ms a step
     and peak GiB

Output: a `kernels` JSON line, the card line, then as the last line
{"ok": true, "device": {...}}. Exits 2 with no result when there is no CUDA
device or the port's package is not beside this script.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_ATOL = 2e-2  # bf16 outputs; kernels round P to bf16 before P.V
# K4/K5: of the largest gradient of the case (bf16 inputs and outputs; P and
# dS are rounded to bf16 before their products, where the plain version
# keeps fp32); the first chip run saw 0.3-0.6%
BWD_RTOL = 2e-2
LSE_ATOL = 1e-3  # fp32 log-sum-exp of the same bf16 scores, summed in another order
GC_LOSS_RTOL = 1e-2  # GradCache: the same bf16 forwards in chunks of half the batch
POOL_ATOL = 1e-4  # fp32 sums of the same bf16 inputs in another order
K9_ATOL = 1e-3  # fp32 sums of the same bf16 products in another order, unit vectors
# K9 [f32]: exact fp32 products summed in another order (the kernel's FMA
# chain against cuBLAS' fp32 product, TF32 off) on unit vectors of width 4096
K9_F32_ATOL = 1e-5
K9_F32 = "scores_segmax[f32]"  # the kernels line's row of K9's fp32 kernel
# The fp32 forms of K1, K2, K3 and K8: fp32 products summed in fp32 in
# another order than the plain version's fp32 einsums (TF32 off), exp2 the
# hardware's approximation (2^-22 relative); at unit-scale inputs a score
# moves by about sqrt(Dh) x 2^-24 and an output, pooled row or LSE by less
# than 1e-6 (the first chip run: at most 1.9e-06), so 1e-5 holds with room.
F32_ATOL = 1e-5
F32 = "[f32]"  # the suffix of a kernel's fp32 form in the counts and the kernels line
F32_INFERENCE = ("flash_attention", "fused_norm_mean_pool", "flash_decode", "paged_decode")
F32_TRAINING = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
F32_KERNELS = F32_INFERENCE + F32_TRAINING[1:]
# K4 [f32] and K5 [f32] against the plain backward on the same fp32 inputs
# (TF32 off): both sum fp32 products in fp32 in other orders (a gradient
# entry sums up to group x Sq = 8192 terms of P or dS times an input of
# order 1), and the kernels' exp2 is the hardware's approximation (2^-22
# relative): about sqrt(n) x 2^-24 = 5e-6 of the entries' scale at worst,
# well under 1e-6 of the largest gradient in practice; 1e-5 of the largest
# gradient holds with room (tests/test_torch_gpu.BWD_F32_RTOL)
BWD_F32_RTOL = 1e-5
# GradCache at fp32: loss_emb of the first step in two chunks against the
# unchunked step from the same adapters (the same fp32 sums in other orders)
GC_F32_RTOL = 1e-4
COSINE_MIN = 0.999
# Teacher forcing of the serving runs: an engine token may sit this far below
# its position's largest bf16 logit in one lockstep forward over the same
# tokens. The two routes sum attention in another order (K1 over the whole
# sequence against K3/K8 a token at a time, bf16 probabilities against fp32),
# and with random weights the top two logits are often closer than that
# drift (PR 3 saw greedy tokens flip between layouts); a wrong token sits
# several logit units below the max (logits have a spread of about 1.3).
TIE_TOL = 0.25
# The same over an int8 KV cache: each K/V value rounds to 1/127 of its head's
# absmax, and a K/V that another matmul path computed (the check's forward
# against the generate's decode kernels) can land one int8 step away, which
# moves logits more than bf16 rounding does (two runs of the same int8-KV
# generate with K6 split two ways: 0.19 and 0.28).
INT8_KV_TIE_TOL = 0.5

SENTENCES = [
    "Bitcoin is a decentralized digital currency without a central bank.",
    "The mitochondria is the powerhouse of the cell.",
    "A transformer layer applies attention followed by a feed-forward network.",
    "Paris is the capital and most populous city of France, on the Seine.",
    "Rotary position embeddings rotate query and key vectors by position-dependent "
    "angles, so that their dot product depends on the relative distance.",
    "GritLM unifies text embedding and generation in one model.",
    "The quick brown fox jumps over the lazy dog.",
    "Key-value caches let a decoder reuse attention keys and values across steps, "
    "which turns each generated token into a read of the cache instead of a "
    "recomputation of the whole prefix.",
    "Photosynthesis converts light energy into chemical energy.",
    "The Great Wall of China stretches thousands of kilometres.",
    "Mean pooling averages the hidden states of the tokens of a sentence.",
    "Water boils at one hundred degrees Celsius at sea level.",
    "Instruction tuning teaches a model to follow natural-language task descriptions.",
    "Shakespeare wrote Hamlet around the year 1600.",
    "A sliding window limits how far back each token may attend.",
    "Embeddings map text to vectors whose cosine similarity reflects meaning.",
]
INSTRUCTION = "<|user|>\nRetrieve semantically similar text\n<|embed|>\n"


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of stderr still
    # sees which check failed
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, reps: int = 25, warmup: int = 3):
    """(device_ms, call_ms) of one call of fn: device_ms is the summed device
    time of the call's kernels (torch.profiler over `reps` calls), call_ms
    the median time between CUDA events around single calls, which also
    holds any time the device waits for the host to launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    call_ms = statistics.median(times)
    # A trace now and then comes back without device events (seen on the
    # H100 about once in three runs of this script): trace again, and if the
    # second is empty too, the events' time stands in for the device time.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
        if device_us > 0:
            return device_us / 1e3 / reps, call_ms
        print("  torch.profiler recorded no device time", flush=True)
    print("  device ms taken from CUDA events", flush=True)
    return call_ms, call_ms


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, what bounds it): the larger of the operations over `peak` (bf16
    by default) and the bytes over PEAK_BYTES."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


_f32_peak = []


def f32_peak() -> float:
    """This card's fp32 FMA rate in FLOP/s: its SM count (device properties)
    x 128 fp32 lanes x 2 x its maximum SM clock (nvidia-smi clocks.max.sm),
    the bound of the fp32 forms' and K9 [f32]'s operations."""
    import torch

    if not _f32_peak:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
        _f32_peak.append(sms * 128 * 2 * clock_mhz * 1e6)
        print(f"fp32 FMA peak {_f32_peak[0] / 1e12:.1f} TFLOP/s from {sms} SMs at "
              f"{clock_mhz:.0f} MHz", flush=True)
    return _f32_peak[0]


def peak_of(name: str) -> float:
    """The operations peak of a kernels line row: fp32 FMA for the fp32
    forms, bf16 tensor cores for the rest."""
    return f32_peak() if name.endswith(F32) else PEAK_BF16_FLOPS


def dt_label(t) -> str:
    """'bf16' or 'fp32', by a tensor's dtype (the labels of the checks)."""
    return "fp32" if t.element_size() == 4 else "bf16"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sdpa_backend(q, k, v, mask) -> str:
    """The backend scaled_dot_product_attention picks for these inputs
    (torch._fused_sdp_choice), by name."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not known ({type(e).__name__}: {e})"


def peak_note(rate: float, peak: float) -> str:
    """'' for a rate the card can reach, else the mark of an invalid reading
    (a profiler that dropped kernels reads above the peak)."""
    return "" if rate <= peak else " INVALID: above the card's peak"


# The redesigned kernels, their sources and (where a source holds more than
# one) the entry functions' names: ptxas must give them no spills and (the
# wgmma kernels) no serialised wgmma (phase 1).
PTXAS_KERNELS = (("K1", "flash_attention", "gritlm_flash_fwd_smem", "flash_fwd_kernel"),
                 ("K1 [f32]", "flash_attention", "gritlm_flash_fwd_f32_smem",
                  "flash_fwd_f32_kernel"),
                 ("K4", "flash_attention_bwd", None, "flash_bwd_dq_kernel"),
                 ("K5", "flash_attention_bwd", None, "flash_bwd_dkv_kernel"),
                 ("K4 [f32]", "flash_attention_bwd", "gritlm_flash_bwd_dq_f32_smem",
                  "flash_bwd_dq_f32_kernel"),
                 ("K5 [f32]", "flash_attention_bwd", "gritlm_flash_bwd_dkv_f32_smem",
                  "flash_bwd_dkv_f32_kernel"),
                 ("K9", "scores_segmax", "gritlm_scores_segmax_smem", "scores_segmax_kernel"),
                 ("K9 [f32]", "scores_segmax", "gritlm_scores_segmax_f32_smem",
                  "scores_segmax_f32_kernel"),
                 ("K3", "decode_attention", None, "flash_decode_kernel"),
                 ("K3 [f32]", "decode_attention", None, "flash_decode_f32_kernel"),
                 ("K8", "paged_attention", None, "flash_decode_kernel"),
                 ("K8 [f32]", "paged_attention", None, "flash_decode_f32_kernel"),
                 ("K7, K6", "quant_matmul", None, None),
                 ("K2", "fused_pool", None, "pool_kernel"),
                 ("K2 [f32]", "fused_pool", None, "pool_f32_kernel"))


def entry_report(log: str, entry) -> str:
    """The lines of a ptxas report that belong to the entry functions whose
    names hold `entry` (the whole report for None)."""
    import re

    if entry is None:
        return log
    out, keep = [], False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            keep = entry in m.group(1)
        if keep:
            out.append(line)
    return "\n".join(out)


def ptxas_report(_build, logs) -> None:
    """Registers, spill bytes and dynamic shared memory of the redesigned
    kernels from the ptxas reports of the libraries in use; fails on a spill
    or a serialised wgmma."""
    import re

    for label, source, smem_fn, entry in PTXAS_KERNELS:
        log = entry_report(logs[source], entry)
        if not log:
            fail(f"{label}: no ptxas report of {entry} in {source}.cu")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
        smem = ""
        if smem_fn is not None:
            smem = f", {getattr(_build.load(source), smem_fn)()} bytes of dynamic shared memory"
        print(f"  {label} ({source}.cu): ptxas registers {'/'.join(regs)} at launch, "
              f"{max(spills, default=0)} spill bytes{smem}", flush=True)
        if any(spills) or "serialized" in logs[source]:
            fail(f"{label}: ptxas spilled registers or serialised a wgmma ({source}.cu)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "gritlm_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: gritlm_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import mistral_7b
    from gritlm_tpu_torch.gritlm import _bucket
    from gritlm_tpu_torch.models.transformer import count_params
    from gritlm_tpu_torch.ops import (
        _build,
        decode_attention,
        flash_attention,
        fused_pool,
        paged_attention,
        quant_matmul,
        scores_segmax,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # ---------------------------------------------------------------- 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} card {card}", flush=True)
    t0 = time.time()
    logs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s ({', '.join(_build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "error",
                                       "warning")):
                print(f"  ptxas[{name}] {line.strip()}")
    ptxas_report(_build, logs)

    # name (of the wrapper in its module): (module, plain version, source, TPU kernel)
    kernels = {
        "flash_attention": (flash_attention, flash_attention.flash_attention_plain,
                            "gritlm_tpu_torch/csrc/flash_attention.cu",
                            "gritlm_tpu/ops/flash_attention.py:46"),
        "flash_decode": (decode_attention, decode_attention.flash_decode_plain,
                         "gritlm_tpu_torch/csrc/decode_attention.cu",
                         "gritlm_tpu/ops/decode_attention.py:63"),
        "fused_norm_mean_pool": (fused_pool, fused_pool.fused_norm_mean_pool_plain,
                                 "gritlm_tpu_torch/csrc/fused_pool.cu",
                                 "gritlm_tpu/ops/fused_pool.py:42"),
        "scores_segmax": (scores_segmax, scores_segmax.scores_segmax_plain,
                          "gritlm_tpu_torch/csrc/scores_segmax.cu",
                          "gritlm_tpu/index/flat.py:143"),
        "paged_decode": (paged_attention, paged_attention.paged_decode_plain,
                         "gritlm_tpu_torch/csrc/paged_attention.cu",
                         "gritlm_tpu/ops/paged_attention.py:56"),
        "flash_attention_bwd_dq": (flash_attention, flash_attention.flash_attention_bwd_dq_plain,
                                   "gritlm_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "gritlm_tpu/ops/flash_attention.py:376"),
        "flash_attention_bwd_dkv": (flash_attention,
                                    flash_attention.flash_attention_bwd_dkv_plain,
                                    "gritlm_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "gritlm_tpu/ops/flash_attention.py:416"),
        "w8a16_matmul": (quant_matmul, quant_matmul.w8a16_matmul_plain,
                         "gritlm_tpu_torch/csrc/quant_matmul.cu",
                         "gritlm_tpu/ops/quant_matmul.py:204"),
        "w4a16_matmul": (quant_matmul, quant_matmul.w4a16_matmul_plain,
                         "gritlm_tpu_torch/csrc/quant_matmul.cu",
                         "gritlm_tpu/ops/quant_matmul.py:116"),
    }
    wrappers = {name: getattr(mod, name) for name, (mod, *_) in kernels.items()}
    path_launches = {}  # path -> launches per kernel in that path's run

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for n in F32_KERNELS:
            wrappers[n].f32_launches = 0
        decode_attention.flash_decode.row_offset_launches = 0
        scores_segmax.scores_segmax.f32_launches = 0

    def read_counts():
        # K3's launches with per-row offsets (the dense verify chunk) are
        # among flash_decode's and are also counted as the "K3 verify" row's;
        # K9's fp32 kernel counts apart from its bf16 one
        counts = {n: w.launches for n, w in wrappers.items()}
        counts[K3_VERIFY] = decode_attention.flash_decode.row_offset_launches
        counts[K9_F32] = scores_segmax.scores_segmax.f32_launches
        for n in F32_KERNELS:  # the fp32 forms of K1, K2, K3, K8, K4 and K5 count apart
            counts[n + F32] = wrappers[n].f32_launches
        return counts

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    cases = []  # (kernel, label, fn_kernel, fn_plain, fn_library, flops, bytes, atol)
    lse_cases = []  # K1's LSE output: (name, label, fn_kernel, fn_plain)
    k1_cases(dev, randn, cases, lse_cases)
    k3_cases(dev, randn, cases)
    k8_cases(dev, randn, cases)

    hidden, gamma, pmask = pool_case(dev, randn, 8, 512, 4096)
    for method in ("mean", "weightedmean"):
        kw = dict(eps=1e-5, method=method)
        cases.append(("fused_norm_mean_pool", f"{method} B8 S512 D4096",
                      lambda kw=kw: fused_pool.fused_norm_mean_pool(hidden, gamma, pmask, **kw),
                      lambda kw=kw: fused_pool.fused_norm_mean_pool_plain(
                          hidden, gamma, pmask, **kw),
                      None, 0.0, 0.0, POOL_ATOL))  # timed cold by k2_times

    # the fp32 forms of K1, K2, K3 and K8 (phase 2's shapes on fp32 inputs)
    gen32 = torch.Generator(device=dev).manual_seed(32)

    def randf(*shape):
        return torch.randn(shape, generator=gen32, device=dev)

    f32_cases(dev, randf, cases, lse_cases)

    max_err = {name: 0.0 for name in wrappers}
    check_cases(cases, lse_cases, max_err)
    f32_checks(dev, randf, max_err)

    def unit_rows(n, d=4096, dtype=torch.bfloat16):
        x = torch.randn((n, d), generator=gen, device=dev)
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    def check_scores_segmax(label, q, emb, n_docs, key="scores_segmax", atol=K9_ATOL,
                            rerun=False):
        """K9 against its plain version: scores within `atol` where real,
        -inf where masked; each segment maximum exactly the largest of the
        kernel's own scores in its segment, and within `atol` of the plain
        maximum where the same column wins; with `rerun`, a second call
        bit-equal to the first. `key` is the kernels line's row (K9_F32 for
        fp32 inputs)."""
        got_s, got_m = scores_segmax.scores_segmax(q, emb, n_docs)
        if rerun:
            again_s, again_m = scores_segmax.scores_segmax(q, emb, n_docs)
            torch.cuda.synchronize()
            if not (torch.equal(got_s, again_s) and torch.equal(got_m, again_m)):
                fail(f"{key} [{label}]: a rerun is not bit-equal")
            del again_s, again_m
        torch.cuda.synchronize()
        want_s, want_m = scores_segmax.scores_segmax_plain(q, emb, n_docs)
        Q, N = got_s.shape
        ns = -(-N // 128)
        if tuple(got_m.shape) != (ns, Q) or tuple(want_m.shape) != (ns, Q):
            fail(f"scores_segmax [{label}]: segmax shape {tuple(got_m.shape)}")
        real = got_s[:, :n_docs]
        if not torch.isfinite(real).all() or not torch.isneginf(got_s[:, n_docs:]).all():
            fail(f"scores_segmax [{label}]: non-finite real scores or an unmasked tail")
        err = float((real - want_s[:, :n_docs]).abs().max())
        own = F.pad(got_s, (0, ns * 128 - N), value=float("-inf")).view(Q, ns, 128)
        if not torch.equal(got_m, own.amax(-1).T):
            fail(f"scores_segmax [{label}]: a segment maximum is not its segment's largest score")
        plain = F.pad(want_s, (0, ns * 128 - N), value=float("-inf")).view(Q, ns, 128)
        fin = torch.isfinite(want_m)
        if not torch.equal(fin, torch.isfinite(got_m)):
            fail(f"scores_segmax [{label}]: masked segments differ")
        same = (own.argmax(-1) == plain.argmax(-1)).T & fin
        m_err = float((got_m - want_m)[same].abs().max()) if same.any() else 0.0
        print(f"check {key} [{label}]: max_abs_err scores {err:.3e}, segment maxima "
              f"{m_err:.3e} where the same column wins ({float(same.sum() / fin.sum()):.4f} "
              f"of segments) (atol {atol}){'; rerun bit-equal' if rerun else ''}", flush=True)
        if err > atol or m_err > atol:
            fail(f"{key} [{label}] disagrees with its plain version: {err}, {m_err}")
        max_err[key] = max(max_err.get(key, 0.0), err, m_err)

    k2_checks(dev, randn, max_err)

    q9, emb9 = unit_rows(256), unit_rows(65536 + 300)
    check_scores_segmax("Q256 N65536 n_docs 65000", q9, emb9[:65536], 65000)
    check_scores_segmax("Q3 N65536", q9[:3], emb9[:65536], 65536)
    check_scores_segmax("Q256 N65836 partial last segment", q9, emb9, 65536 + 250)
    del q9, emb9
    # K9 [f32] (the retrieval eval's fp32 index) at the same three shapes
    q9, emb9 = unit_rows(256, dtype=torch.float32), unit_rows(65536 + 300, dtype=torch.float32)
    kw9 = dict(key=K9_F32, atol=K9_F32_ATOL, rerun=True)
    check_scores_segmax("Q256 N65536 n_docs 65000", q9, emb9[:65536], 65000, **kw9)
    check_scores_segmax("Q3 N65536", q9[:3], emb9[:65536], 65536, **kw9)
    check_scores_segmax("Q256 N65836 partial last segment", q9, emb9, 65536 + 250, **kw9)
    del q9, emb9

    # ---------------------------------------------------------------- 3
    t0 = time.time()
    model = GritLM(mistral_7b(), seed=0)  # random bf16 weights drawn on the card
    torch.cuda.synchronize()
    print(f"model: Mistral-7B width, {count_params(model.params) / 1e9:.3f} B params, "
          f"init {time.time() - t0:.1f} s", flush=True)

    def encode_all():
        a = model.encode(SENTENCES[:8])
        b = model.encode(SENTENCES[8:], instruction=INSTRUCTION)
        return torch.cat([torch.from_numpy(a), torch.from_numpy(b)])

    reset_counts()
    emb = encode_all()
    enc_launches = {n: w.launches for n, w in wrappers.items()}
    print(f"encode launches: {enc_launches}")
    if tuple(emb.shape) != (16, 4096) or not torch.isfinite(emb).all():
        fail(f"encode: shape {tuple(emb.shape)} or non-finite values")
    norms = emb.norm(dim=-1)
    if (norms - 1).abs().max() > 1e-3:
        fail(f"encode: norms {norms.tolist()}")
    if enc_launches["flash_attention"] == 0 or enc_launches["fused_norm_mean_pool"] == 0:
        fail("encode did not go through K1 and K2")

    # ---------------------------------------------------------------- 4
    tok = model.tokenizer
    long_prompts = ["<s><|user|>\n" + SENTENCES[4] + " " + SENTENCES[7] + "\n<|assistant|>\n",
                    "<s><|user|>\nExplain: " + SENTENCES[2] + "\n<|assistant|>\n"]
    short_prompts = ["<s><|user|>\nHi\n<|assistant|>\n", "<s><|user|>\nName a city.\n"]
    before = {n: w.launches for n, w in wrappers.items()}
    enc_long = tok(long_prompts)
    enc_short = tok(short_prompts)
    if enc_long["input_ids"].shape[1] <= 64 or enc_short["input_ids"].shape[1] > 64:
        fail("generate prompts do not fall in the intended buckets")
    res_long = model.generate_from_ids(enc_long["input_ids"], enc_long["attention_mask"],
                                       max_new_tokens=32)
    mid = {n: w.launches for n, w in wrappers.items()}
    res_short = model.generate_from_ids(enc_short["input_ids"], enc_short["attention_mask"],
                                        max_new_tokens=32)
    _, cache = model.encode(SENTENCES[:2], get_cache=True)
    q_enc = tok(["<|user|>\nSummarise the passage.\n<|assistant|>\n"] * 2,
                add_special_tokens=False)
    res_cache = model.generate_from_ids(q_enc["input_ids"], q_enc["attention_mask"],
                                        cache=cache, max_new_tokens=16)
    # the same weights with the int8 KV cache (K3's int8 variant)
    qmodel = GritLM(mistral_7b(), params=model.params, kv_quant=True)
    res_int8 = qmodel.generate_from_ids(enc_short["input_ids"], enc_short["attention_mask"],
                                        max_new_tokens=16)
    torch.cuda.synchronize()
    launches = read_counts()
    path_launches["encode+generate"] = launches
    gen_launches = {n: launches[n] - before[n] for n in wrappers}
    print(f"generate launches: {gen_launches} (long-prompt call: "
          f"{ {n: mid[n] - before[n] for n in wrappers} })")
    if not res_int8.cache.quantized:
        fail("kv_quant generate did not use the int8 cache")
    for res in (res_long, res_short, res_cache, res_int8):
        t = res.tokens
        if not ((t >= 0) & (t < model.config.vocab_size)).all():
            fail("generate: token ids out of range")
    if mid["flash_attention"] == before["flash_attention"]:
        fail("prefill at bucket >= 128 did not go through K1")
    if gen_launches["flash_decode"] == 0:
        fail("generate did not go through K3")
    print("sample:", repr(tok.decode(res_long.tokens[0].tolist())))

    # the same model through the plain versions on the card
    for name, (mod, plain, *_) in kernels.items():
        setattr(mod, name, plain)
    try:
        emb_plain = encode_all()
    finally:
        for name, (mod, *_) in kernels.items():
            setattr(mod, name, wrappers[name])
    cos = F.cosine_similarity(emb, emb_plain, dim=-1)
    print(f"encode kernels vs plain versions: min cosine {float(cos.min()):.6f}")
    if cos.min() < COSINE_MIN:
        fail(f"encode through the kernels departs from the plain versions: {cos.tolist()}")
    projection_phase(model, reset_counts, read_counts, path_launches)

    times = {}  # per kernel: (ms, plain_ms, library_ms, bound_ms, bound_by) at its path shape

    # ---------------------------------------------------------------- 5
    search_phase(dev, check_scores_segmax, unit_rows, reset_counts, read_counts, path_launches,
                 times)

    # ---------------------------------------------------------------- 6
    rag_eng = rag_phase(model, reset_counts, read_counts, path_launches)

    # ---------------------------------------------------------------- 7
    dense_step, greedy_rates, greedy_ttfts = serving_phase(model, rag_eng, reset_counts,
                                                           read_counts, path_launches)
    del rag_eng

    # ---------------------------------------------------------------- 12
    max_err[K3_VERIFY] = 0.0
    spec_phase(model, randn, reset_counts, read_counts, path_launches, times, max_err,
               greedy_rates)

    # ---------------------------------------------------------------- 14
    t14 = time.time()
    adapter_phase(model, reset_counts, read_counts, path_launches, greedy_rates, greedy_ttfts)
    remat_phase(dev, reset_counts, read_counts, path_launches)
    print(f"phase 14: {time.time() - t14:.0f} s; total {time.time() - t_start:.0f} s",
          flush=True)

    # ---------------------------------------------------------------- 8
    latency_phase(model)

    # ---------------------------------------------------------------- 9
    k3_times(dev, randn, times)
    k8_times(dev, randn, times)
    k2_times(dev, randn, times)
    k9_f32_times(dev, times)
    f32_times(dev, randf, times)
    for name, label, fk, fp, fl, flops, byt, _ in cases:
        if name.removesuffix(F32) in ("flash_decode", "paged_decode", "fused_norm_mean_pool"):
            continue  # timed cold by k3_times, k8_times, k2_times
        if name.endswith(F32) and name in times:
            continue  # an fp32 form is timed at its first case, its row
        ms, call_ms = time_ms(fk)
        plain_ms, plain_call = time_ms(fp, reps=10)
        library_ms = library_call = None  # no single PyTorch call computes the int8 variant
        if fl is not None:
            try:
                library_ms, library_call = time_ms(fl)
            except (TypeError, RuntimeError) as e:  # yardstick only; never used by the port
                print(f"  library call for {name} [{label}] failed: {e}")
        peak = peak_of(name)
        bms, by = bound(flops, byt, peak)
        print(f"time {name} [{label}]: device {ms:.4f} ms ({bms / ms * 100:.1f}% of bound "
              f"{bms:.4f} ms, {by}), plain {plain_ms:.4f}, library "
              f"{library_ms if library_ms is None else round(library_ms, 4)}; per call "
              f"(events): kernel {call_ms:.4f}, plain {plain_call:.4f}, library "
              f"{library_call if library_call is None else round(library_call, 4)}",
              flush=True)
        if name.removesuffix(F32) == "flash_attention":
            # K1 and SDPA by CUDA events around replays of a captured call (the
            # table's figures: at these shapes the wrapper's host time exceeds the
            # kernel's, so calls launched back to back time the host), beside
            # events around back-to-back calls and the profiler's reading above
            ms, library_ms = graph_ms(fk, calls=10), graph_ms(fl, calls=10)
            rate, lib_rate = flops / (ms * 1e-3) / 1e12, flops / (library_ms * 1e-3) / 1e12
            print(f"time {name} [{label}] by events: {ms:.4f} ms = {rate:.1f} TFLOP/s"
                  f"{peak_note(rate, peak / 1e12)} ({bms / ms * 100:.1f}% of bound); "
                  f"library (scaled_dot_product_attention) {library_ms:.4f} ms = "
                  f"{lib_rate:.1f} TFLOP/s{peak_note(lib_rate, peak / 1e12)} (CUDA "
                  f"graph replays); back to back: kernel {event_ms(fk):.4f}, library "
                  f"{event_ms(fl):.4f}", flush=True)
            if name.endswith(F32):  # which SDPA backend took the fp32 call
                print(f"  SDPA backend at fp32: {sdpa_backend(*fl.args)}", flush=True)
            if peak_note(lib_rate, peak / 1e12):
                library_ms = None  # an impossible reading stays out of the table
        times.setdefault(name, (ms, plain_ms, library_ms, bms, by))

    t0 = time.time()
    encode_all()
    torch.cuda.synchronize()
    dt = time.time() - t0
    n_tok = sum(len(tok._encode_one(s, True)) for s in SENTENCES[:8]) + sum(
        len(tok._encode_one(INSTRUCTION + s, True)) for s in SENTENCES[8:])
    print(f"encode: 16 sentences in {dt * 1e3:.1f} ms = {16 / dt:.1f} sentences/s, "
          f"{n_tok / dt:.0f} tokens/s (valid tokens)")

    def timed_generate(n):
        torch.cuda.synchronize()
        t = time.time()
        model.generate_from_ids(enc_long["input_ids"], enc_long["attention_mask"],
                                max_new_tokens=n)
        torch.cuda.synchronize()
        return time.time() - t

    t1, t33 = timed_generate(1), timed_generate(33)
    print(f"generate B=2 prompt of {enc_long['input_ids'].shape[1]} tokens (bucket "
          f"{_bucket(enc_long['input_ids'].shape[1], model.seq_buckets)}): prefill+1 "
          f"{t1 * 1e3:.1f} ms, decode {(t33 - t1) / 32 * 1e3:.2f} ms/token "
          f"(host clock, 32 steps)")
    profile_window("encode 16 sentences", encode_all)
    profile_window("generate B=2, 8 tokens", lambda: model.generate_from_ids(
        enc_long["input_ids"], enc_long["attention_mask"], max_new_tokens=8))
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 11
    quant_phase(model, enc_long, dense_step, reset_counts, read_counts, path_launches, times,
                max_err)
    print(f"total {time.time() - t_start:.0f} s")

    del model, qmodel, cache
    gc.collect()  # engines held in reference cycles (their on_token closures) keep their pools
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 18 (eval)
    eval_phase(dev, reset_counts, read_counts, path_launches)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 19
    f32_phase(dev, emb, enc_long, reset_counts, read_counts, path_launches)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 16
    llama_phase(dev, randn, reset_counts, read_counts, path_launches, times, max_err, t_start)

    # ---------------------------------------------------------------- 13
    moe_phase(enc_long, reset_counts, read_counts, path_launches)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 15
    moe_train_phase(dev, reset_counts, read_counts, path_launches)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 10
    flash_bwd_checks(dev, randn, max_err)
    training_phase(dev, reset_counts, read_counts, path_launches)
    training_times(dev, randn, times)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 17, 18 (tools)
    llama_work = ROOT / "build" / "chip_smoke_llama_train"
    try:
        llama_train_phase(dev, randn, reset_counts, read_counts, path_launches, times, max_err,
                          llama_work)
        tools_phase(dev, llama_work, reset_counts, read_counts, path_launches)
    finally:
        import shutil

        shutil.rmtree(llama_work, ignore_errors=True)
    print(f"total {time.time() - t_start:.0f} s")

    # ---------------------------------------------------------------- 20
    f32_train_phase(dev, randf, reset_counts, read_counts, path_launches, times, max_err)
    print(f"total {time.time() - t_start:.0f} s")

    print(f"launches by path: {json.dumps(path_launches)}")
    # the "K3 verify" row: K3's launches with per-row offsets, its times at
    # the dense verify chunk's shape (spec_phase)
    kernels[K3_VERIFY] = kernels["flash_decode"]
    # the "K9 [f32]" row: K9's fp32 kernel (the retrieval eval's index) in
    # the same source, replacing the same Pallas kernel on an fp32 corpus
    kernels[K9_F32] = kernels["scores_segmax"]
    # the fp32 forms of K1, K2, K3, K8, K4 and K5: kernels of their own in
    # the same sources, replacing the same Pallas kernels on fp32 inputs
    for n in F32_KERNELS:
        kernels[n + F32] = kernels[n]
    launches = {n: sum(c.get(n, 0) for c in path_launches.values()) for n in kernels}
    # the Dh-64 instances' rows: K1, K3 and K8 on phase 16's Llama-3.2-1B
    # paths, K1, K4 and K5 on phase 17's
    for row, base in DH64_ROWS.items():
        kernels[row] = kernels[base]
        launches[row] = sum(path_launches[key].get(base, 0) for key in LLAMA_PATHS)
    rows_out = [{
        "name": name, "route": "cuda", "source": kernels[name][2],
        "replaces": kernels[name][3], "launches": launches[name],
        "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": times[name][3], "bound_by": times[name][4],
        "library_ms": times[name][2],
    } for name in kernels]
    if any(r["launches"] == 0 for r in rows_out):
        fail("a kernel of the path was never launched")
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k1_cases(dev, randn, cases, lse_cases, H=32, Hkv=8, Dh=128, name="flash_attention",
             atol=ATTN_ATOL) -> None:
    """K1's phase-2 shapes at (H, Hkv, Dh), appended to `cases` (and its LSE
    to `lse_cases`) under `name`, held to `atol`: bidirectional B 4 S 512
    with a padded tail, causal with a 256 window, and a 256-token prefill at
    offset 512 over a layer view of a 1024-slot cache. `randn` gives the
    dtype (bf16, or fp32 for K1's fp32 form)."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.ops import flash_attention
    from gritlm_tpu_torch.ops.flash_attention import keep_mask

    B, S = 4, 512

    def attn_case(label, q, k, v, mask, causal, window, offset):
        label = label if Dh == 128 else f"{label} Dh{Dh}"
        keep = keep_mask(mask, q.shape[1], k.shape[1], causal=causal,
                         sliding_window=window if causal else None, offset=offset,
                         device=dev)
        keep_b = keep.expand(q.shape[0], -1, -1)
        flops = 4.0 * int(keep_b.sum()) * H * Dh
        slots = int(keep_b.any(1).sum())  # keys some query sees: K/V bytes to read
        byt = slots * Hkv * Dh * 2 * q.element_size() + nbytes(q, q, mask)
        kw = dict(causal=causal, sliding_window=window, offset=offset)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        am = keep[:, None]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)

        library.args = (qt, kt, vt, am)  # for sdpa_backend
        cases.append((name, label,
                      lambda: flash_attention.flash_attention(q, k, v, mask, **kw),
                      lambda: flash_attention.flash_attention_plain(q, k, v, mask, **kw),
                      library, flops, byt, atol))
        lse_cases.append((name, label, lambda: flash_attention.flash_attention(
            q, k, v, mask, return_lse=True, **kw)[1], lambda: flash_attention.flash_attention_plain(
            q, k, v, mask, return_lse=True, **kw)[1]))

    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[3, 400:] = 0  # one row with a padded tail
    q, k, v = randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh)
    attn_case("bidirectional B4 S512", q, k, v, mask, False, None, 0)
    attn_case("causal window256 B4 S512", q, k, v, mask, True, 256, 0)
    # prefill of 256 tokens at offset 512 over a layer view of a 1024-slot cache
    Smax_p = 1024
    k_all_p, v_all_p = randn(2, B, Smax_p, Hkv * Dh), randn(2, B, Smax_p, Hkv * Dh)
    mask_p = (torch.arange(Smax_p, device=dev) < 768).int()[None].repeat(B, 1)
    attn_case("causal offset512 Sq256 cache-view", randn(B, 256, H, Dh),
              k_all_p[1].view(B, Smax_p, Hkv, Dh), v_all_p[1].view(B, Smax_p, Hkv, Dh),
              mask_p, True, None, 512)


def k3_cases(dev, randn, cases, H=32, Hkv=8, Dh=128, name="flash_decode",
             atol=ATTN_ATOL) -> None:
    """K3's phase-2 shapes at (H, Hkv, Dh), appended to `cases` under
    `name`, held to `atol`: Sq 1 and 64 over a B 4, 2048-slot cache with
    1400 valid slots (a hole), the int8 cache at Sq 1, and the serving
    decode chunk's call (B 8, Smax 4096, mask-bounded, SERVING_LENS).
    `randn` gives q's dtype (bf16, or fp32 for K3's fp32 form)."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import decode_attention
    from gritlm_tpu_torch.ops.flash_attention import keep_mask

    B, Smax, L = 4, 2048, 2
    k_all, v_all = randn(L, B, Smax, Hkv * Dh), randn(L, B, Smax, Hkv * Dh)
    mask_d = (torch.arange(Smax, device=dev) < 1500).int()[None].repeat(B, 1)
    mask_d[:, 600:700] = 0  # an interior hole (concatenated RAG caches)
    for Sq in (1, 64):
        qd = randn(B, Sq, H, Dh)
        offset = 1500 - Sq
        keep = keep_mask(mask_d, Sq, Smax, causal=True, sliding_window=None,
                         offset=offset, device=dev)
        slots = int((keep.any(1)).sum())  # valid slots the step must read, over rows
        flops = 4.0 * int(keep.sum()) * H * Dh
        byt = slots * Hkv * Dh * 2 * qd.element_size() + nbytes(qd, qd, mask_d)
        hi = 1500
        lk = k_all[1, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2)
        lv = v_all[1, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2)
        am = keep[:, None, :, :hi]
        kw = dict(causal=True, offset=offset, layer=1)

        def library(qd=qd, lk=lk, lv=lv, am=am):
            return F.scaled_dot_product_attention(qd.transpose(1, 2), lk, lv, attn_mask=am,
                                                  enable_gqa=True)

        cases.append((name, f"Sq{Sq} B4 Smax2048 1400 valid",
                      lambda qd=qd, kw=kw: decode_attention.flash_decode(
                          qd, k_all, v_all, mask_d, **kw),
                      lambda qd=qd, kw=kw: decode_attention.flash_decode_plain(
                          qd, k_all, v_all, mask_d, **kw),
                      library, flops, byt, atol))

    # the int8 cache variant of K3 at the Sq = 1 decode shape
    k8, ks = quantize_kv(k_all.view(L * B, Smax, Hkv, Dh))
    v8, vs = quantize_kv(v_all.view(L * B, Smax, Hkv, Dh))
    k8, v8 = k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1)
    scales = {"k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
              "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()}
    qd = randn(B, 1, H, Dh)
    keep = keep_mask(mask_d, 1, Smax, causal=True, sliding_window=None, offset=1499,
                     device=dev)
    slots = int(keep.any(1).sum())
    kw8 = dict(causal=True, offset=1499, layer=1, **scales)
    cases.append((name, "int8 cache Sq1 B4 Smax2048 1400 valid",
                  lambda: decode_attention.flash_decode(qd, k8, v8, mask_d, **kw8),
                  lambda: decode_attention.flash_decode_plain(qd, k8, v8, mask_d, **kw8),
                  None, 4.0 * int(keep.sum()) * H * Dh,
                  slots * Hkv * (Dh + 2) * 2 + nbytes(qd, qd, mask_d), atol))

    # K3 at the serving decode chunk's call: B 8, Smax 4096, mask-bounded
    # (causal False, offset 0), the ragged rows of the serving phase's pools
    mask_s = serving_mask(dev)
    k_s, v_s = randn(2, 8, 4096, Hkv * Dh), randn(2, 8, 4096, Hkv * Dh)
    qs = randn(8, 1, H, Dh)
    kws = dict(causal=False, layer=1, num_kv_heads=Hkv)
    cases.append((name, "serving B8 Smax4096 mask-bounded",
                  lambda: decode_attention.flash_decode(qs, k_s, v_s, mask_s, **kws),
                  lambda: decode_attention.flash_decode_plain(qs, k_s, v_s, mask_s, **kws),
                  None, 0.0, 0.0, atol))


def check_cases(cases, lse_cases, max_err) -> None:
    """Each case's kernel against its plain version on the same inputs
    (its atol), and K1's LSE (LSE_ATOL; F32_ATOL for the fp32 form); the
    largest error of each kernel name into max_err; an fp32 form's rerun
    bit-equal. Fails on a disagreement, a shape or a non-finite output."""
    import torch

    for name, label, fk, fp, _, _, _, atol in cases:
        got = fk()
        torch.cuda.synchronize()
        if name.endswith(F32) and not torch.equal(got, fk()):
            fail(f"{name} [{label}]: a rerun is not bit-equal")
        want = fp()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name} [{label}]: shape {tuple(got.shape)} or non-finite output")
        err = float((got.float() - want.float()).abs().max())
        max_err[name] = max(max_err.get(name, 0.0), err)
        print(f"check {name} [{label}]: max_abs_err {err:.3e} (atol {atol})", flush=True)
        if err > atol:
            fail(f"{name} [{label}] disagrees with its plain version: {err} > {atol}")
    for name, label, fk, fp in lse_cases:
        got = fk()
        torch.cuda.synchronize()
        want = fp()
        err = float((got - want).abs().max())
        max_err[name] = max(max_err.get(name, 0.0), err)
        atol = F32_ATOL if name.endswith(F32) else LSE_ATOL
        print(f"check {name} LSE [{label}]: max_abs_err {err:.3e} (atol {atol})", flush=True)
        if got.shape != want.shape or not torch.isfinite(got).all() or err > atol:
            fail(f"{name} [{label}]: LSE disagrees with its plain version: {err}")


# valid slots of the 8 rows of a serving pool at the kernel checks and
# times of K3 and K8 (ragged, one row of a single slot; row 1 with a hole)
SERVING_LENS = (37, 1900, 256, 700, 1333, 3000, 1, 512)
# the kernels line's name of K3 with per-row offsets (the speculative verify
# chunk of a dense pool): its own row, K3's source
K3_VERIFY = "flash_decode_verify"


def serving_mask(dev, max_len: int = 4096):
    """[8, max_len] int32 slot validity of SERVING_LENS, a hole in row 1."""
    import torch

    lens = torch.tensor(SERVING_LENS, device=dev)
    mask = (torch.arange(max_len, device=dev)[None] < lens[:, None]).int()
    mask[1, 600:700] = 0  # a hole
    return mask


def kernels_per_call(fn):
    """(kernels, device operations) one call of fn launches: the nodes of a
    CUDA graph that captured the call (kept, and read through the CUDA
    runtime PyTorch loaded: cudaGraphGetNodes, cudaGraphNodeGetType; kernel
    nodes are type 0). torch.profiler dropped kernel events here (1 of 10
    calls traced), so it cannot count."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: allocator, buffers, kernel attributes
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cudart = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cudart.cudaGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("kernels_per_call: cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cudart.cudaGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    return sum(k == 0 for k in kinds), len(kinds)


def profiled_kernels_per_call(fn, calls: int = 10):
    """Device kernels a call of fn launched in one torch.profiler window
    over `calls` calls (None for a trace without device events). A trace
    drops kernels now and then, so this reading can only fall short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    return n / calls if n else None


def k3_times(dev, randn, times, H=32, Hkv=8, Dh=128, name="flash_decode",
             atol=ATTN_ATOL) -> None:
    """K3 and SDPA by CUDA events around CUDA graph replays, each call on its
    own layer of a cache with enough layers (cold_copies) that no call finds
    its K/V in L2, as in a decode step: at the kernel table's shape (Sq 1,
    B 4, Smax 2048, 1400 valid slots, causal at offset 1499), a 64-token
    prefill over it, the int8 cache, and the serving decode chunk's call
    (B 8, Smax 4096, mask-bounded, SERVING_LENS); SDPA over the slice up to
    the longest row with the boolean mask. A CUDA graph capture of one call
    counts its device operations, a profiler window of ten calls its
    kernels: more than one a call fails. `randn` gives the dtype (fp32: the
    fp32 form, its bound at the fp32 FMA rate)."""
    import torch

    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import decode_attention as da
    from gritlm_tpu_torch.ops.flash_attention import keep_mask

    mask_d = (torch.arange(2048, device=dev) < 1500).int()[None].repeat(4, 1)
    mask_d[:, 600:700] = 0  # an interior hole, as in phase 2
    shapes = (("Sq1 B4 Smax2048 1400 valid", 1, mask_d, True, 1499, False),
              ("Sq64 B4 Smax2048 1400 valid", 64, mask_d, True, 1436, False),
              ("int8 cache Sq1 B4 Smax2048 1400 valid", 1, mask_d, True, 1499, True),
              ("serving B8 Smax4096 mask-bounded", 1, serving_mask(dev), False, 0, False))
    for label, Sq, mask, causal, offset, quant in shapes:
        B, Smax = mask.shape
        keep = keep_mask(mask, Sq, Smax, causal=causal, sliding_window=None, offset=offset,
                         device=dev).expand(B, Sq, Smax)
        slots = int(keep.any(1).sum())  # slots some query of the row sees: K/V to read
        es = randn(1).element_size()
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * es  # int8: a bf16 scale a head
        bms, by = bound(4.0 * int(keep.sum()) * H * Dh,
                        slots * per_slot * 2 + nbytes(mask) + 2 * B * Sq * H * Dh * es,
                        peak_of(name))
        L = cold_copies(slots * per_slot * 2)
        k_all, v_all = randn(L, B, Smax, Hkv * Dh), randn(L, B, Smax, Hkv * Dh)
        scales = {}
        if quant:
            k8, ks = quantize_kv(k_all.view(L * B, Smax, Hkv, Dh))
            v8, vs = quantize_kv(v_all.view(L * B, Smax, Hkv, Dh))
            k_all, v_all = k8.view(L, B, Smax, -1), v8.view(L, B, Smax, -1)
            scales = {"k_scale": ks.view(L, B, Smax, Hkv).transpose(2, 3).contiguous(),
                      "v_scale": vs.view(L, B, Smax, Hkv).transpose(2, 3).contiguous()}
        q = randn(B, Sq, H, Dh)
        kw = dict(causal=causal, offset=offset, num_kv_heads=Hkv, **scales)

        def call(layer, q=q, k_all=k_all, v_all=v_all, mask=mask, kw=kw):
            return da.flash_decode(q, k_all, v_all, mask, layer=layer, **kw)

        def plain(layer, q=q, k_all=k_all, v_all=v_all, mask=mask, kw=kw):
            return da.flash_decode_plain(q, k_all, v_all, mask, layer=layer, **kw)

        views = None  # no single PyTorch call computes the int8 variant
        if not quant:
            hi = int(keep.any(1).any(0).nonzero().max()) + 1  # the slice up to the longest row
            views = [(k_all[layer, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2),
                      v_all[layer, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2))
                     for layer in range(L)]
        cold_decode_time(name, label, call, plain, L, q, keep, views, bms, by, times,
                         "the sliced cache", atol)
        del k_all, v_all, scales, views
        torch.cuda.empty_cache()


def cold_decode_time(name, label, call, plain, L, q, keep, views, bms, by, times,
                     library_on, atol=ATTN_ATOL) -> None:
    """A decode kernel (K3, K8) at one shape: call(layer) against
    plain(layer) at the last layer, then its device ms by CUDA graph replays
    of one call on each of L layers (cold, L from cold_copies), SDPA the
    same way over `views` (per layer (k, v) [B, Hkv, hi, Dh]; None: no
    library call) with keep's boolean mask sliced to hi, and the device
    operations of one call from a captured CUDA graph beside a profiler
    window's kernels: more than one a call fails. The first shape of a
    kernel is its table row (with its plain version's time by the
    profiler); the other shapes' plain versions are timed by CUDA events
    around calls launched back to back."""
    import torch
    import torch.nn.functional as F

    got = call(L - 1)
    torch.cuda.synchronize()
    err = float((got.float() - plain(L - 1).float()).abs().max())
    if err > atol or not torch.isfinite(got).all():
        fail(f"{name} [{label}, {L} layers] disagrees with its plain version: {err}")
    ms = graph_ms(lambda: [call(layer) for layer in range(L)]) / L
    library_ms = None
    if views is not None:
        qt, am = q.transpose(1, 2), keep[:, None, :, :views[0][0].shape[2]]
        library_ms = graph_ms(lambda: [F.scaled_dot_product_attention(
            qt, lk, lv, attn_mask=am, enable_gqa=True) for lk, lv in views]) / L
    n_kernels, n_ops = kernels_per_call(lambda: call(0))
    profiled = profiled_kernels_per_call(lambda: call(0))
    line = (f"time {name} [{label}]: device {ms:.4f} ms ({bms / ms * 100:.1f}% of "
            f"bound {bms:.4f} ms, {by}), library "
            f"{'none' if library_ms is None else f'{library_ms:.4f}'} (SDPA over "
            f"{library_on}); CUDA graph replays over {L} layers (cold); device kernels a "
            f"call: {n_kernels} ({n_ops} device operations in its captured graph; a "
            f"profiler window: {'no device events' if profiled is None else f'{profiled:g}'})")
    if name not in times:  # the table's row
        plain_ms = time_ms(lambda: plain(0), reps=10)[0]
        times[name] = (ms, plain_ms, library_ms, bms, by)
        line += f"; plain {plain_ms:.4f}"
    else:  # the other shapes' plain versions by events around back-to-back calls
        line += f"; plain {event_ms(lambda: plain(0), reps=5, warmup=1):.4f} (events)"
    print(line, flush=True)
    if n_ops > 1 or (profiled or 0) > 1:
        fail(f"{name} [{label}]: {n_ops} device operations a call (profiler: "
             f"{profiled}), not one kernel")


def paged_pool(dev, randn, L, B=8, Hkv=8, Dh=128, page=256, max_len=4096):
    """A page pool of L layers at the serving shape: the rows of
    SERVING_LENS on pages scattered over the pool (page 0 scratch), a
    prefix page shared by rows 3 and 4, the serving mask (a hole in row
    1). Returns (page_table, mask, bf16 pages (k, v), int8 pages (k, v),
    their scales {"k_scale", "v_scale"})."""
    import torch

    from gritlm_tpu_torch.models.transformer import quantize_kv

    maxp = max_len // page
    lens = torch.tensor(SERVING_LENS, device=dev)
    need = (lens + page - 1) // page
    P = int(need.sum()) + 1  # page 0: scratch
    pt = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0)) + 1
    at = 0
    for b in range(B):  # each row's pages, scattered over the pool
        n = int(need[b])
        pt[b, :n] = perm[at:at + n].to(dev)
        at += n
    pt[4, 0] = pt[3, 0]  # a prefix page shared by two rows
    k_pages, v_pages = randn(L, P, page, Hkv * Dh), randn(L, P, page, Hkv * Dh)
    k8, ks = quantize_kv(k_pages.view(L * P, page, Hkv, Dh))
    v8, vs = quantize_kv(v_pages.view(L * P, page, Hkv, Dh))
    scales = {"k_scale": ks.view(L, P, page, Hkv).transpose(2, 3).contiguous(),
              "v_scale": vs.view(L, P, page, Hkv).transpose(2, 3).contiguous()}
    return (pt, serving_mask(dev, max_len), (k_pages, v_pages),
            (k8.view(L, P, page, -1), v8.view(L, P, page, -1)), scales)


# K8's shapes: (Sq, int8 pages); Sq 8 is the causal verify chunk at per-row
# offsets lens - 8
K8_SHAPES = ((1, False), (1, True), (8, False), (8, True))


def k8_keep(mask, Sq):
    """[B, Sq, Smax] slots each query of a K8 shape sees, and the per-row
    offsets (None at Sq 1: mask-bounded)."""
    import torch

    B, Smax = mask.shape
    keep = mask.bool()[:, None, :].expand(B, Sq, Smax)
    if Sq == 1:
        return keep, None
    offs = (torch.tensor(SERVING_LENS, device=mask.device) - Sq).clamp_min(0).to(torch.int32)
    pos = offs[:, None] + torch.arange(Sq, device=mask.device)
    return keep & (torch.arange(Smax, device=mask.device)[None, None] <= pos[..., None]), offs


def k8_cases(dev, randn, cases, B=8, H=32, Hkv=8, Dh=128, name="paged_decode",
             atol=ATTN_ATOL, page=256) -> None:
    """K8 at the serving shape (Mistral-7B heads, B 8, page 256, a 4096-slot
    logical width): ragged rows, a hole, a page shared by two rows, bf16 and
    int8 pages, Sq 1 and a causal Sq 8 chunk at per-row offsets; and K8
    against K3 on the same logical cache laid out dense and paged (whether
    the two are bit-equal is printed: they run the same kernel body).
    `randn` gives the dtype: fp32 runs the fp32 forms, held to `atol` and
    required bit-equal to K3's fp32 form; `page` the pool's page size."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.ops import decode_attention, paged_attention

    L = 2
    pt, mask, (k_pages, v_pages), (k8, v8), scales = paged_pool(dev, randn, L, B, Hkv, Dh,
                                                                page=page)
    max_len = mask.shape[1]
    slots = int(mask.sum())
    dt = dt_label(k_pages)
    dense_k = paged_attention.gather_pages(k_pages, pt, 1).view(B, max_len, Hkv, Dh)
    dense_v = paged_attention.gather_pages(v_pages, pt, 1).view(B, max_len, Hkv, Dh)
    for Sq, quant in K8_SHAPES:
        q = randn(B, Sq, H, Dh)
        keep, offs = k8_keep(mask, Sq)
        kw = dict(layer=1, num_kv_heads=Hkv, causal=Sq > 1,
                  offset=0 if offs is None else offs, **(scales if quant else {}))
        kp, vp = (k8, v8) if quant else (k_pages, v_pages)
        # bytes: each valid slot's K and V rows (int8: 1 byte a value plus a
        # bf16 scale per head), q in, out, mask and page table
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * k_pages.element_size()
        byt = slots * per_slot * 2 + nbytes(q, q, mask, pt)
        library = None
        if not quant:
            am = keep[:, None]

            def library(q=q, am=am):  # SDPA over the same K/V laid out dense (gather untimed)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), dense_k.transpose(1, 2), dense_v.transpose(1, 2),
                    attn_mask=am, enable_gqa=True)

        cases.append((name,
                      f"{'int8' if quant else dt} Sq{Sq} B8 page{page} {slots} valid slots",
                      lambda q=q, kp=kp, vp=vp, kw=kw: paged_attention.paged_decode(
                          q, kp, vp, pt, mask, **kw),
                      lambda q=q, kp=kp, vp=vp, kw=kw: paged_attention.paged_decode_plain(
                          q, kp, vp, pt, mask, **kw),
                      library, 4.0 * int(keep.sum()) * H * Dh, byt, atol))

    # K8 against K3 on the same logical cache, dense and paged
    q = randn(B, 1, H, Dh)
    k_dense = torch.stack([paged_attention.gather_pages(k_pages, pt, i) for i in range(L)])
    v_dense = torch.stack([paged_attention.gather_pages(v_pages, pt, i) for i in range(L)])
    got = paged_attention.paged_decode(q, k_pages, v_pages, pt, mask, layer=1,
                                       num_kv_heads=Hkv)
    want = decode_attention.flash_decode(q, k_dense, v_dense, mask, causal=False, layer=1,
                                         num_kv_heads=Hkv)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    equal = torch.equal(got, want)
    print(f"check {name} against flash_decode on the same logical cache (B8, page {page}, "
          f"{slots} valid slots): max_abs_err {err:.3e} (atol {atol}), bit-equal "
          f"{equal}", flush=True)
    if err > atol or not torch.isfinite(got).all() or (name.endswith(F32) and not equal):
        fail(f"K8 and K3 disagree on the same logical cache: {err}, bit-equal {equal}")


def k8_times(dev, randn, times, B=8, H=32, Hkv=8, Dh=128, name="paged_decode",
             atol=ATTN_ATOL, shapes=K8_SHAPES) -> None:
    """K8 and SDPA by CUDA events around CUDA graph replays at the four
    K8_SHAPES (bf16 and int8 pages, Sq 1 mask-bounded and the causal Sq 8
    chunk at per-row offsets), each call on its own layer of a pool with
    enough layers (cold_copies) that no call finds its K/V in L2, as in a
    serving step; SDPA (bf16 only) over the same K/V laid out dense, sliced
    to the longest row, with the boolean mask. Device operations a call
    counted: more than one fails (cold_decode_time). `randn` gives the
    dtype (fp32: the fp32 form at `shapes`, its bound at the fp32 FMA
    rate)."""
    import torch

    from gritlm_tpu_torch.ops import paged_attention as pa

    lens = torch.tensor(SERVING_LENS)
    es = randn(1).element_size()
    for Sq, quant in shapes:
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * es
        L = cold_copies(int(lens.sum()) * per_slot * 2)
        pt, mask, bf16_pages, int8_pages, scales = paged_pool(dev, randn, L, B, Hkv, Dh)
        kp, vp = int8_pages if quant else bf16_pages
        del bf16_pages, int8_pages
        keep, offs = k8_keep(mask, Sq)
        slots = int(keep.any(1).sum())  # slots some query of the row sees: K/V to read
        q = randn(B, Sq, H, Dh)
        bms, by = bound(4.0 * int(keep.sum()) * H * Dh,
                        slots * per_slot * 2 + nbytes(mask, pt) + 2 * B * Sq * H * Dh * es,
                        peak_of(name))
        kw = dict(num_kv_heads=Hkv, causal=Sq > 1, offset=0 if offs is None else offs,
                  **(scales if quant else {}))

        def call(layer, q=q, kp=kp, vp=vp, kw=kw):
            return pa.paged_decode(q, kp, vp, pt, mask, layer=layer, **kw)

        def plain(layer, q=q, kp=kp, vp=vp, kw=kw):
            return pa.paged_decode_plain(q, kp, vp, pt, mask, layer=layer, **kw)

        views = None  # no single PyTorch call computes the int8 variant
        if not quant:
            hi = int(keep.any(1).any(0).nonzero().max()) + 1
            views = []
            for layer in range(L):
                dk, dv = (pa.gather_pages(x, pt, layer)[:, :hi].view(B, hi, Hkv, Dh)
                          .transpose(1, 2) for x in (kp, vp))
                views.append((dk, dv))
        cold_decode_time(name, f"{'int8' if quant else dt_label(q)} Sq{Sq} B8 page256 "
                         f"{slots} slots seen", call, plain, L, q, keep, views, bms, by, times,
                         "the dense layout", atol)
        del kp, vp, scales, views
        torch.cuda.empty_cache()


# K2's shapes beside the kernel table's (B 8, S 512, D 4096, mean and
# weightedmean): one long row over the whole card, many short rows (one of
# them empty), the Qwen2-7B width, rows that are views into wider ones
K2_SHAPES = ((1, 4096, 4096, False), (64, 128, 4096, False), (8, 512, 3584, False),
             (8, 512, 4096, True))


def pool_case(dev, randn, B, S, D, strided=False, edges=False):
    """(hidden, gamma, mask) of a K2 case: hidden [B, S, D] in randn's dtype (a view
    into [B, S, 2D] rows when strided), a 12-token instruction prefix
    masked out of every row, every other row padded from 300 (from S * 3/5
    when S < 512); with `edges`, row 2 one token and at B > 8 row 3 empty."""
    import torch

    base = randn(B, S, 2 * D if strided else D)
    hidden = base[..., :D] if strided else base
    gamma = (1 + 0.1 * randn(D).float()).to(hidden.dtype)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    mask[:, :12] = 0  # instruction prefix
    mask[1::2, min(300, S * 3 // 5):] = 0  # padding
    if edges and B > 2:
        mask[2] = 0
        mask[2, S // 2] = 1
    if edges and B > 8:
        mask[3] = 0
    return hidden, gamma, mask


def pool_library(hidden, gamma, mask, method):
    """The encode epilogue by PyTorch calls (F.rms_norm, then the masked
    mean and the L2 normalize): the yardstick beside K2, never used by the
    port."""
    import torch
    import torch.nn.functional as F

    x = F.rms_norm(hidden, (hidden.shape[-1],), weight=gamma, eps=1e-5).float()
    w = mask.float()
    if method == "weightedmean":
        w = w * w.cumsum(1)
    e = torch.einsum("bs,bsd->bd", w, x) / w.sum(1, keepdim=True).clamp_min(1)
    return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def k2_checks(dev, randn, max_err, name="fused_norm_mean_pool", atol=POOL_ATOL) -> None:
    """K2 against its plain version within `atol` at K2_SHAPES, mean and
    weightedmean, normalized and not; every call run twice and the two
    required bit-equal; an empty mask row comes out zero. `randn` gives the
    dtype (fp32: the fp32 form, row `name`)."""
    import torch

    from gritlm_tpu_torch.ops import fused_pool as fp

    for B, S, D, strided in K2_SHAPES:
        hidden, gamma, mask = pool_case(dev, randn, B, S, D, strided, edges=True)
        for method in ("mean", "weightedmean"):
            for normalized in (True, False):
                kw = dict(eps=1e-5, method=method, normalized=normalized)
                got = fp.fused_norm_mean_pool(hidden, gamma, mask, **kw)
                again = fp.fused_norm_mean_pool(hidden, gamma, mask, **kw)
                torch.cuda.synchronize()
                want = fp.fused_norm_mean_pool_plain(hidden, gamma, mask, **kw)
                label = (f"{method} B{B} S{S} D{D}{' strided' if strided else ''}"
                         f"{'' if normalized else ' unnormalized'}")
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"{name} [{label}]: shape or non-finite output")
                err = float((got - want).abs().max())
                same = torch.equal(got, again)
                empty = B <= 8 or torch.count_nonzero(got[3]) == 0
                print(f"check {name} [{label}]: max_abs_err {err:.3e} (atol {atol}); rerun "
                      f"bit-equal: {same}", flush=True)
                if err > atol or not same or not empty:
                    fail(f"{name} [{label}] disagrees with its plain version ({err}), a rerun "
                         f"differs ({not same}) or an empty row is not 0")
                max_err[name] = max(max_err.get(name, 0.0), err)
        del hidden
        torch.cuda.empty_cache()


K2_TIMES = ((8, 512, 4096, "mean"), (8, 512, 4096, "weightedmean"), (1, 4096, 4096, "mean"),
            (64, 128, 4096, "mean"))


def k2_times(dev, randn, times, name="fused_norm_mean_pool", shapes=K2_TIMES) -> None:
    """K2 and its library call (pool_library) by CUDA events around CUDA
    graph replays, each call on its own copy of the hidden state
    (cold_copies of it, so no call finds its rows in L2, as after a trunk
    forward), at the kernel table's shape (B 8, S 512, D 4096, mean: the
    table's row, with the plain version's time) and weightedmean, and at
    B 1 S 4096 and B 64 S 128; the device operations of one call from a
    captured CUDA graph (more than one fails), and the profiler's warm
    reading over back-to-back calls beside. `randn` gives the dtype (fp32:
    the fp32 form at `shapes`, row `name`, its bound at the fp32 FMA
    rate)."""
    import torch

    from gritlm_tpu_torch.ops import fused_pool as fp

    for B, S, D, method in shapes:
        hidden, gamma, mask = pool_case(dev, randn, B, S, D)
        rows = int(mask.sum())
        bms, by = bound(4.0 * rows * D, rows * D * hidden.element_size() + nbytes(gamma, mask)
                        + B * D * 4, peak_of(name))
        n = cold_copies(nbytes(hidden))
        copies = [hidden] + [randn(*hidden.shape) for _ in range(n - 1)]
        kw = dict(eps=1e-5, method=method)
        ms = graph_ms(lambda: [fp.fused_norm_mean_pool(h, gamma, mask, **kw)
                               for h in copies]) / n
        library_ms = graph_ms(lambda: [pool_library(h, gamma, mask, method)
                                       for h in copies]) / n
        n_kernels, n_ops = kernels_per_call(lambda: fp.fused_norm_mean_pool(hidden, gamma,
                                                                            mask, **kw))
        warm = time_ms(lambda: fp.fused_norm_mean_pool(hidden, gamma, mask, **kw))[0]
        label = f"{method} B{B} S{S} D{D} {dt_label(hidden)}, {rows} masked-in rows"
        line = (f"time {name} [{label}]: device {ms:.4f} ms cold "
                f"({bms / ms * 100:.1f}% of bound {bms:.4f} ms, {by}), library "
                f"{library_ms:.4f} (F.rms_norm + masked mean + normalize, cold); CUDA graph "
                f"replays over {n} copies of the hidden state; device kernels a call: "
                f"{n_kernels} ({n_ops} device operations in its captured graph); "
                f"torch.profiler over back-to-back calls (warm) {warm:.4f}")
        if name not in times:  # the table's row
            plain_ms = time_ms(lambda: fp.fused_norm_mean_pool_plain(hidden, gamma, mask, **kw),
                               reps=10)[0]
            times[name] = (ms, plain_ms, library_ms, bms, by)
            line += f"; plain {plain_ms:.4f}"
        print(line, flush=True)
        if n_ops > 1:
            fail(f"{name} [{label}]: {n_ops} device operations a call, not one kernel")
        del hidden, copies
        torch.cuda.empty_cache()


PROJECTION = 1024  # the head's width on the card (the JAX package takes any)


def projection_phase(model, reset_counts, read_counts, path_launches) -> None:
    """GritLM(projection=PROJECTION) on the model's weights (counts set to 0
    before, read after): 16 sentences encode to [16, PROJECTION] without
    K2 (the head projects every token before the pool), at cosine >=
    COSINE_MIN to an fp32 rms_norm -> @ W + b -> mean pool -> normalize of
    the same pre-norm hidden state on the card; host ms of the encode
    beside the headless model's."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.gritlm import _bucket
    from gritlm_tpu_torch.models.transformer import forward

    pm = GritLM(model.config, params=model.params, projection=PROJECTION, seed=0)
    pm.encode(SENTENCES[:2])  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    emb = torch.from_numpy(pm.encode(SENTENCES))
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = read_counts()
    path_launches["projection encode"] = counts
    t0 = time.time()
    model.encode(SENTENCES)
    torch.cuda.synchronize()
    dt_plain = time.time() - t0
    if tuple(emb.shape) != (16, PROJECTION) or not torch.isfinite(emb).all():
        fail(f"projection encode: shape {tuple(emb.shape)} or non-finite values")
    if counts["fused_norm_mean_pool"] != 0 or counts["flash_attention"] == 0:
        fail(f"projection encode: launches {counts} (K2 must not run, K1 must)")
    tok, cfg = pm.tokenizer, pm.config
    enc = tok(SENTENCES, max_length=512)
    ids, mask = enc["input_ids"], enc["attention_mask"]
    pad = _bucket(ids.shape[1], pm.seq_buckets) - ids.shape[1]
    ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=tok.pad_token_id)
    mask = np.pad(mask, ((0, 0), (0, pad)))
    dev = pm.device
    mask_t = torch.as_tensor(mask, device=dev)
    with torch.inference_mode():
        hidden, _, _ = forward(pm.params, cfg, torch.as_tensor(ids, device=dev),
                               attention_mask=mask_t, causal=pm.embed_causal, final_norm=False)
        x = hidden.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
        x = x * pm.params["final_ln"]["scale"].float()
        y = x @ pm.projection["kernel"].float() + pm.projection["bias"].float()
        w = mask_t.float()
        ref = torch.einsum("bs,bsd->bd", w, y) / w.sum(1, keepdim=True)
        ref = (ref / ref.norm(dim=-1, keepdim=True)).cpu()
    cos = F.cosine_similarity(emb, ref, dim=-1)
    print(f"projection encode [{PROJECTION}]: 16 sentences -> {tuple(emb.shape)} in "
          f"{dt * 1e3:.1f} ms (host clock; without the head, through K2: "
          f"{dt_plain * 1e3:.1f} ms); launches {counts}; min cosine to the fp32 "
          f"rms_norm -> @W+b -> pool -> normalize of the same hidden state "
          f"{float(cos.min()):.6f}", flush=True)
    if cos.min() < COSINE_MIN:
        fail(f"projection encode departs from its fp32 reference: {cos.tolist()}")
    del pm


def search_phase(dev, check_scores_segmax, unit_rows, reset_counts, read_counts,
                 path_launches, times, N_DOCS=1_000_000, CAP=2**20, DIM=4096) -> None:
    """FlatIndex at index size: 1,000,000 random unit bf16 rows of width
    4096 (capacity 2^20, 8 GiB), exact top-100 for one 256-query block."""
    import torch

    from gritlm_tpu_torch.index import FlatIndex
    from gritlm_tpu_torch.ops import scores_segmax

    QB, K, BLOCK = 256, 100, 65536
    t0 = time.time()
    index = FlatIndex(DIM, CAP, device=dev)
    first = None
    for a in range(0, N_DOCS, BLOCK):
        rows = unit_rows(min(BLOCK, N_DOCS - a), DIM)
        index.add(rows)
        first = rows if first is None else first
    qs = unit_rows(QB, DIM)
    torch.cuda.synchronize()
    print(f"index: {index.n_docs} rows of {DIM} bf16 in a capacity of {index.capacity} "
          f"({nbytes(index.embeddings) / 2**30:.2f} GiB), filled in {time.time() - t0:.1f} s",
          flush=True)

    reset_counts()
    scores, ids = index.search(qs, k=K, mode="exact")
    counts = read_counts()
    path_launches["search"] = counts
    print(f"search launches: {counts}")
    if counts["scores_segmax"] == 0:
        fail("search did not go through K9")
    if scores.shape != (QB, K) or not np.isfinite(scores).all() or ids.min() < 0 \
            or ids.max() >= index.n_docs:
        fail("search: scores not finite or ids out of range")

    def topk_error(got_s, got_i, q, emb):
        plain = scores_segmax.scores_segmax_plain(q, emb, emb.shape[0])[0]
        want = torch.topk(plain, K, dim=1).values.cpu()
        at_ids = plain.gather(1, torch.from_numpy(got_i).long().to(dev)).cpu()
        got = torch.from_numpy(got_s)
        return max(float((got - want).abs().max()), float((at_ids - got).abs().max()))

    err_full = topk_error(scores, ids, qs, index.embeddings[:index.n_docs])
    piece = FlatIndex(DIM, BLOCK, device=dev)
    piece.add(first)
    err_piece = topk_error(*piece.search(qs, k=K), qs, first)
    print(f"search values against a plain top-{K}: max abs err {err_full:.3e} over the "
          f"1M index, {err_piece:.3e} over a 65536-row slice (atol {K9_ATOL})")
    if max(err_full, err_piece) > K9_ATOL:
        fail("search disagrees with a plain top-k")
    del piece, first
    check_scores_segmax("Q256 N2^20 1M docs (the index)", qs, index.embeddings, index.n_docs)

    emb, nd = index.embeddings, index.n_docs
    masked = (torch.arange(CAP, device=dev) >= nd)[None]
    try:  # the yardstick's product in fp32 where this torch takes out_dtype
        torch.mm(qs[:1], emb[:128].t(), out_dtype=torch.float32)
        lib_fp32 = True
    except (TypeError, RuntimeError):
        lib_fp32 = False

    def library():
        s = (torch.mm(qs, emb.t(), out_dtype=torch.float32) if lib_fp32
             else torch.mm(qs, emb.t()))
        s = s.masked_fill(masked, float("-inf"))
        return s, s.view(QB, -1, 128).amax(-1)

    # K9 and the library by CUDA events around calls launched back to back
    # (the table's figures), torch.profiler's device time as a second reading;
    # Q = 128 is half a query block, Q = 4 the RAG path's query batch
    plain_ms, _ = time_ms(lambda: scores_segmax.scores_segmax_plain(qs, emb, nd), reps=3,
                          warmup=1)
    for q_rows in (QB, 128, 4):
        qq = qs[:q_rows].contiguous()
        flops = 2.0 * q_rows * nd * DIM
        byt = nd * DIM * 2 + nbytes(qq) + q_rows * CAP * 4 + (CAP // 128) * q_rows * 4
        bms, by = bound(flops, byt)
        ms = event_ms(lambda: scores_segmax.scores_segmax(qq, emb, nd), reps=10)
        prof_ms, _ = time_ms(lambda: scores_segmax.scores_segmax(qq, emb, nd), reps=10)
        gbs = byt / (ms * 1e-3) / 1e9
        line = (f"time scores_segmax [Q{q_rows} N2^20, 1M docs] by events: {ms:.4f} ms = "
                f"{gbs:.1f} GB/s{peak_note(gbs, PEAK_BYTES / 1e9)} ({bms / ms * 100:.1f}% of "
                f"bound {bms:.4f} ms, {by}); profiler {prof_ms:.4f} ms"
                f"{peak_note(byt / (prof_ms * 1e-3) / 1e9, PEAK_BYTES / 1e9)}")
        if q_rows == QB:
            library_ms = event_ms(library, reps=10)
            lib_prof, _ = time_ms(library, reps=10)
            lib_gbs = byt / (library_ms * 1e-3) / 1e9
            line += (f"; plain {plain_ms:.4f}; library (torch.mm {'fp32' if lib_fp32 else 'bf16'} "
                     f"out + masked_fill + amax) events {library_ms:.4f} ms = {lib_gbs:.1f} GB/s"
                     f"{peak_note(lib_gbs, PEAK_BYTES / 1e9)}, profiler {lib_prof:.4f}"
                     f"{peak_note(byt / (lib_prof * 1e-3) / 1e9, PEAK_BYTES / 1e9)}")
            if peak_note(lib_gbs, PEAK_BYTES / 1e9):
                library_ms = None  # an impossible reading stays out of the table
            times["scores_segmax"] = (ms, plain_ms, library_ms, bms, by)
        print(line, flush=True)

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.search(qs, k=K)
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    print(f"search: {QB} queries, exact top-{K} over {nd} docs: {wall * 1e3:.2f} ms per "
          f"256-query block (host clock, median of 5) = {QB / wall:.0f} queries/s")
    profile_window("search 256 queries over 1M docs", lambda: index.search(qs, k=K))
    del index, emb, qs, masked
    torch.cuda.empty_cache()


def rag_phase(model, reset_counts, read_counts, path_launches, key="rag"):
    """RAGEngine at full width over the 16 sentences: build_index with doc
    caches, self-retrieval at top-1, answer_batch in all seven cache modes,
    and the device pool against the host store; the launch counts into
    path_launches[key]."""
    import torch

    from gritlm_tpu_torch.rag import CacheMode, RAGEngine
    from gritlm_tpu_torch.training.templates import gritlm_instruction

    recorded = []
    generate_from_ids = model.generate_from_ids

    def recording(*args, **kwargs):  # keeps each answer's token ids for the checks
        res = generate_from_ids(*args, **kwargs)
        recorded.append(res.tokens)
        return res

    model.generate_from_ids = recording
    try:
        reset_counts()
        t0 = time.time()
        eng = RAGEngine(model, max_new_tokens=16, encode_max_length=512)
        eng.build_index([{"text": s} for s in SENTENCES], batch_size=16, cache_docs=True)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        if eng._device_pool.get(False) is None:
            fail("rag: the 16-passage doc store was not pinned in the device pool")
        q_emb = model.encode_queries(SENTENCES, instruction=gritlm_instruction(""),
                                     max_length=512, convert_to_tensor=True)
        sc, ids = eng.index.search(q_emb, k=2)
        hits = int((ids[:, 0] == np.arange(16)).sum())
        print(f"rag: index + doc caches of 16 passages built in {build_s:.2f} s; "
              f"self-retrieval top-1 {hits}/16, self scores {sc[:, 0].min():.4f} to "
              f"{sc[:, 0].max():.4f}, smallest gap to the runner-up "
              f"{float((sc[:, 0] - sc[:, 1]).min()):.4f}", flush=True)
        if hits != 16:
            fail("rag: a passage's own string did not retrieve it at top-1")
        queries = SENTENCES[:4]
        vocab = model.config.vocab_size
        for mode in CacheMode:
            res = eng.answer_batch(queries, mode=mode)
            toks = recorded[-1]
            if toks.shape[0] != 4 or not ((toks >= 0) & (toks < vocab)).all():
                fail(f"rag [{mode.value}]: token ids out of range")
            if mode != CacheMode.NO_RETRIEVAL:
                if [r.passages[0]["text"] for r in res] != queries:
                    fail(f"rag [{mode.value}]: a query did not retrieve its own passage")
                if not all(np.isfinite(r.scores).all() for r in res):
                    fail(f"rag [{mode.value}]: non-finite retrieval scores")
            print(f"rag [{mode.value}]: {res[0].seconds * 1e3:.1f} ms/query (batch 4, 16 new "
                  f"tokens), answer {res[0].answer!r}", flush=True)

        # The pool pads rows to the corpus's widest doc, the host fetch to the
        # batch's; with the widest passage in the batch both give the same
        # cache layout, so the same kernels see the same inputs and the
        # greedy tokens must be identical.
        host = RAGEngine(model, max_new_tokens=16, encode_max_length=512, doc_pool_bytes=0)
        host.index, host._doc_store = eng.index, eng._doc_store
        widest = max(range(16), key=lambda d: eng._doc_store[(d, False)][2])
        batch = [SENTENCES[widest]] + [s for s in queries if s != SENTENCES[widest]][:3]
        ids = [SENTENCES.index(s) for s in batch]
        a, b = eng._fetch_doc_caches(ids, False), host._fetch_doc_caches(ids, False)
        if host._device_pool.get(False) is not None:
            fail("rag: doc_pool_bytes=0 still pinned a device pool")
        if a.length != b.length or not all(torch.equal(getattr(a, f), getattr(b, f))
                                           for f in ("k", "v", "mask")):
            fail("rag: the device pool and the host store give different doc caches")
        eng._stacked_last = None  # gather from the pool again
        eng.answer_batch(batch, mode=CacheMode.DOC)
        pooled = recorded[-1]
        host.answer_batch(batch, mode=CacheMode.DOC)
        if not torch.equal(pooled, recorded[-1]):
            fail("rag: the device pool and the host store give different greedy tokens")
        print("rag [doc]: device pool and host store give identical caches and greedy tokens")
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        del model.generate_from_ids
    path_launches[key] = counts
    print(f"{key} launches: {counts}")
    if any(counts[n] == 0 for n in ("flash_attention", "fused_norm_mean_pool", "flash_decode",
                                    "scores_segmax")):
        fail("rag did not go through every kernel of its path (K1, K2, K3, K9)")
    del host
    torch.cuda.empty_cache()
    return eng


def serving_workload(model, reset_counts, read_counts, total, f32=False):
    """The serving workload of `model` (whose params the engines are given):
    24 generation requests (seeded prompts of 32-1900 tokens, 8-64 new
    tokens) and 8 embedding requests. Returns (drive, specs); drive(label,
    eng, gen_specs, n_embeds, decode_kernels=()) runs the requests and n
    embedding requests through the engine with the launch counts set to 0
    before and added to `total` after, checks every completion, the pool
    embeddings against GritLM.encode, K3/K8 (and `decode_kernels`) inside
    the decode chunks and a teacher-forced forward, and returns (generated
    tokens/s, peak reserved pages). f32: an fp32 model, whose launches are
    the fp32 forms' counts (F32 names)."""
    import torch

    from gritlm_tpu_torch import serving
    from gritlm_tpu_torch.serving import EmbedRequest, Request
    from gritlm_tpu_torch.tokenizer import instruction_token_lens

    cfg, tok = model.config, model.tokenizer
    V, eos = cfg.vocab_size, tok.eos_token_id
    rng = np.random.default_rng(0)
    specs = [(f"g{i}", rng.integers(3, V, size=int(n)).tolist(), int(m)) for i, (n, m) in
             enumerate(zip(rng.integers(32, 1901, 24), rng.integers(8, 65, 24)))]
    enc = tok([INSTRUCTION + s + model.embed_eos for s in SENTENCES[:8]], max_length=512)
    ilens = instruction_token_lens(tok, INSTRUCTION, enc["input_ids"], enc["attention_mask"])
    embed_specs = [(f"e{i}", enc["input_ids"][i, :int(enc["attention_mask"][i].sum())].tolist(),
                    int(ilens[i])) for i in range(8)]
    want_emb = torch.from_numpy(model.encode(SENTENCES[:8], instruction=INSTRUCTION))

    decode_counts = {}  # launches inside decode (or verify) chunks, per run
    verify_emits = []  # the verify chunks' emitted counts [steps, B], per run
    programs = {name: getattr(serving, name)
                for name in ("_decode_chunk_program", "_spec_chunk_program")}

    def counting(name):
        def run(*args, **kw):
            before = read_counts()
            out = programs[name](*args, **kw)
            for n, c in read_counts().items():
                decode_counts[n] = decode_counts.get(n, 0) + c - before[n]
            if name == "_spec_chunk_program":
                verify_emits.append(out[1])
            return out
        return run

    counted = {name: counting(name) for name in programs}

    def drive(label, eng, gen_specs, n_embeds, decode_kernels=(), req_kw=None,
              doc_specs=(), embed_kw=None, check=True, tie_tol=TIE_TOL):
        """req_kw: per request id, Request keywords (sampling, adapter);
        embed_kw: per embedding request id, EmbedRequest keywords (adapter);
        doc_specs: doc-continuation requests (rid, prompt ids, max new, doc
        entry, doc ids), the doc ids as their lookup corpus (hist_ids).
        check=False leaves out the checks against `model` (pool embeddings
        against GritLM.encode, teacher forcing): the caller holds the
        results to its own oracles (an adapter pool's); tie_tol bounds the
        teacher-forced deficits. Returns {"rate",
        "ttft50", "peak", "tokens", "embs", "verify", "book"}: generated
        tokens/s, time to first token p50 (s), peak reserved pages, the
        tokens and the pool embeddings by request, (speculative pools) the
        verify chunks' emitted counts [steps, B] on the host, and (a MoE
        model) the RouteBook of the run: its teacher forcing and embedding
        checks pin the routes the engine took."""
        import contextlib
        first_at, peak = {}, [0]
        req_kw, embed_kw = req_kw or {}, embed_kw or {}

        def on_token(rid, _tok):
            first_at.setdefault(rid, time.perf_counter())
            if eng.paged:
                peak[0] = max(peak[0], eng.pool_pages - 1 - len(eng._free_pages))

        eng.on_token = on_token
        reqs = [Request(input_ids=ids, max_new_tokens=m, request_id=rid, **req_kw.get(rid, {}))
                for rid, ids, m in gen_specs]
        reqs += [Request(input_ids=ids, max_new_tokens=m, request_id=rid, doc_cache=entry,
                         hist_ids=doc) for rid, ids, m, entry, doc in doc_specs]
        reqs += [EmbedRequest(input_ids=ids, instr_len=il, request_id=rid,
                              **embed_kw.get(rid, {}))
                 for rid, ids, il in embed_specs[:n_embeds]]
        decode_counts.clear()
        verify_emits.clear()
        for name in programs:
            setattr(serving, name, counted[name])
        book = RouteBook(eng) if cfg.is_moe else None
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with book or contextlib.nullcontext():
                done = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        finally:
            for name, program in programs.items():
                setattr(serving, name, program)
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        embs = {e.request_id: e.embedding for e in eng.take_embeddings()}
        by_id = {c.request_id: c for c in done}
        all_specs = list(gen_specs) + [(rid, ids, m) for rid, ids, m, _, _ in doc_specs]
        if sorted(by_id) != sorted(rid for rid, _, _ in all_specs):
            fail(f"serving [{label}]: completions {sorted(by_id)}")
        for rid, ids, m in all_specs:
            c = by_id[rid]
            t = c.token_ids
            ok = ((c.finish_reason == "length" and len(t) == m and eos not in t)
                  or (c.finish_reason == "eos" and 0 < len(t) <= m and t[-1] == eos
                      and eos not in t[:-1]))
            if not ok or min(t) < 0 or max(t) >= V:
                fail(f"serving [{label}] {rid}: {len(t)} of {m} tokens, "
                     f"{c.finish_reason}, ids in [{min(t)}, {max(t)}]")
        n_tok = sum(len(c.token_ids) for c in done)
        ttft = sorted(first_at[rid] - t0 for rid, _, _ in all_specs)
        print(f"serving [{label}]: {len(done)} requests, {n_tok} tokens in {wall:.2f} s = "
              f"{n_tok / wall:.1f} generated tokens/s (host clock); time to first token p50 "
              f"{np.percentile(ttft, 50):.3f} s, p90 {np.percentile(ttft, 90):.3f} s; "
              f"{eng._steps} decode steps; launches {counts}; in decode chunks "
              f"{dict(decode_counts)}", flush=True)
        sfx = F32 if f32 else ""
        if counts["flash_attention" + sfx] == 0:
            fail(f"serving [{label}]: prefills did not go through K1")
        k3 = decode_counts.get("flash_decode" + sfx, 0)
        k8 = decode_counts.get("paged_decode" + sfx, 0)
        if (eng.paged and (k8 == 0 or k3 != 0)) or (not eng.paged and (k3 == 0 or k8 != 0)):
            fail(f"serving [{label}]: decode chunks launched K3 {k3} and K8 {k8} times")
        for name in decode_kernels:
            if decode_counts.get(name, 0) == 0:
                fail(f"serving [{label}]: decode chunks never launched {name}")
        if n_embeds and counts["fused_norm_mean_pool" + sfx] == 0:
            fail(f"serving [{label}]: embeddings did not go through K2")
        out = {"rate": n_tok / wall, "ttft50": float(np.percentile(ttft, 50)), "peak": peak[0],
               "embs": embs, "verify": torch.cat(verify_emits).cpu() if verify_emits else None,
               "book": book, "tokens": {rid: c.token_ids for rid, c in by_id.items()}}
        if not check:
            return out
        if n_embeds:
            got = torch.from_numpy(np.stack([embs[rid] for rid, _, _ in embed_specs[:n_embeds]]))
            want = want_emb[:n_embeds]
            if book is not None:  # GritLM.encode with the pool's routes
                with book.pinning():
                    want = torch.from_numpy(model.encode(SENTENCES[:n_embeds],
                                                         instruction=INSTRUCTION))
                own = torch.nn.functional.cosine_similarity(got, want_emb[:n_embeds], dim=-1)
                print(f"serving [{label}]: pool embeddings against GritLM.encode with its own "
                      f"routes: min cosine {float(own.min()):.6f}")
            cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
            print(f"serving [{label}]: pool embeddings against GritLM.encode"
                  f"{' with the pool routes pinned' if book else ''}: min cosine "
                  f"{float(cos.min()):.6f}")
            if float(cos.min()) < 0.9999:
                fail(f"serving [{label}]: pool embeddings depart from GritLM.encode")
        # teacher forcing over the first 4 greedy requests and every
        # doc-continuation one (over document + prompt)
        forced = [(ids, rid) for rid, ids, _ in gen_specs
                  if req_kw.get(rid, {}).get("temperature", 0.0) == 0.0][:4]
        forced += [(doc + ids, rid) for rid, ids, _, _, doc in doc_specs]
        if book is not None:
            deficits = book.check(label, model, [(ids, rid, by_id[rid].token_ids)
                                                 for ids, rid in forced], eng.kv_quant)
        else:
            deficits = torch.cat([teacher_deficits(model, ids, by_id[rid].token_ids,
                                                   eng.kv_quant) for ids, rid in forced])
        print(f"serving [{label}]: teacher forcing over {len(deficits)} tokens of "
              f"{len(forced)} greedy requests{' (the engine routes pinned)' if book else ''}: "
              "largest deficit to the max logit "
              f"{float(deficits.max()):.4f} (tolerance {tie_tol}), engine token is the argmax at "
              f"{float((deficits == 0).float().mean()):.3f} of them", flush=True)
        if float(deficits.max()) > tie_tol:
            fail(f"serving [{label}]: an engine token is {float(deficits.max())} below its "
                 "position's max logit")
        return out

    return drive, specs


def teacher_deficits(model, ids, toks, quant=False, routes=None):
    """Teacher forcing through the kernels: one causal forward over prompt +
    the generated tokens (a cache of the given KV format); per generated
    position, how far the token sits below the position's largest logit
    (bf16 logits, as the engines' argmax). `routes`: a Routes context the
    forward runs in (a MoE trunk's routes recorded or pinned)."""
    import contextlib

    import torch

    from gritlm_tpu_torch.models.transformer import forward, init_cache, logits_from_hidden

    cfg, params, dev = model.config, model.params, model.device
    seq = list(ids) + list(toks)
    x = torch.tensor([seq], dtype=torch.int32, device=dev)
    with routes or contextlib.nullcontext(), torch.inference_mode():
        cache = init_cache(cfg, 1, len(seq), device=dev, quant=quant)
        hidden, _, _ = forward(params, cfg, x, causal=True, cache=cache)
        logits = logits_from_hidden(params, cfg, hidden[:, len(ids) - 1:len(seq) - 1])[0]
    logits = logits.float()
    chosen = logits.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0]
    return (logits.max(1).values - chosen).cpu()


def serving_phase(model, rag_eng, reset_counts, read_counts, path_launches):
    """The continuous-batching engine at full width: the serving workload
    (serving_workload) through ServingEngine(max_batch=8, max_len=4096,
    chunk_size=16) with a dense bf16 pool, a paged bf16 pool (page 256), a
    paged int8-KV pool, and a dense pool with prefill_chunk=256 (8 of the
    requests); then RAGEngine.serve of 4 queries, dense and paged, over the
    RAG phase's index. Launch counts are set to 0 before each run and read
    after it; their sum over the runs is the serving path's. Returns the
    dense bf16 pool's decode step at B = 8 (profile_decode_chunk), and the
    pools' generated tokens/s and TTFT p50 by pool."""
    import torch

    from gritlm_tpu_torch import serving
    from gritlm_tpu_torch.serving import ServingEngine

    cfg, tok, params, dev = model.config, model.tokenizer, model.params, model.device
    eos = tok.eos_token_id
    total = {}
    drive, specs = serving_workload(model, reset_counts, read_counts, total)

    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=eos, pad_id=tok.pad_token_id,
              device=dev)
    L, KD = cfg.num_hidden_layers, cfg.num_key_value_heads * cfg.head_dim_
    rates, ttfts = {}, {}
    eng = ServingEngine(cfg, params, **kw)
    dense_bytes = nbytes(eng.carry.cache.k, eng.carry.cache.v)
    run = drive("dense bf16", eng, specs, 8)
    rates["dense bf16"], ttfts["dense bf16"] = run["rate"], run["ttft50"]
    dense_step = profile_decode_chunk("dense bf16", eng, serving._decode_chunk_program, specs)
    del eng
    for label, quant in (("paged bf16", False), ("paged int8", True)):
        eng = ServingEngine(cfg, params, paged=True, page_size=256, kv_quant=quant, **kw)
        run = drive(label, eng, specs, 8)
        rates[label], ttfts[label], peak = run["rate"], run["ttft50"], run["peak"]
        page_bytes = 256 * L * KD * 2 * (1 if quant else 2) + (
            2 * L * cfg.num_key_value_heads * 256 * 2 if quant else 0)
        print(f"serving [{label}]: KV reserved at peak {peak} pages of 256 = "
              f"{peak * page_bytes / 2**30:.3f} GiB, against {dense_bytes / 2**30:.3f} GiB "
              f"for the dense pool (8 x 4096 slots, bf16)")
        if label == "paged bf16":
            profile_decode_chunk(label, eng, serving._decode_chunk_program, specs)
        del eng
    eng = ServingEngine(cfg, params, prefill_chunk=256, prompt_buckets=(256, 512, 1024, 2048),
                        **kw)
    run = drive("dense prefill_chunk 256", eng, specs[:8], 0)
    rates["dense chunked prefill 256"] = run["rate"]
    ttfts["dense chunked prefill 256"] = run["ttft50"]
    del eng
    torch.cuda.empty_cache()

    for paged in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        res = rag_eng.serve(SENTENCES[:4], paged=paged)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        label = "paged" if paged else "dense"
        print(f"serving [RAGEngine.serve {label}]: 4 queries in {dt:.2f} s, launches {counts}, "
              f"answer {res[0].answer!r}", flush=True)
        if [r.passages[0]["text"] for r in res] != SENTENCES[:4]:
            fail(f"RAGEngine.serve [{label}]: a query did not retrieve its own passage")
        decode_kernel = "paged_decode" if paged else "flash_decode"
        if counts["scores_segmax"] == 0 or counts[decode_kernel] == 0:
            fail(f"RAGEngine.serve [{label}]: search or decode skipped its kernel")
    path_launches["serving"] = total
    print(f"serving launches: {total}; generated tokens/s by pool: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    torch.cuda.empty_cache()
    return dense_step, rates, ttfts


SPEC_K = 7  # the verify chunk is Sq = SPEC_K + 1 (the engines' default spec_k)


def k3_verify(dev, randn, times, max_err, H=32, Hkv=8, Dh=128, name=K3_VERIFY,
              timed=True, atol=ATTN_ATOL) -> None:
    """K3 with per-row offsets at the dense verify chunk's shape: B 8, Sq 8,
    Mistral-7B heads, a 4096-slot pool with the rows of SERVING_LENS (a
    hole in row 1), causal with row b's query 0 at slot SERVING_LENS[b] - 8.
    Checks, bf16 and int8 caches, against the plain version (ATTN_ATOL);
    K3 against K8 on the same logical cache (the pool gathered dense),
    bit-equal, bf16 and int8; then both caches timed cold by CUDA graph
    replays (cold_decode_time: one device operation a call, or it fails)
    beside SDPA over the sliced cache with the same per-row causal boolean
    mask. The bf16 timing is the kernels line's row `name` ("K3 verify"
    by default) unless that row has its times; timed=False: the checks
    only. `randn` gives the dtype (fp32: the fp32 forms over fp32 and int8
    caches, held to `atol`, the bound at the fp32 FMA rate)."""
    import torch

    from gritlm_tpu_torch.models.transformer import quantize_kv
    from gritlm_tpu_torch.ops import decode_attention as da
    from gritlm_tpu_torch.ops import paged_attention as pa

    B, Sq = 8, SPEC_K + 1

    def as_int8(k_all, v_all):
        L, _, S, _ = k_all.shape
        k8, ks = quantize_kv(k_all.view(L * B, S, Hkv, Dh))
        v8, vs = quantize_kv(v_all.view(L * B, S, Hkv, Dh))
        return k8.view(L, B, S, -1), v8.view(L, B, S, -1), {
            "k_scale": ks.view(L, B, S, Hkv).transpose(2, 3).contiguous(),
            "v_scale": vs.view(L, B, S, Hkv).transpose(2, 3).contiguous()}

    # checks against the plain version, and K3 against K8, on 2 layers
    L = 2
    pt, mask, (k_pages, v_pages), (k8p, v8p), pscales = paged_pool(dev, randn, L, B, Hkv, Dh)
    keep, offs = k8_keep(mask, Sq)
    Smax = mask.shape[1]
    q = randn(B, Sq, H, Dh)
    dense = {False: (torch.stack([pa.gather_pages(k_pages, pt, i) for i in range(L)]),
                     torch.stack([pa.gather_pages(v_pages, pt, i) for i in range(L)]), {}),
             True: (torch.stack([pa.gather_pages(k8p, pt, i) for i in range(L)]),
                    torch.stack([pa.gather_pages(v8p, pt, i) for i in range(L)]),
                    {n: torch.stack([pa.gather_scales(sc, pt, i).transpose(1, 2)
                                     for i in range(L)]).contiguous()
                     for n, sc in pscales.items()})}
    for quant in (False, True):
        kd, vd, dsc = dense[quant]
        kw = dict(causal=True, offset=offs, layer=1, num_kv_heads=Hkv, **dsc)
        got = da.flash_decode(q, kd, vd, mask, **kw)
        torch.cuda.synchronize()
        if name.endswith(F32) and not torch.equal(got, da.flash_decode(q, kd, vd, mask, **kw)):
            fail(f"{name} [Sq{Sq} per-row offsets]: a rerun is not bit-equal")
        err = float((got.float() - da.flash_decode_plain(q, kd, vd, mask, **kw).float())
                    .abs().max())
        kp, vp = (k8p, v8p) if quant else (k_pages, v_pages)
        paged = pa.paged_decode(q, kp, vp, pt, mask, layer=1, num_kv_heads=Hkv, causal=True,
                                offset=offs, **(pscales if quant else {}))
        torch.cuda.synchronize()
        equal = torch.equal(paged, got)
        max_err[name] = max(max_err.get(name, 0.0), err)
        label = f"{'int8' if quant else dt_label(q)} Sq{Sq} B8 Smax{Smax} per-row offsets"
        print(f"check {name} [{label}]: max_abs_err {err:.3e} (atol {atol}); K8 on "
              f"the same logical cache bit-equal {equal}", flush=True)
        if err > atol or not torch.isfinite(got).all():
            fail(f"{name} [{label}] disagrees with its plain version: {err}")
        if not equal:
            fail(f"{name} [{label}]: K3 and K8 differ on the same logical cache")
    del k_pages, v_pages, k8p, v8p, pscales, dense
    torch.cuda.empty_cache()
    if not timed:
        return

    # cold timings, bf16 (the table's row) and int8
    slots = int(keep.any(1).sum())  # slots some query of the row sees: K/V to read
    es = q.element_size()
    for quant in (False, True):
        per_slot = Hkv * (Dh + 2) if quant else Hkv * Dh * es
        bms, by = bound(4.0 * int(keep.sum()) * H * Dh,
                        slots * per_slot * 2 + nbytes(mask, offs) + 2 * B * Sq * H * Dh * es,
                        peak_of(name))
        L = cold_copies(slots * per_slot * 2)
        k_all, v_all = randn(L, B, Smax, Hkv * Dh), randn(L, B, Smax, Hkv * Dh)
        scales = {}
        if quant:
            k_all, v_all, scales = as_int8(k_all, v_all)
        kw = dict(causal=True, offset=offs, num_kv_heads=Hkv, **scales)

        def call(layer, k_all=k_all, v_all=v_all, kw=kw):
            return da.flash_decode(q, k_all, v_all, mask, layer=layer, **kw)

        def plain(layer, k_all=k_all, v_all=v_all, kw=kw):
            return da.flash_decode_plain(q, k_all, v_all, mask, layer=layer, **kw)

        views = None  # no single PyTorch call computes the int8 variant
        if not quant:
            hi = int(keep.any(1).any(0).nonzero().max()) + 1
            views = [(k_all[layer, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2),
                      v_all[layer, :, :hi].view(B, hi, Hkv, Dh).transpose(1, 2))
                     for layer in range(L)]
        cold_decode_time(name, f"{'int8' if quant else dt_label(q)} Sq{Sq} B8 Smax{Smax} "
                         f"per-row offsets, {slots} slots seen", call, plain, L, q, keep, views,
                         bms, by, times, "the sliced cache, per-row causal boolean mask", atol)
        del k_all, v_all, scales, views
        torch.cuda.empty_cache()


def spec_generate(model, total) -> None:
    """Lockstep speculative generate (GritLM.generate_from_ids(speculative=
    True), spec_k 7, ngram 3) at B = 1 and 2 on prompts that quote a passage,
    16 new tokens (64 before phase 19, 32 before phase 20; the time limit):
    every token within
    TIE_TOL of its position's largest
    logit (teacher forcing); the verify steps, tokens a verify forward, and
    ms per token on the host and device clocks beside the plain greedy
    generate on the same prompts. Launch counts of the speculative runs are
    added to `total`."""
    import torch

    from gritlm_tpu_torch.ops import decode_attention

    tok = model.tokenizer
    passage = " ".join(SENTENCES[:6])
    prompts = [f"<s><|user|>\nQuote this passage: {passage}\n<|assistant|>\n{SENTENCES[0]}",
               f"<s><|user|>\nRepeat after me: {passage} {passage}\n<|assistant|>\n"
               f"{SENTENCES[1]}"]
    n = 16
    for B in (1, 2):
        enc = tok(prompts[:B])

        def run(spec):
            return model.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                           max_new_tokens=n, speculative=spec)

        before = decode_attention.flash_decode.launches
        res = run(True)
        torch.cuda.synchronize()
        total["flash_decode"] = total.get("flash_decode", 0) + (
            decode_attention.flash_decode.launches - before)
        gaps = torch.cat([teacher_deficits(
            model, enc["input_ids"][b, :int(enc["attention_mask"][b].sum())].tolist(),
            res.tokens[b, :int(res.num_valid[b])].tolist()) for b in range(B)])
        if float(gaps.max()) > TIE_TOL:
            fail(f"speculative generate B={B}: a token is {float(gaps.max())} below its "
                 "position's max logit")
        clocks = {}
        for spec in (False, True):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(spec)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3
            # device ms a token: two short profiler windows (1 and 9 new
            # tokens), their difference over 8 tokens, so the prefill drops
            # out and the traces stay small (their processing on the host
            # grows with the kernels traced)
            short, full = (profile_window(
                f"generate B={B} {m} tokens, speculative {spec}",
                lambda spec=spec, m=m: model.generate_from_ids(
                    enc["input_ids"], enc["attention_mask"], max_new_tokens=m,
                    speculative=spec), top=0) for m in (1, 9))
            device = None if short is None or full is None else (full[1] - short[1]) / 8
            clocks[spec] = (host / n, device)
        nv = res.num_valid.tolist()
        steps = res.spec_steps
        fmt = lambda v: "not measured" if v is None else f"{v:.2f}"  # noqa: E731
        print(f"speculative generate [B={B}, {n} new tokens, prompt of "
              f"{enc['input_ids'].shape[1]} tokens]: {nv} tokens in {steps} verify steps = "
              f"{(sum(nv) - B) / max(steps, 1):.3f} tokens a verify forward "
              f"({(sum(nv) - B) / max(steps, 1) / B:.3f} a row); teacher forcing: largest "
              f"deficit {float(gaps.max()):.4f} (TIE_TOL {TIE_TOL}); ms per token host / device: "
              f"speculative {fmt(clocks[True][0])} / {fmt(clocks[True][1])}, plain greedy "
              f"{fmt(clocks[False][0])} / {fmt(clocks[False][1])}", flush=True)


def doc_requests(model, n_docs=4, max_new=48):
    """Doc-continuation requests for the speculative pools: each document
    (the sentences, rotated, about 320 tokens) prefilled causally into a
    doc-store entry (CPU tensors), a prompt asking to quote it, and the
    document's tokens as the request's lookup corpus. Returns [(rid, prompt
    ids, max new, entry, doc ids)]."""
    import torch

    from gritlm_tpu_torch.models.transformer import forward, init_cache

    cfg, tok = model.config, model.tokenizer
    prompt = tok._encode_one("\n<|user|>\nQuote the passage above.\n<|assistant|>\n", False)
    out = []
    for i in range(n_docs):
        doc = tok._encode_one(" ".join(SENTENCES[i:] + SENTENCES[:i]), True)
        with torch.inference_mode():
            cache = init_cache(cfg, 1, len(doc), device=model.device)
            forward(model.params, cfg, torch.tensor([doc], device=model.device), causal=True,
                    cache=cache)
        entry = (cache.k[:, 0].cpu(), cache.v[:, 0].cpu(), len(doc), None, None)
        out.append((f"d{i}", list(prompt), max_new, entry, doc))
    return out


def tokens_a_verify(run) -> float:
    """Tokens a row's verify emitted on average over a speculative run's
    verify chunks (every active row emits at least one)."""
    emits = run["verify"]
    return float(emits.sum()) / max(int((emits > 0).sum()), 1)


def run_steps(run) -> int:
    """Verify steps a speculative run's chunks took."""
    return int(run["verify"].shape[0])


def spec_phase(model, randn, reset_counts, read_counts, path_launches, times, max_err,
               greedy_rates) -> None:
    """Phase 12, speculative decoding and serving sampling at full width:
    K3 with per-row offsets (k3_verify); lockstep speculative generate
    (spec_generate); the serving workload cut to its first 8 generation
    requests (phase 7's 8-request cut) with 4 doc-continuation requests
    through speculative pools (spec_k 7, ngram 3),
    dense and paged (counts set to 0 before each run, read after): every
    request complete, tokens within TIE_TOL, tokens a verify, device ms per
    verify step at B = 8, tokens/s beside phase 7's greedy pools; the 8
    again on the dense pool with each one's own greedy continuation in its
    lookup corpus (a replay: the most a verify can accept); and the 8
    requests mixed greedy / T 0.7 top_p 0.9 / T 1.0 top_k 50 through a
    sampling pool, dense and paged: every request complete, greedy rows
    within TIE_TOL, the sampled streams equal between the two pools, and
    (printed, not gated) the share of tokens 4 sampled requests run alone
    share with themselves in the full pool."""
    import torch

    from gritlm_tpu_torch import serving
    from gritlm_tpu_torch.serving import Request, ServingEngine

    t_phase = time.time()
    k3_verify(model.device, randn, times, max_err)
    total = {}
    print(f"phase 12: K3 verify {time.time() - t_phase:.0f} s", flush=True)
    spec_generate(model, total)
    print(f"phase 12: lockstep speculative generate, at {time.time() - t_phase:.0f} s",
          flush=True)

    cfg, tok, params, dev = model.config, model.tokenizer, model.params, model.device
    drive, specs = serving_workload(model, reset_counts, read_counts, total)
    specs = specs[:8]  # phase 7's 8-request cut: the script's time budget (phase 16)
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=dev)
    docs = doc_requests(model)
    for paged in (False, True):
        label = f"speculative {'paged' if paged else 'dense'}"
        pool = dict(paged=True, page_size=256) if paged else {}
        eng = ServingEngine(cfg, params, speculative=True, spec_k=SPEC_K, spec_ngram=3,
                            **pool, **kw)
        run = drive(label, eng, specs, 0, decode_kernels=() if paged else (K3_VERIFY,),
                    doc_specs=docs)
        step = profile_decode_chunk(label, eng, serving._spec_chunk_program, specs)
        greedy = greedy_rates["paged bf16" if paged else "dense bf16"]
        print(f"serving [{label}]: {tokens_a_verify(run):.3f} tokens a row's verify; verify "
              f"step at B=8: " + ("not measured" if step is None else
                                  f"{step[0]:.3f} device ms, {step[1]:.3f} host ms, idle share "
                                  f"{step[2]:.3f}")
              + f"; {run['rate']:.1f} generated tokens/s (host clock) against the greedy "
              f"pool's {greedy:.1f} (phase 7)", flush=True)
        del eng
        if not paged:
            # the same 24 requests again, each with its own greedy continuation
            # (from the run above) after its prompt in its lookup corpus: the
            # most a verify can accept, on the same pool and kernels
            replay = {rid: dict(hist_ids=list(ids) + run["tokens"][rid]) for rid, ids, _ in specs}
            eng = ServingEngine(cfg, params, speculative=True, spec_k=SPEC_K, spec_ngram=3, **kw)
            rerun = drive("speculative dense, replay", eng, specs, 0,
                          decode_kernels=(K3_VERIFY,), req_kw=replay)
            same = sum(rerun["tokens"][rid] == run["tokens"][rid] for rid, _, _ in specs)
            print(f"serving [speculative dense, replay]: {tokens_a_verify(rerun):.3f} tokens a "
                  f"row's verify, {run_steps(rerun)} verify steps against {run_steps(run)}; "
                  f"{rerun['rate']:.1f} generated tokens/s (host clock); {same} of {len(specs)} "
                  "streams equal to the first run's", flush=True)
            del eng

    print(f"phase 12: speculative pools, at {time.time() - t_phase:.0f} s", flush=True)
    req_kw = {}
    for i, (rid, _, _) in enumerate(specs):  # greedy / T 0.7 top_p 0.9 / T 1.0 top_k 50
        if i % 3 == 1:
            req_kw[rid] = dict(temperature=0.7, top_p=0.9, seed=i)
        elif i % 3 == 2:
            req_kw[rid] = dict(temperature=1.0, top_k=50, seed=i)
    # both pools on the paged pool's prompt buckets (multiples of its page),
    # so they prefill the same groups at the same shapes: with K3 and K8
    # bit-equal on the same logical cache, their logits are the same
    streams, buckets = {}, (256, 512, 1024, 2048)
    for paged in (False, True):
        label = f"sampling {'paged' if paged else 'dense'}"
        pool = dict(paged=True, page_size=256) if paged else {}
        eng = ServingEngine(cfg, params, sampling=True, prompt_buckets=buckets, **pool, **kw)
        run = drive(label, eng, specs, 0, req_kw=req_kw)
        streams[paged] = run["tokens"]
        if not paged:
            step = profile_decode_chunk(label, eng, serving._decode_chunk_program, specs)
            print(f"serving [{label}]: decode step at B=8 with the sampler: "
                  + ("not measured" if step is None else
                     f"{step[0]:.3f} device ms, {step[1]:.3f} host ms, idle share "
                     f"{step[2]:.3f}") + f"; {run['rate']:.1f} generated tokens/s (host clock)",
                  flush=True)
        del eng
    differ = sorted(rid for rid in streams[False] if streams[False][rid] != streams[True][rid])
    print(f"phase 12: sampling pools, at {time.time() - t_phase:.0f} s", flush=True)
    print(f"serving [sampling]: dense and paged pools give equal streams for "
          f"{len(specs) - len(differ)} of {len(specs)} requests", flush=True)
    if differ:
        fail(f"serving [sampling]: dense and paged streams differ for {differ}")
    same = tot = 0
    for rid, ids, m in [sp for sp in specs if sp[0] in req_kw][:4]:
        eng = ServingEngine(cfg, params, sampling=True, prompt_buckets=buckets, **kw)
        (alone,) = eng.run([Request(input_ids=ids, max_new_tokens=m, request_id=rid,
                                    **req_kw[rid])])
        full = streams[False][rid]
        same += sum(a == b for a, b in zip(alone.token_ids, full))
        tot += max(len(alone.token_ids), len(full))
        del eng
    print(f"serving [sampling]: 4 sampled requests run alone share {same} of {tot} token "
          f"positions ({same / max(tot, 1):.3f}) with themselves in the full pool (not gated: "
          f"the B = 1 prefill's GEMMs may round otherwise)", flush=True)
    path_launches["speculative and sampling"] = total
    if total.get(K3_VERIFY, 0) == 0 or total.get("paged_decode", 0) == 0:
        fail("the speculative pools did not go through K3 with per-row offsets and K8")
    print(f"speculative and sampling launches: {total}; phase {time.time() - t_phase:.0f} s",
          flush=True)
    torch.cuda.empty_cache()


def profile_decode_chunk(label, eng, chunk_program, specs, adapters=(None,) * 8, steps=8):
    """Device time of one decode chunk of `steps` steps (a speculative
    engine's: verify steps) with all 8 slots active (fresh requests of 64
    new tokens on the engine's pool, row i on `adapters[i]`): returns
    (device ms per step at B = 8, host ms per step, the chunk's idle share),
    or None for an empty trace. The window's trace is processed on the host
    in time that grows with its kernels (three 16-step adapter windows took
    96 s), so the default is 8 steps (16 before the time budget of phase
    16). The chunk runs outside the scheduler, so
    the engine is spent afterwards."""
    import torch

    from gritlm_tpu_torch.serving import Request

    for (rid, ids, _), a in zip(specs[:8], adapters):
        eng.submit(Request(input_ids=ids[:200], max_new_tokens=64, request_id=f"p{rid}",
                           adapter=a))
    eng.step()  # admits all eight and dispatches a first chunk
    torch.cuda.synchronize()
    if int(eng.carry.active.sum()) != 8:
        fail(f"profile [{label}]: {int(eng.carry.active.sum())} of 8 rows active")
    kw = (dict(ngram=eng.spec_ngram, k=eng.spec_k) if eng.speculative
          else dict(sample=eng.sampling))
    prof = profile_window(f"{label} decode chunk, B=8, {steps} steps", lambda: chunk_program(
        eng.params, eng.cfg, eng.carry, steps=steps, eos_id=eng.eos_id, pad_id=eng.pad_id,
        **kw))
    if prof is None:
        return None
    wall_ms, busy_ms = prof
    print(f"serving [{label}]: decode at B=8: {busy_ms / steps:.3f} device ms per step, "
          f"{wall_ms / steps:.3f} ms per step (host clock), idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    return busy_ms / steps, wall_ms / steps, max(0.0, 1 - busy_ms / wall_ms)


# Phase 14: per-request LoRA adapters at Mistral-7B width and the remat
# policies. The adapters are drawn at the reference's LoRA settings (r 16,
# alpha 64 on q/k/v/o/gate/up/down): A from init_lora's seeded draw (N(0,
# 0.02)), B nonzero, N(0, ADAPTER_B_STD), from a generator seeded per
# adapter, so that each adapter moves the model (init_lora's B = 0 would
# not): with r 16 and scale 4 the delta's rows are about 16 * 4 * 0.02 *
# ADAPTER_B_STD of a unit input, 13% of the base projection's (0.02 * 64).
ADAPTERS = ("a", "b", "c", "d")
ADAPTER_B_STD = 0.01
LORA_R, LORA_ALPHA = 16, 64
# The adapter branch's product (xW + (xA)B, the delta rounded to bf16 before
# the add, as the JAX package's) against x W' with W' = bf16(W + AB), the
# merged weight, and against the exact fp32 x (W + AB): relative Frobenius
# error, the JAX package's bound for its bf16 matmul kernels (QUANT_RTOL).
ADAPTER_RTOL = 5e-3
# Teacher forcing of an adapter pool's tokens through the pool's own math
# (the stacked params with the request's adapter id): the delta's rounding
# and the add's are rounding stages the base path does not have, as the int8
# cache is, so the int8 cache's tolerance. Against the merged weights the
# deficits are printed: their weight rounding (every element of W' up to half
# a bf16 step off W + AB) moves the logits of this random 32-layer model by
# far more than the kernels' summation order does (PERF.md, PR 15).
ADAPTER_TIE_TOL = INT8_KV_TIE_TOL
# the remat policies' LoRA step: phase 10's batch at depth 4 (under "dots"
# a layer keeps its seven projections' outputs, 43,008 bf16 values a token,
# 2.2 GB at 25,600 tokens, and the lazy LoRA weight's fp32 A @ B, 0.87 GB:
# about 98 GB at 32 layers, which the 80 GB card cannot hold; 8 layers fit,
# 2 keep the script inside its time limit beside phases 19 and 20)
REMAT_DEPTH = 2
REMAT_POLICIES = (None, "dots", "dots_no_batch")
REMAT_RTOL = 1e-3  # the bound above which a policy's step departs from the full recompute's


def draw_adapters(params, names, seed0=0):
    """LoRA trees for `names` at r LORA_R, alpha LORA_ALPHA: A from
    init_lora's draw seeded seed0 + i, B ~ N(0, ADAPTER_B_STD) from a
    generator seeded 1000 + seed0 + i. Returns ({name: tree}, scale)."""
    import torch

    from gritlm_tpu_torch.training.lora import init_lora

    out, scale = {}, None
    for i, name in enumerate(names):
        tree, scale = init_lora(params, seed0 + i, r=LORA_R, alpha=LORA_ALPHA)
        dev = tree["layers"]["attn"]["wq"]["B"].device
        gen = torch.Generator(device=dev).manual_seed(1000 + seed0 + i)
        for group in tree["layers"].values():
            for node in group.values():
                node["B"].normal_(0.0, ADAPTER_B_STD, generator=gen)
        out[name] = tree
    return out, scale


def stack_bytes(params) -> int:
    """Bytes of the stacked adapter factors (As, Bs) in a served tree."""
    if isinstance(params, dict):
        own = sum(nbytes(params[k]) for k in ("As", "Bs") if k in params)
        return own + sum(stack_bytes(v) for k, v in params.items()
                         if k not in ("As", "Bs") and isinstance(v, dict))
    return 0


def adapter_projection_error(stacked, merged, tree, scale, slot, rows=8, seq=16) -> float:
    """The adapter branch of `_mm` on the served (stacked) tree against the
    merged weight's product, for every targeted leaf at the first and the
    last layer: x [rows, seq, in] drawn from a seeded generator, every row
    on adapter `slot`. Returns the largest relative Frobenius errors of the
    branch against the merged weight's product and against the exact fp32
    product x (W + scale A B); the merged weight's own against the exact one
    is printed beside."""
    import torch

    from gritlm_tpu_torch.models.transformer import _mm

    layers = stacked["layers"]
    dev = layers["attn"]["wq"]["As"].device
    gen = torch.Generator(device=dev).manual_seed(slot)
    aid = torch.full((rows,), slot, device=dev)
    worst, worst_exact = 0.0, [0.0, 0.0]
    for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
        for name in names:
            node, m = layers[group][name], merged["layers"][group][name]
            ab = tree["layers"][group][name]
            for i in (0, m.shape[0] - 1):
                x = torch.randn((rows, seq, m.shape[1]), generator=gen, device=dev).to(m.dtype)
                with torch.inference_mode():
                    got = _mm(x, {"w": node["w"][i], "As": node["As"][i], "Bs": node["Bs"][i],
                                  "aid": aid}).float()
                    want = (x @ m[i]).float()
                    exact = x.float() @ (node["w"][i].float()
                                         + scale * (ab["A"][i].float() @ ab["B"][i].float()))
                rel = float((got - want).norm() / want.norm())
                worst = max(worst, rel)
                worst_exact[0] = max(worst_exact[0], float((got - exact).norm() / exact.norm()))
                worst_exact[1] = max(worst_exact[1], float((want - exact).norm() / exact.norm()))
    print(f"adapters [projections, adapter slot {slot}]: the branch against x W' (W' the merged "
          f"bf16 weight) up to {worst:.2e}; against the exact fp32 x (W + AB): the branch "
          f"{worst_exact[0]:.2e}, x W' {worst_exact[1]:.2e}", flush=True)
    return worst, worst_exact[0]


def adapter_phase(model, reset_counts, read_counts, path_launches, greedy_rates,
                  greedy_ttfts) -> None:
    """Per-request LoRA serving at full width (counts set to 0 before each
    pool and read after): four adapters "a"-"d" (draw_adapters); phase 7's
    first 8 generation requests (its 8-request cut, for the time limit) on
    adapters round-robin over None, a, b, c, d and its 8 embedding requests,
    every second one on an adapter, through dense, paged (page 256) and
    speculative (spec_k 7) pools, and the 8 through a chunked-prefill (256)
    pool: every request complete; each generated token within
    ADAPTER_TIE_TOL of its position's largest logit in a teacher-forced
    forward through the pool's own math (the served tree with the
    request's adapter id), and its deficit over the adapter merged into the
    base printed for the dense pool (one merged copy at a time); the
    adapter branch's product
    against the merged weight's at every targeted leaf within ADAPTER_RTOL
    (adapter_projection_error); each pool embedding at cosine >=
    COSINE_MIN to GritLM.encode through the pool's math and on the merged
    weights; each adapter moving some request off the base's
    tokens (above TIE_TOL under the base); K1, K2 and K3 or K8 launched.
    Then the int8 base (GritLM(weight_quant=8)'s params) with the four
    adapters, a dense pool of 8 requests (K6 in its decode chunks),
    teacher-forced the same way (against `merge`, which dequantizes the
    base first: printed). Then the decode step at B = 8 with
    every row on its own adapter (eight adapters) against the same pool with
    none, and one adapter decode chunk, dense and paged, under
    set_sync_debug_mode("error")."""
    import types

    import torch

    from gritlm_tpu_torch import GritLM, serving
    from gritlm_tpu_torch.models.transformer import count_params
    from gritlm_tpu_torch.serving import ServingEngine
    from gritlm_tpu_torch.models.transformer import forward, logits_from_hidden
    from gritlm_tpu_torch.training.lora import merge, set_adapter_ids
    from gritlm_tpu_torch.training.quant import dequantize_tree

    t_phase = time.time()
    gc.collect()  # the earlier phases' engines (reference cycles) and their pools
    torch.cuda.empty_cache()
    print(f"phase 14: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated at its start",
          flush=True)
    cfg, tok, params, dev = model.config, model.tokenizer, model.params, model.device
    total = {}
    drive, specs = serving_workload(model, reset_counts, read_counts, total)
    adapters, scale = draw_adapters(params, ADAPTERS)
    n_ad = count_params(adapters["a"])
    cycle = (None,) + ADAPTERS
    gen_ad = {rid: cycle[i % len(cycle)] for i, (rid, _, _) in enumerate(specs)}
    emb_ad = {f"e{i}": ADAPTERS[i // 2] if i % 2 else None for i in range(8)}
    req_kw = {rid: {"adapter": a} for rid, a in gen_ad.items()}
    embed_kw = {rid: {"adapter": a} for rid, a in emb_ad.items()}
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=dev, adapters=adapters, lora_scale=scale)
    # (label, engine keywords, generation requests, embedding requests): every
    # pool takes phase 7's cut (its first 8 generation requests: the script's
    # time limit), the chunked-prefill pool no embeddings
    specs = specs[:8]
    pools = (("dense", {}, 8, 8), ("paged", dict(paged=True, page_size=256), 8, 8),
             ("chunked prefill 256", dict(prefill_chunk=256,
                                          prompt_buckets=(256, 512, 1024, 2048)), 8, 0),
             ("speculative", dict(speculative=True, spec_k=SPEC_K), 8, 8))
    runs = {}
    for label, extra, n_gen, n_emb in pools:
        eng = ServingEngine(cfg, params, **kw, **extra)
        if label == "dense":
            stacked = eng.params  # the served tree: the base with the adapters stacked
            print(f"adapters: {len(ADAPTERS)} of {n_ad:,} parameters ({n_ad * 2 / 1e6:.1f} MB "
                  f"in bf16; r {LORA_R}, alpha {LORA_ALPHA}, B ~ N(0, {ADAPTER_B_STD})); the "
                  f"stack with the zero slot {stack_bytes(stacked) / 1e6:.1f} MB", flush=True)
        runs[label] = drive(f"adapters {label}", eng, specs[:n_gen], n_emb, req_kw=req_kw,
                            embed_kw=embed_kw, check=False)
        del eng
        gc.collect()  # the engine's on_token closure holds it in a cycle with its pool
    torch.cuda.empty_cache()
    print(f"phase 14: four adapter pools, at {time.time() - t_phase:.0f} s", flush=True)

    def own(tree, a, n):
        """The pool's math for n rows on adapter a: the stacked tree with
        their id grafted."""
        ids = torch.full((n,), 0 if a is None else ADAPTERS.index(a) + 1, device=dev)
        return set_adapter_ids(tree, ids, cfg.num_hidden_layers)

    worst = worst_m = proj = 0.0
    above_m = n_forced = n_merged = 0
    cos_own = cos_m = 1.0
    moved, own_by, merged_by, logit_gap = {}, {}, {}, {}
    for a in cycle:
        merged = params if a is None else merge(params, adapters[a], scale)
        oracles = {"own": types.SimpleNamespace(config=cfg, params=own(stacked, a, 1), device=dev),
                   "merged": types.SimpleNamespace(config=cfg, params=merged, device=dev)}
        for label, run in runs.items():
            # the merged weights' figures on the dense pool's tokens (printed)
            d = {k: torch.cat([teacher_deficits(o, ids, run["tokens"][rid])
                               for rid, ids, _ in specs if gen_ad[rid] == a
                               and rid in run["tokens"]])
                 for k, o in oracles.items() if k == "own" or label == "dense"}
            worst = max(worst, float(d["own"].max()))
            own_by[a] = max(own_by.get(a, 0.0), round(float(d["own"].max()), 4))
            n_forced += len(d["own"])
            if "merged" in d:
                worst_m = max(worst_m, float(d["merged"].max()))
                merged_by[a] = round(float(d["merged"].max()), 4)
                above_m += int((d["merged"] > TIE_TOL).sum())
                n_merged += len(d["merged"])
            if float(d["own"].max()) > ADAPTER_TIE_TOL:
                fail(f"adapters [{label}] adapter {a}: a pool token is {float(d['own'].max())} "
                     "below its position's max logit under the pool's own math")
        emb_ids = [i for i in range(8) if emb_ad[f"e{i}"] == a]
        for k, tree in (("own", own(stacked, a, len(emb_ids))), ("merged", merged)):
            enc = GritLM(cfg, params=tree, tokenizer=tok, embed_eos=model.embed_eos, device=dev)
            want = torch.from_numpy(enc.encode([SENTENCES[i] for i in emb_ids],
                                               instruction=INSTRUCTION))
            for label, run in runs.items():
                if not run["embs"]:
                    continue
                got = torch.from_numpy(np.stack([run["embs"][f"e{i}"] for i in emb_ids]))
                cos = float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min())
                if k == "merged":
                    cos_m = min(cos_m, cos)
                else:
                    cos_own = min(cos_own, cos)
                if cos < COSINE_MIN:
                    fail(f"adapters [{label}] adapter {a}: pool embedding at cosine {cos} to "
                         f"GritLM.encode ({k} weights)")
        if a is not None:
            proj = max(proj, *adapter_projection_error(stacked, merged, adapters[a], scale,
                                                       ADAPTERS.index(a) + 1))
            # how far the merged weights' rounding moves this model's logits:
            # one prompt's forward through both
            ids = next(ids for rid, ids, _ in specs if gen_ad[rid] == a)
            x = torch.tensor([ids], dtype=torch.int32, device=dev)
            with torch.inference_mode():
                lo, lm = (logits_from_hidden(o.params, cfg, forward(o.params, cfg, x)[0]).float()
                          for o in (oracles["own"], oracles["merged"]))
            logit_gap[a] = (round(float((lo - lm).abs().mean()), 4),
                            round(float((lo - lm).abs().max()), 4), round(float(lm.std()), 4))
            # the guard: the adapter moves some request off the base
            moved[a] = sum(float(teacher_deficits(model, ids, runs["dense"]["tokens"][rid]).max())
                           > TIE_TOL for rid, ids, _ in specs if gen_ad[rid] == a)
        del merged, oracles, enc
        torch.cuda.empty_cache()
    print(f"adapters: teacher forcing over the {n_forced} tokens of the four pools: largest "
          f"deficit through the pool's own math {worst:.4f} (ADAPTER_TIE_TOL {ADAPTER_TIE_TOL}); "
          f"through the merged weights (the dense pool's {n_merged} tokens) {worst_m:.4f}, "
          f"{above_m} above TIE_TOL {TIE_TOL} (printed, not gated); at "
          f"{time.time() - t_phase:.0f} s; each projection of the adapter branch against the "
          f"merged weight's and the exact fp32 product: relative error up to {proj:.2e} "
          f"(ADAPTER_RTOL {ADAPTER_RTOL}); pool embeddings (3 pools x 8) against GritLM.encode: "
          f"min cosine {cos_own:.6f} through the pool's math, {cos_m:.6f} on the merged weights "
          f"(COSINE_MIN {COSINE_MIN}); requests each adapter moved off the base (a dense-pool "
          f"token above TIE_TOL under the base): {moved}", flush=True)
    print(f"adapters: largest deficit by adapter through the pool's own math {own_by}, through "
          f"the merged weights (dense pool) {merged_by}; one prompt's logits through the pool's "
          f"math against the merged weights (mean abs, max abs, the logits' std): {logit_gap}",
          flush=True)
    if proj > ADAPTER_RTOL:
        fail(f"adapters: the adapter branch departs from the merged weights: {proj}")
    if not all(moved.values()):
        fail(f"adapters: an adapter changed no request's tokens against the base: {moved}")
    print("adapters: generated tokens/s and TTFT p50 by pool (phase 7's pools without "
          "adapters beside): " + "; ".join(
              f"{label} {run['rate']:.1f} tok/s, {run['ttft50']:.3f} s" for label, run in
              runs.items()) + " | phase 7: " + "; ".join(
              f"{label} {greedy_rates[label]:.1f} tok/s, {greedy_ttfts[label]:.3f} s"
              for label in greedy_rates), flush=True)
    del stacked

    # ---- the int8 base with the same adapters (K6 in the decode chunks)
    wq = GritLM(cfg, params=params, tokenizer=tok, weight_quant=8, device=dev)
    eng = ServingEngine(cfg, wq.params, **kw)
    run = drive("adapters dense, int8 weights", eng, specs[:8], 0,
                decode_kernels=("w8a16_matmul",), req_kw=req_kw, check=False)
    stacked = eng.params
    del eng
    gc.collect()  # the engine's on_token closure holds it in a cycle with its pool
    worst = worst_m = 0.0
    for a in cycle:
        merged = dequantize_tree(wq.params) if a is None else merge(wq.params, adapters[a],
                                                                     scale)
        for rid, ids, _ in specs[:8]:
            if gen_ad[rid] == a:
                toks = run["tokens"][rid]
                worst = max(worst, float(teacher_deficits(types.SimpleNamespace(
                    config=cfg, params=own(stacked, a, 1), device=dev), ids, toks).max()))
                worst_m = max(worst_m, float(teacher_deficits(types.SimpleNamespace(
                    config=cfg, params=merged, device=dev), ids, toks).max()))
        del merged
        torch.cuda.empty_cache()
    print(f"adapters [int8 weights]: teacher forcing of 8 requests: largest deficit through the "
          f"pool's own math (K6 and the adapters) {worst:.4f} (ADAPTER_TIE_TOL "
          f"{ADAPTER_TIE_TOL}); against merge over the dequantized base {worst_m:.4f} (printed); "
          f"at {time.time() - t_phase:.0f} s", flush=True)
    if worst > ADAPTER_TIE_TOL:
        fail(f"adapters [int8 weights]: a pool token is {worst} below its position's max logit")
    del wq, stacked
    path_launches["adapters"] = total
    torch.cuda.empty_cache()

    # ---- the decode step with every row on its own adapter, and no host sync
    more, _ = draw_adapters(params, ("e", "f", "g", "h"), seed0=len(ADAPTERS))
    eight = {**adapters, **more}
    steps = {}
    for label, extra in (("dense, 8 adapters", dict(adapters=eight)), ("dense, no adapters", {}),
                         ("paged, 8 adapters", dict(adapters=eight, paged=True, page_size=256))):
        eng = ServingEngine(cfg, params, **{**kw, "adapters": None, **extra})
        # a 4-step window: with 16-step windows (an adapter step launches
        # about 2,500 kernels, all traced) these three took 96 s of the phase
        steps[label] = profile_decode_chunk(
            label, eng, serving._decode_chunk_program, specs,
            adapters=tuple(eight) if "adapters" in extra else (None,) * 8, steps=4)
        if "adapters" in extra:
            if sorted(eng.carry.aid.tolist()) != list(range(1, 9)):
                fail(f"adapters [{label}]: pool rows on adapters {eng.carry.aid.tolist()}")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                serving._decode_chunk_program(eng.params, eng.cfg, eng.carry, steps=4,
                                              eos_id=eng.eos_id, pad_id=eng.pad_id)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            print(f"adapters [{label}]: a decode chunk (4 steps, every row on its own adapter) "
                  "ran with set_sync_debug_mode('error'): no host sync", flush=True)
        del eng
        gc.collect()  # the engine's on_token closure holds it in a cycle with its pool
    print(f"phase 14: the decode steps, at {time.time() - t_phase:.0f} s", flush=True)
    a8, b8 = steps["dense, 8 adapters"], steps["dense, no adapters"]
    if a8 and b8:
        print(f"adapters: decode step at B = 8, every row on its own adapter, against no "
              f"adapters: device {a8[0]:.3f} / {b8[0]:.3f} ms ({a8[0] / b8[0]:.3f}x), host "
              f"{a8[1]:.3f} / {b8[1]:.3f} ms ({a8[1] / b8[1]:.3f}x), idle share {a8[2]:.3f} / "
              f"{b8[2]:.3f}", flush=True)
    torch.cuda.empty_cache()
    print(f"adapter launches: {total}; phase 14 adapters {time.time() - t_phase:.0f} s",
          flush=True)


def remat_phase(dev, reset_counts, read_counts, path_launches, preset="mistral_7b",
                lengths=(256, 2048, 2048), depths=(REMAT_DEPTH, 4)) -> None:
    """The remat policies on phase 10's LoRA step (its synthetic batch: 4 x
    group 2 at query 256 / passage 2048 / generative 2048 tokens) at depth
    REMAT_DEPTH (`depths`), counts set to 0 before and read after: 3 steps from the
    same seed under each of REMAT_POLICIES, ms a step (median of steps 2-3)
    and peak GiB, every step's loss and the adapters after step 3 against
    the full recompute's (bit-equal expected: the recompute runs the same
    kernels on the same inputs; the largest difference is printed and fails
    above REMAT_RTOL), K1 launched twice for each K4 launch (the recompute
    relaunches it under every policy); then `training.run
    --model_name_or_path <a depth-4 checkpoint> --lora --remat_policy dots`,
    2 steps with finite losses."""
    import dataclasses
    import shutil

    import torch

    from gritlm_tpu_torch import config as cfgmod
    from gritlm_tpu_torch.models.loader import save_checkpoint
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.training import run as run_mod
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig, leaves

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke_remat"
    shutil.rmtree(work, ignore_errors=True)
    synthetic_train_data(work / "data")
    cfg = dataclasses.replace(getattr(cfgmod, preset)(), num_hidden_layers=depths[0])
    qlen, plen, glen = lengths
    reset_counts()
    try:
        batch, _, padded = first_batch(work, lengths)
        base = init_params(cfg, 5, device=dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        runs = {}
        for policy in REMAT_POLICIES:
            tc = TrainConfig(learning_rate=1e-4, total_steps=6, remat_policy=policy)
            run_step, state, _, _ = make_lora_train_state(cfg, tc, base, seed=0, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = read_counts()
            losses, step_s = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run_step(state, batch)
                losses.append(m.loss.detach().clone())
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            after = read_counts()
            peak = torch.cuda.max_memory_allocated()
            k1 = after["flash_attention"] - before["flash_attention"]
            k4 = after["flash_attention_bwd_dq"] - before["flash_attention_bwd_dq"]
            runs[policy] = (torch.stack(losses), [t.detach().clone() for t in leaves(state.params)])
            print(f"remat [{policy}, LoRA, {depths[0]} layers, {padded} tokens a step]: losses "
                  f"{', '.join(f'{float(x):.6f}' for x in losses)}; "
                  f"{statistics.median(step_s[1:]) * 1e3:.1f} ms per step (median of steps 2-3, "
                  f"host clock); peak {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} above "
                  f"the {held / 2**30:.2f} GiB held before); K1 {k1}, K4 {k4} launches",
                  flush=True)
            if k4 == 0 or k1 != 2 * k4:
                fail(f"remat [{policy}]: K1 launched {k1} times for K4's {k4}: the recompute "
                     "did not relaunch K1")
            del state, run_step
            torch.cuda.empty_cache()
        ref_loss, ref_ad = runs[None]
        for policy in REMAT_POLICIES[1:]:
            loss, ad = runs[policy]
            same = torch.equal(loss, ref_loss) and all(torch.equal(a, b)
                                                       for a, b in zip(ad, ref_ad))
            d_loss = float(((loss - ref_loss).abs() / ref_loss.abs()).max())
            d_ad = max(float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30)) for a, b in zip(ad, ref_ad))
            print(f"remat [{policy}] against the full recompute: bit-equal {same}; largest "
                  f"relative difference: losses {d_loss:.3e}, adapters after step 3 "
                  f"{d_ad:.3e} (bound {REMAT_RTOL})", flush=True)
            if d_loss > REMAT_RTOL or d_ad > REMAT_RTOL:
                fail(f"remat [{policy}]: departs from the full recompute")
        del runs, base
        torch.cuda.empty_cache()

        # ---- the CLI: --remat_policy dots, LoRA, depth 4, 2 steps
        cfg4 = dataclasses.replace(cfg, num_hidden_layers=depths[1])
        save_checkpoint(str(work / "base4"), cfg4, init_params(cfg4, 6, device=dev))
        t0 = time.time()
        r = run_mod.main(["--train_data", str(work / "data"), "--model_name_or_path",
                          str(work / "base4"), "--mode", "unified", "--lora",
                          "--per_device_train_batch_size", "4", "--train_group_size", "2",
                          "--max_steps", "2", "--save_steps", "0", "--logging_steps", "1",
                          "--learning_rate", "1e-4", "--remat_policy", "dots",
                          "--query_max_len", str(qlen), "--passage_max_len", str(plen),
                          "--generative_max_len", str(glen),
                          "--output_dir", str(work / "run"), "--device", dev.type])
        print(f"remat [training.run --remat_policy dots, LoRA, {depths[1]} layers]: "
              f"{r['steps']} steps in "
              f"{time.time() - t0:.1f} s (model load and export included), final {r['final']}",
              flush=True)
        if r["steps"] != 2 or not all(np.isfinite(v) for v in r["final"].values()):
            fail(f"remat [training.run --remat_policy dots]: {r}")
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    path_launches["remat"] = counts
    print(f"remat launches: {counts}; phase 14 remat {time.time() - t_phase:.0f} s", flush=True)
    if any(counts[n] == 0 for n in ("flash_attention", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")):
        fail("remat: the policies' steps did not go through K1, K4 and K5")
    torch.cuda.empty_cache()


def latency_phase(model) -> None:
    """The reference latency protocol through eval.latency.run_sweep:
    16 docs of 250 and 2000 tokens, 250-token queries, batch 4, 16 new
    tokens, 1 warm-up and 3 timed calls per mode. p50 seconds per query."""
    import torch

    from gritlm_tpu_torch.eval import latency
    from gritlm_tpu_torch.training.templates import gritlm_instruction

    t0 = time.time()
    lengths, modes = (250, 2000), latency.SWEEP_MODES
    sweep = latency.run_sweep(model, lengths=lengths, modes=modes, query_lengths=(250,),
                              max_new_tokens=16, n_queries=4, reps=3, warmup=1, n_docs=16)
    cfg, tok = model.config, model.tokenizer
    per_token = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim_ * 2
    for dlen in lengths:
        p50 = {m: sweep[f"250-{dlen}-16-{model.device.type}-{m}"]["p50"] for m in modes}
        if not all(np.isfinite(v) and v > 0 for v in p50.values()):
            fail(f"latency d{dlen}: {p50}")
        ntok = len(tok._encode_one(gritlm_instruction("") + latency.synthetic_text(tok, dlen),
                                   True))
        store = 16 * ntok * per_token
        where = ("device pool" if store <= 2 * 2**30
                 else "host store (over the 2 GiB doc_pool_bytes)")
        base = p50["prompt_query_doc"]
        print(f"latency q250 d{dlen}: 16 docs of {ntok} tokens, doc store "
              f"{store / 2**30:.2f} GiB -> {where}; p50 s/query "
              + ", ".join(f"{m} {v:.4f}" for m, v in p50.items())
              + f"; doc {(p50['doc'] / base - 1) * 100:+.1f}%, docquery "
              f"{(p50['docquery'] / base - 1) * 100:+.1f}% against prompt_query_doc",
              flush=True)
    print(f"latency sweep: {time.time() - t0:.0f} s, dispatch floor "
          f"{sweep['_meta']['dispatch_floor_s'] * 1e6:.1f} us")
    torch.cuda.empty_cache()


# Mistral-7B's projections, (K, N): wq/wo, wk/wv, gate/up, down, the LM head
QUANT_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000))
QUANT_RTOL = 5e-3  # relative Frobenius error against the plain version (the JAX tests' bound)


def quant_checks(dev, max_err) -> None:
    """K6 and K7 against their plain versions on the card at Mistral-7B's
    projections: M 1, 3, 8, 16, 17, 64, 128 (and 256, 512 for K6: every
    row range it routes to its rows kernel or its staged template), a
    layer's view of a 3-layer stack read in place, and geometries the kernels
    reject."""
    import torch

    from gritlm_tpu_torch.models.transformer import _unstack
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.training import quant

    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    kinds = {"w8a16_matmul": (quant.quantize_kernel, qm.w8a16_matmul, qm.w8a16_matmul_plain,
                              (1, 3, 8, 16, 17, 64, 128, 256, 512)),
             "w4a16_matmul": (quant.quantize_kernel_int4, qm.w4a16_matmul,
                              qm.w4a16_matmul_plain, (1, 3, 8, 16, 17, 64, 128))}
    for name, (quantize, kernel, plain, rows) in kinds.items():
        for K, N in QUANT_SHAPES:
            node = quantize(randn(K, N))
            errs = []
            for M in rows:
                x = randn(M, K)
                got = kernel(x, node)
                torch.cuda.synchronize()
                want = plain(x, node)
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"{name} [M{M} K{K} N{N}]: shape {tuple(got.shape)} or non-finite")
                rel = float((got.float() - want.float()).norm() / want.float().norm())
                err = float((got.float() - want.float()).abs().max())
                errs.append(rel)
                max_err[name] = max(max_err[name], err)
                if rel > QUANT_RTOL:
                    fail(f"{name} [M{M} K{K} N{N}] disagrees with its plain version: relative "
                         f"error {rel} > {QUANT_RTOL}")
            print(f"check {name} [K{K} N{N}, M {', '.join(map(str, rows))}]: relative error "
                  f"up to {max(errs):.2e} (rtol {QUANT_RTOL}), max_abs_err so far "
                  f"{max_err[name]:.3e}", flush=True)
        stack = quantize(randn(3, 4096, 1024))
        key = "q8" if name == "w8a16_matmul" else "q4"
        view = _unstack({"w": stack}, 3)[2]["w"]
        x = randn(8, 4096)
        got = kernel(x, view)
        same = torch.equal(got, kernel(x, {k: v.clone() for k, v in view.items()}))
        offset = view[key].data_ptr() - stack[key].data_ptr()
        print(f"check {name} [layer 2 of a 3-layer stack]: read in place at byte offset "
              f"{offset}, equal to a contiguous copy: {same}", flush=True)
        if offset != 2 * stack[key][0].numel() or not same:
            fail(f"{name}: a layer view of the stack is copied or read wrongly")
    for label, call in (
            ("K6, N % 16 != 0", lambda: qm.w8a16_matmul(
                randn(4, 256), quant.quantize_kernel(randn(256, 24)))),
            ("K7, group of 8 rows", lambda: qm.w4a16_matmul(
                randn(4, 256), quant.quantize_kernel_int4(randn(256, 128), 8)))):
        try:
            call()
        except NotImplementedError as e:
            print(f"check rejected geometry [{label}]: raises ({str(e)[:60]}...)")
        else:
            fail(f"{label}: a geometry the kernel rejects did not raise")
    torch.cuda.empty_cache()


def cold_copies(nbytes_one: int, l2_bytes: int = 50 * 2**20) -> int:
    """Copies of a weight to cycle through so that each call finds its
    weight out of L2 (twice the L2's size in all)."""
    return max(1, -(-2 * l2_bytes // nbytes_one))


def graph_ms(fn, n: int = 20, calls: int = 1) -> float:
    """Device ms of one call of fn: `calls` calls captured once in a CUDA
    graph and replayed n times between two CUDA events. No host launch cost
    enters (the kernels at decode shapes take less time on the device than
    their Python wrappers take to launch) and no profiler trace is needed
    (one dropped a kernel now and then). Kernels in one replay run back to
    back, gaps of about a microsecond between them included; several calls
    a replay also hide the replay's own launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: allocator, library workspaces, kernel attributes
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        run = graph.replay
        run()
    except RuntimeError as e:  # a measurement, not the kernel path: say so and time the calls
        print(f"  CUDA graph capture failed ({str(e).splitlines()[0][:80]}); timed over "
              "back-to-back calls instead, host launch cost included", flush=True)
        run, n = fn, n * calls
        calls = 1
    start.record()
    for _ in range(n):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * calls)


def decode_step(label, m, enc):
    """Device and host ms per decode step of greedy generate at B = 2 (two
    torch.profiler windows, 1 and 9 new tokens: the difference over 8
    steps) and the steps' idle share; None for an empty trace."""
    def gen(n):
        return lambda: m.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                           max_new_tokens=n)

    short = profile_window(f"{label} generate B=2, 1 token", gen(1), top=0)
    full = profile_window(f"{label} generate B=2, 9 tokens", gen(9), top=8)
    if short is None or full is None:
        print(f"generate [{label}]: decode step not measured (empty trace)")
        return None
    wall, busy = full[0] - short[0], full[1] - short[1]
    if wall <= 0:
        print(f"generate [{label}]: decode step not measured (9 tokens no slower than 1)")
        return None
    idle = max(0.0, 1 - busy / wall)
    print(f"generate [{label}]: decode step at B=2 {busy / 8:.3f} device ms, {wall / 8:.3f} "
          f"host ms, idle share {idle:.3f}", flush=True)
    return busy / 8, wall / 8, idle


def quant_phase(model, enc, dense_step, reset_counts, read_counts, path_launches, times,
                max_err) -> None:
    """Quantized weights at full width (counts set to 0 before each main-path
    run, summed after): K6/K7 checks; GritLM(weight_quant=8) and (=4) over
    the same seeded bf16 weights, greedy generate at B = 2 (32 tokens) with
    a teacher-forced check, w8 with the int8 KV cache too; the weight bytes
    and the decode step against bf16; the serving workload's 8 generation
    and 4 embedding requests on a dense w4 pool; K6/K7 timed at M 8 over
    the projection shapes."""
    import torch

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.models.transformer import forward, init_cache, logits_from_hidden
    from gritlm_tpu_torch.ops import quant_matmul as qm
    from gritlm_tpu_torch.serving import ServingEngine
    from gritlm_tpu_torch.training import quant

    t_phase = time.time()
    quant_checks(model.device, max_err)
    cfg, dev = model.config, model.device
    total = {}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        for n, c in read_counts().items():
            total[n] = total.get(n, 0) + c
        return out

    def deficits(m, res, kv_quant):
        """Per generated token, how far it sits below its position's largest
        logit in one causal forward over prompt + tokens. bf16 KV: both rows
        in one right-padded batch of more than 512 rows (past K6's and K7's
        row ceilings, so the forward dequantizes); int8 KV: each row alone
        over an int8 cache, as the generate's."""
        ids, mask = enc["input_ids"], enc["attention_mask"]
        seqs = []
        for b in range(ids.shape[0]):
            prompt = ids[b, :int(mask[b].sum())].tolist()
            toks = res.tokens[b, :int(res.num_valid[b])].tolist()
            seqs.append((prompt, toks))
        out = []
        with torch.inference_mode():
            if kv_quant:
                for prompt, toks in seqs:
                    x = torch.tensor([prompt + toks], device=dev)
                    cache = init_cache(cfg, 1, x.shape[1], device=dev, quant=True)
                    hidden, _, _ = forward(m.params, cfg, x, causal=True, cache=cache)
                    out.append((hidden[0], prompt, toks))
            else:
                S = max(257, max(len(p) + len(t) for p, t in seqs))
                x = torch.zeros((len(seqs), S), dtype=torch.long, device=dev)
                am = torch.zeros((len(seqs), S), dtype=torch.int32, device=dev)
                for b, (prompt, toks) in enumerate(seqs):
                    x[b, :len(prompt) + len(toks)] = torch.tensor(prompt + toks)
                    am[b, :len(prompt) + len(toks)] = 1
                hidden, _, _ = forward(m.params, cfg, x, attention_mask=am, causal=True)
                out = [(hidden[b], p, t) for b, (p, t) in enumerate(seqs)]
            gaps = []
            for h, prompt, toks in out:
                logits = logits_from_hidden(m.params, cfg,
                                            h[len(prompt) - 1:len(prompt) - 1 + len(toks)][None])
                logits = logits[0].float()
                chosen = logits.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0]
                gaps.append((logits.max(1).values - chosen).cpu())
        return torch.cat(gaps)

    dense_bytes = quant.quantized_bytes(model.params)
    steps = {"bf16": decode_step("bf16", model, enc)}
    qmodels = {}
    for bits, kernel in ((8, "w8a16_matmul"), (4, "w4a16_matmul")):
        t0 = time.time()
        m = GritLM(cfg, params=model.params, weight_quant=bits, device=dev)
        torch.cuda.synchronize()
        qmodels[bits] = m
        nbytes_q = quant.quantized_bytes(m.params)
        print(f"weights [w{bits}a16]: {nbytes_q / 2**30:.2f} GiB against {dense_bytes / 2**30:.2f} "
              f"GiB bf16 ({nbytes_q / dense_bytes:.3f}); quantized on the card in "
              f"{time.time() - t0:.1f} s", flush=True)
        runs = [(f"w{bits}", m)]
        if bits == 8:
            runs.append(("w8, int8 KV", GritLM(cfg, params=m.params, kv_quant=True, device=dev)))
        for label, mm in runs:
            before = dict(total)
            res = counted(lambda: mm.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                                       max_new_tokens=32))
            launched = {n: total.get(n, 0) - before.get(n, 0) for n in total}
            t = res.tokens
            if not ((t >= 0) & (t < cfg.vocab_size)).all():
                fail(f"generate [{label}]: token ids out of range")
            if launched.get(kernel, 0) == 0 or launched.get("flash_decode", 0) == 0:
                fail(f"generate [{label}]: decode did not go through {kernel} and K3")
            gaps = deficits(mm, res, mm.kv_quant)
            tol = INT8_KV_TIE_TOL if mm.kv_quant else TIE_TOL
            print(f"generate [{label}, B=2, 32 tokens]: launches {launched}; teacher forcing "
                  f"over {len(gaps)} tokens: largest deficit to the max logit "
                  f"{float(gaps.max()):.4f} (tolerance {tol}), argmax at "
                  f"{float((gaps == 0).float().mean()):.3f}; sample "
                  f"{mm.tokenizer.decode(t[0].tolist())[:60]!r}", flush=True)
            if float(gaps.max()) > tol:
                fail(f"generate [{label}]: a token is {float(gaps.max())} below its position's "
                     "max logit")
        steps[f"w{bits}"] = decode_step(f"w{bits}", m, enc)
    for label, st in steps.items():
        print(f"decode step [{label}, B=2]: " + (
            "not measured" if st is None else
            f"{st[0]:.3f} device ms, {st[1]:.3f} host ms, idle share {st[2]:.3f}"), flush=True)

    # ---- w4 serving: 8 generation and 4 embedding requests, dense pool
    m4 = qmodels[4]
    drive, specs = serving_workload(m4, reset_counts, read_counts, total)
    tok = m4.tokenizer
    eng = ServingEngine(cfg, m4.params, max_batch=8, max_len=4096, chunk_size=16,
                        eos_id=tok.eos_token_id, pad_id=tok.pad_token_id, device=dev)
    drive("dense w4", eng, specs[:8], 4, decode_kernels=("w4a16_matmul",))
    from gritlm_tpu_torch import serving

    w4_step = profile_decode_chunk("dense w4", eng, serving._decode_chunk_program, specs)
    for label, st in (("bf16 (phase 7)", dense_step), ("w4", w4_step)):
        print(f"serving decode step [{label}, B=8]: " + (
            "not measured" if st is None else
            f"{st[0]:.3f} device ms, {st[1]:.3f} host ms, idle share {st[2]:.3f}"), flush=True)
    del eng
    path_launches["quantized"] = total
    print(f"quantized launches: {total}")
    if total.get("w8a16_matmul", 0) == 0 or total.get("w4a16_matmul", 0) == 0:
        fail("the quantized paths did not go through K6 and K7")

    # ---- K6 and K7 at the decode rows M 8 over every projection shape (the
    # gate/up shape, 4096 -> 14336, is the kernel table's), and at gate/up
    # also M 1 and 16 and the prefill-chunk rows 64 and 128 (K6, K7), 256
    # and 512 (K6).
    # Times from CUDA graph replays (graph_ms), over enough copies of the
    # weights to keep them out of L2, as in a decode step, where 31 other
    # layers pass between two reads of a layer's weights.
    gen = torch.Generator(device=dev).manual_seed(12)
    for K, N in QUANT_SHAPES:
        gate_up = (K, N) == (4096, 14336)
        w = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
        for name, node, plain, kern, rows in (
                ("w8a16_matmul", quant.quantize_kernel(w), qm.w8a16_matmul_plain,
                 qm.w8a16_matmul, (8, 1, 16, 64, 128, 256, 512) if gate_up else (8,)),
                ("w4a16_matmul", quant.quantize_kernel_int4(w), qm.w4a16_matmul_plain,
                 qm.w4a16_matmul, (8, 1, 16, 64, 128) if gate_up else (8,))):
            dense = quant.dequantize_kernel(node, torch.bfloat16)  # what quantization replaces
            nodes = [node] + [{k: v.clone() for k, v in node.items()}
                              for _ in range(cold_copies(nbytes(*node.values())) - 1)]
            denses = [dense] + [dense.clone() for _ in range(cold_copies(nbytes(dense)) - 1)]
            for M in rows:
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                ms = graph_ms(lambda: [kern(x, nd) for nd in nodes]) / len(nodes)
                library_ms = graph_ms(lambda: [torch.matmul(x, d) for d in denses]) / len(denses)
                bms, by = bound(2.0 * M * K * N, nbytes(*node.values(), x) + M * N * 2)
                line = (f"time {name} [M{M} K{K} N{N}]: device {ms:.4f} ms ({bms / ms * 100:.1f}"
                        f"% of bound {bms:.4f} ms, {by}), library {library_ms:.4f} (torch.matmul "
                        f"against the dequantized bf16 weight); CUDA graph replays over "
                        f"{len(nodes)} / {len(denses)} weight copies")
                if gate_up and M == 8:
                    plain_ms = graph_ms(lambda: plain(x, node), n=10)
                    times[name] = (ms, plain_ms, library_ms, bms, by)
                    line += f"; plain {plain_ms:.4f}"
                print(line, flush=True)
                if not (gate_up and M == 8):
                    continue
                try:  # PyTorch's own quantized-weight products: yardsticks, never used by the port
                    if name == "w8a16_matmul":
                        w8t, s8 = node["q8"].t().contiguous(), node["scale"][0].to(torch.bfloat16)
                        other = lambda: torch._weight_int8pack_mm(x, w8t, s8)  # noqa: E731
                    else:
                        nib = (quant.unpack_int4(node)[0] + 8).t().to(torch.uint8)  # [N, K]
                        packed = torch._convert_weight_to_int4pack(
                            ((nib[:, ::2] << 4) | nib[:, 1::2]).contiguous(), 8)
                        sz = torch.stack([node["scale"], torch.zeros_like(node["scale"])],
                                         -1).to(torch.bfloat16).contiguous()
                        other = lambda: torch._weight_int4pack_mm(x, packed, 32, sz)  # noqa: E731
                    print(f"  torch.{'_weight_int8pack_mm' if name == 'w8a16_matmul' else '_weight_int4pack_mm'}"
                          f" at the same shape: {graph_ms(other):.4f} ms (one weight copy)",
                          flush=True)
                except (TypeError, RuntimeError, NotImplementedError) as e:
                    print(f"  PyTorch's packed-weight product for {name} does not run here: "
                          f"{str(e).splitlines()[0][:100]}")
            del dense, nodes, denses
    del qmodels, m4, w, x
    torch.cuda.empty_cache()
    print(f"quantized phase: {time.time() - t_phase:.0f} s", flush=True)



# Mixtral-8x7B at its published width: 46.70 B parameters (93.4 GB in bf16)
# at 32 layers do not fit the 80 GB card, so phases 13 and 15 cut the depth:
# 4 layers in bf16 (16, 23.48 B parameters and 46.96 GB, fit the card; 8
# kept the script inside its time limit beside phase 19, 4 beside phase
# 20), 4 for the w8 model (built from a bf16 model of that depth).
MOE_DEPTH = 4
MOE_W8_DEPTH = 4


class Routes:
    """The MoE routers' expert choices, recorded and replayed: a stand-in
    for models.transformer._router while `with` is open. mode "record"
    appends each call's top-k indices [T, k] to `calls`; mode "pin" takes
    each call's indices from `calls` in order (a -1 row keeps the call's
    own choice) and its weights from the call's own probabilities. Pinning
    the routes of one run in another holds the rest of the function
    (attention, the expert products, the combine) to a tolerance: with
    random bf16 weights a router's top two are often within rounding of the
    third, and one flipped route moves a token's hidden state far."""

    def __init__(self, mode: str, calls=None):
        self.mode, self.calls = mode, [] if calls is None else calls

    def __enter__(self):
        import torch

        from gritlm_tpu_torch.models import transformer

        self._orig, pending = transformer._router, iter(self.calls)

        def route(p, xt, cfg):
            logits, probs, top_w, top_idx = self._orig(p, xt, cfg)
            if self.mode == "record":
                self.calls.append(top_idx)
                return logits, probs, top_w, top_idx
            idx = next(pending)
            idx = torch.where(idx >= 0, idx, top_idx)
            w = probs.gather(1, idx)
            return logits, probs, w / w.sum(dim=-1, keepdim=True), idx

        transformer._router = route
        return self

    def __exit__(self, *exc):
        from gritlm_tpu_torch.models import transformer

        transformer._router = self._orig


class RouteBook:
    """A serving engine's MoE routes by request and position, for teacher
    forcing with the routes the engine took pinned. While `with` is open
    the `forward` that serving.py and gritlm.py call is wrapped: a forward
    over whole rows from slot 0 (a prefill, an embedding batch) files each
    row's routes [L, n, k] under the row's valid token ids; a decode step
    (`row_offsets`) files each active row's routes [L, k] under the request
    the engine holds in that slot, at the row's position. Only device
    copies are taken during the run; they are read when a check asks."""

    def __init__(self, eng):
        self.eng, self.rows, self.decode, self._raw = eng, {}, {}, []

    def __enter__(self):
        from gritlm_tpu_torch import gritlm, serving

        self._orig = {mod: mod.forward for mod in (gritlm, serving)}
        for mod, fwd in self._orig.items():
            mod.forward = self._recording(fwd)
        return self

    def __exit__(self, *exc):
        for mod, fwd in self._orig.items():
            mod.forward = fwd

    def _recording(self, fwd):
        import torch

        def run(params, cfg, input_ids, **kw):
            with Routes("record") as rec:
                out = fwd(params, cfg, input_ids, **kw)
            B, S = input_ids.shape
            routes = torch.stack(rec.calls).view(len(rec.calls), B, S, -1)
            cache = kw.get("cache")
            if kw.get("row_offsets") is not None:
                slots = {s: st.request.request_id for s, st in self.eng.slots.items()}
                self._raw.append(("step", slots, kw["positions"][:, 0].clone(),
                                  kw["attention_mask"][:, 0].clone(), routes[:, :, 0]))
            elif cache is None or cache.length == 0:
                mask = kw.get("attention_mask")
                self._raw.append(("rows", input_ids.clone(),
                                  None if mask is None else mask.clone(), routes))
            return out

        return run

    def _read(self):
        for ev in self._raw:
            if ev[0] == "rows":
                _, ids, mask, routes = ev
                ids = ids.cpu()
                lens = [ids.shape[1]] * ids.shape[0] if mask is None else mask.sum(1).tolist()
                for b, n in enumerate(lens):
                    self.rows[tuple(ids[b, :int(n)].tolist())] = routes[:, b, :int(n)]
            else:
                _, slots, pos, active, routes = ev
                pos, active = pos.cpu().tolist(), active.cpu().tolist()
                for s, rid in slots.items():
                    if active[s]:
                        self.decode.setdefault(rid, {})[int(pos[s])] = routes[:, s]
        self._raw = []

    def table(self, rid, ids, toks):
        """[L, n, k] routes of prompt `ids` + `toks` as the engine took them
        (-1 where it filed none: the last token, never fed)."""
        import torch

        self._read()
        prefill = self.rows[tuple(ids)]
        L, P, k = prefill.shape
        table = torch.full((L, P + len(toks), k), -1, dtype=torch.long, device=prefill.device)
        table[:, :P] = prefill
        for pos, r in self.decode.get(rid, {}).items():
            if pos < table.shape[1]:
                table[:, pos] = r
        return table

    def pinning(self):
        """A context in which gritlm.forward runs each row with the routes
        filed under its valid token ids (its own where none were)."""
        import contextlib

        import torch

        from gritlm_tpu_torch import gritlm

        self._read()
        fwd = gritlm.forward

        def run(params, cfg, input_ids, **kw):
            B, S = input_ids.shape
            L, k = cfg.num_hidden_layers, cfg.num_experts_per_tok
            table = torch.full((L, B, S, k), -1, dtype=torch.long, device=input_ids.device)
            ids, mask = input_ids.cpu(), kw.get("attention_mask")
            lens = [S] * B if mask is None else mask.sum(1).tolist()
            for b, n in enumerate(lens):
                got = self.rows.get(tuple(ids[b, :int(n)].tolist()))
                if got is not None:
                    table[:, b, :int(n)] = got
            with Routes("pin", list(table.view(L, B * S, k))):
                return fwd(params, cfg, input_ids, **kw)

        @contextlib.contextmanager
        def patched():
            gritlm.forward = run
            try:
                yield
            finally:
                gritlm.forward = fwd

        return patched()

    def check(self, label, model, forced, quant):
        """pinned_teacher_forcing of the (prompt ids, request id, tokens) in
        `forced` over the routes the engine took."""
        return pinned_teacher_forcing(f"serving {label}", model, [
            (ids, toks, self.table(rid, ids, toks)) for ids, rid, toks in forced], quant)


def pinned_teacher_forcing(label, model, forced, quant=False):
    """Teacher forcing (teacher_deficits) of each (prompt ids, tokens,
    routes [L, n, k] the run took) in `forced`, with those routes pinned
    (returned: the deficits the caller holds to TIE_TOL) and with the
    forward's own routes: printed, with the sequences whose routes differ
    from the run's at a generated position; there a token more than
    TIE_TOL below the max fails unless a route flipped at or before it."""
    import torch

    pinned, own, unexplained, flipped = [], [], [], 0
    for n_seq, (ids, toks, table) in enumerate(forced):
        P, n = len(ids), len(ids) + len(toks)
        if (table[:, :n - 1] < 0).any():
            fail(f"[{label}]: sequence {n_seq}: the run's routes were not all recorded")
        pinned.append(teacher_deficits(model, ids, toks, quant, Routes("pin", list(table))))
        with Routes("record") as rec:
            gaps = teacher_deficits(model, ids, toks, quant)
        differ = torch.stack([(r.sort(-1).values != t.sort(-1).values).any(-1)
                              for r, t in zip(rec.calls, table)]).any(0)
        differ = differ[P - 1:n - 1].cpu()  # the positions that predict the tokens
        flipped += int(differ.any())
        before = differ.cumsum(0) > 0
        unexplained += [(n_seq, j) for j in ((gaps > TIE_TOL) & ~before).nonzero().flatten()
                        .tolist()]
        own.append(gaps)
    own = torch.cat(own)
    print(f"[{label}]: teacher forcing with the forward's own routes: largest deficit "
          f"{float(own.max()):.4f}, argmax at {float((own == 0).float().mean()):.3f}; "
          f"{flipped} of {len(forced)} sequences route another way than the run at some "
          "generated position", flush=True)
    if unexplained:
        fail(f"[{label}]: tokens {unexplained} (sequence, token) are more than TIE_TOL below "
             "the max logit with no routing flip at or before them")
    return torch.cat(pinned)


def moe_generate_check(label, model, enc, n_new, counted):
    """Greedy generate at B = 2 on a MoE trunk (launch counts summed by
    `counted`), teacher-forced with its own routes pinned (the prefill's
    over the prompt, decode step j's at the token it fed): each token
    within TIE_TOL of its position's largest logit
    (pinned_teacher_forcing)."""
    import torch

    ids, mask = enc["input_ids"], enc["attention_mask"]
    B, L = ids.shape[0], model.config.num_hidden_layers
    with Routes("record") as rec:
        res, launched = counted(lambda: model.generate_from_ids(ids, mask,
                                                                max_new_tokens=n_new))
    prefill, decode = rec.calls[:L], rec.calls[L:]
    if any(r.shape[0] != B for r in decode) or prefill[0].shape[0] % B:
        fail(f"generate [{label}]: routes recorded at unexpected shapes")
    t = res.tokens
    if not ((t >= 0) & (t < model.config.vocab_size)).all():
        fail(f"generate [{label}]: token ids out of range")
    forced = []
    for b in range(B):
        P = int(mask[b].sum())
        toks = t[b, :int(res.num_valid[b])].tolist()
        table = torch.full((L, P + len(toks), prefill[0].shape[1]), -1, dtype=torch.long,
                           device=model.device)
        for layer in range(L):
            table[layer, :P] = prefill[layer].view(B, -1, table.shape[2])[b, :P]
            for j in range(1, len(toks)):  # decode step j fed token j - 1 at P + j - 1
                table[layer, P + j - 1] = decode[(j - 1) * L + layer][b]
        forced.append((ids[b, :P].tolist(), toks, table))
    pinned = pinned_teacher_forcing(f"generate {label}", model, forced)
    print(f"generate [{label}, B=2, {n_new} tokens]: launches {launched}; teacher forcing over "
          f"{len(pinned)} tokens with the generate's routes pinned: largest deficit to the max "
          f"logit {float(pinned.max()):.4f} (TIE_TOL {TIE_TOL}), argmax at "
          f"{float((pinned == 0).float().mean()):.3f}; sample "
          f"{model.tokenizer.decode(t[0].tolist())[:60]!r}", flush=True)
    if float(pinned.max()) > TIE_TOL:
        fail(f"generate [{label}]: a token is {float(pinned.max())} below its position's max "
             "logit with the routes pinned")
    return res


def moe_phase(enc, reset_counts, read_counts, path_launches) -> None:
    """Phase 13: Mixtral MoE serving at Mixtral-8x7B width (D 4096, F 14336,
    8 experts top-2, 32/8 heads of 128, V 32000; random bf16 weights from a
    seed), depth MOE_DEPTH (the earlier phases' model is freed first).
    Launch counts are set to 0 before each main-path run and summed after:
    encode with moe_impl "dense" (the preset's) and "dropless" on the same
    weights (each other and the plain K1 + K2 path at cosine >= COSINE_MIN,
    sentences/s); greedy generate at B = 2 (32 tokens; TIE_TOL, routing
    flips, the decode step); the serving workload cut to 8 generation and 4
    embedding requests on a dense and a paged pool (page 256): completions,
    TIE_TOL, streams that differ between the pools with the first differing
    position's deficits, one decode chunk per moe_impl under
    torch.cuda.set_sync_debug_mode("error"), the chunk's device ms a step;
    RAGEngine over the 16 sentences with doc caches, 4 queries in DOC mode
    (each retrieving its own passage); then GritLM(weight_quant=8) at depth MOE_W8_DEPTH: greedy generate (16
    tokens, TIE_TOL), its weight bytes and decode step. K1, K2, K3, K8 and K6
    must each launch in these runs."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM, serving
    from gritlm_tpu_torch.config import mixtral_8x7b
    from gritlm_tpu_torch.models.transformer import count_params
    from gritlm_tpu_torch.ops import flash_attention, fused_pool
    from gritlm_tpu_torch.serving import ServingEngine
    from gritlm_tpu_torch.training import quant

    t_phase = time.time()
    total = {}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = read_counts()
        for n, c in launched.items():
            total[n] = total.get(n, 0) + c
        return out, {n: c for n, c in launched.items() if c}

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(mixtral_8x7b(), num_hidden_layers=MOE_DEPTH)
    model = GritLM(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"model [phase 13]: Mixtral-8x7B width at depth {MOE_DEPTH}, "
          f"{count_params(model.params) / 1e9:.3f} B params, weights "
          f"{quant.quantized_bytes(model.params) / 2**30:.2f} GiB, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.time() - t_phase:.1f} s", flush=True)

    # ---- encode, dense and dropless, and the plain K1 + K2 path
    def encode_all(m):
        a = m.encode(SENTENCES[:8])
        b = m.encode(SENTENCES[8:], instruction=INSTRUCTION)
        return torch.cat([torch.from_numpy(a), torch.from_numpy(b)])

    embs, routes = {}, {}
    for impl in ("dense", "dropless"):
        m = GritLM(dataclasses.replace(cfg, moe_impl=impl), params=model.params)
        with Routes("record") as rec:
            emb, launched = counted(lambda: encode_all(m))
        embs[impl], routes[impl] = emb, rec.calls
        torch.cuda.synchronize()
        t0 = time.time()
        encode_all(m)
        torch.cuda.synchronize()
        dt = time.time() - t0
        if tuple(emb.shape) != (16, cfg.hidden_size) or not torch.isfinite(emb).all():
            fail(f"encode [Mixtral {impl}]: shape {tuple(emb.shape)} or non-finite values")
        if (emb.norm(dim=-1) - 1).abs().max() > 1e-3:
            fail(f"encode [Mixtral {impl}]: embeddings are not unit vectors")
        if not launched.get("flash_attention") or not launched.get("fused_norm_mean_pool"):
            fail(f"encode [Mixtral {impl}] did not go through K1 and K2: {launched}")
        print(f"encode [Mixtral {impl}]: 16 sentences in {dt * 1e3:.1f} ms = {16 / dt:.1f} "
              f"sentences/s (host clock, second call); launches {launched}", flush=True)

    def encode_pinned(impl, calls):
        with Routes("pin", list(calls)):
            return encode_all(GritLM(dataclasses.replace(cfg, moe_impl=impl),
                                     params=model.params))

    # the same routes (the dense kernel run's) through the other impl and
    # through the plain K1 + K2 path; every figure with the routes each run
    # takes by itself printed beside
    pinned = {"dropless": encode_pinned("dropless", routes["dense"])}
    plain = {(flash_attention, "flash_attention"): flash_attention.flash_attention_plain,
             (fused_pool, "fused_norm_mean_pool"): fused_pool.fused_norm_mean_pool_plain}
    kept = {key: getattr(*key) for key in plain}
    for (mod, name), fn in plain.items():
        setattr(mod, name, fn)
    try:
        for impl in ("dense", "dropless"):
            pinned[f"{impl} plain"] = encode_pinned(impl, routes[impl])
            with Routes("record") as rec:
                embs[f"{impl} plain"] = encode_all(
                    GritLM(dataclasses.replace(cfg, moe_impl=impl), params=model.params))
            routes[f"{impl} plain"] = rec.calls
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)
    for a, b in (("dense", "dropless"), ("dense", "dense plain"),
                 ("dropless", "dropless plain")):
        cos = float(F.cosine_similarity(embs[a], pinned[b], dim=-1).min())
        own = float(F.cosine_similarity(embs[a], embs[b], dim=-1).min())
        flipped = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                      for x, y in zip(routes[a], routes[b]))
        n_routes = sum(x.shape[0] for x in routes[a])
        print(f"encode [Mixtral]: {a} against {b}: min cosine {cos:.6f} with {a}'s routes "
              f"pinned (COSINE_MIN {COSINE_MIN}); {own:.6f} with each run's own routes, "
              f"{flipped} of {n_routes} token-layer routes differing", flush=True)
        if cos < COSINE_MIN:
            fail(f"encode [Mixtral]: {a} departs from {b} with the same routes (min cosine {cos})")
    del m

    # ---- greedy generate, B = 2
    moe_generate_check("Mixtral bf16", model, enc, 32, counted)
    step = decode_step("Mixtral bf16", model, enc)
    # the same step with the dropless impl, which reads only the experts its
    # two rows chose (moe_impl "auto" takes dense below 1024 tokens)
    step_dropless = decode_step("Mixtral bf16 dropless", GritLM(
        dataclasses.replace(cfg, moe_impl="dropless"), params=model.params), enc)

    # ---- serving: 8 generation and 4 embedding requests, dense and paged
    tok = model.tokenizer
    drive, specs = serving_workload(model, reset_counts, read_counts, total)
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=model.device)
    runs, chunk_steps = {}, {}
    for label, extra in (("Mixtral dense", {}), ("Mixtral paged", dict(paged=True, page_size=256))):
        eng = ServingEngine(cfg, model.params, **kw, **extra)
        runs[label] = drive(label, eng, specs[:8], 4)
        chunk_steps[label] = profile_decode_chunk(label, eng, serving._decode_chunk_program,
                                                  specs)
        if not eng.paged:  # one more chunk per moe_impl, with any host sync raising
            for impl in ("dense", "auto", "dropless"):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    serving._decode_chunk_program(
                        eng.params, dataclasses.replace(cfg, moe_impl=impl), eng.carry,
                        steps=2, eos_id=eng.eos_id, pad_id=eng.pad_id)
                except RuntimeError as e:
                    fail(f"serving [Mixtral dense]: a host sync in the decode chunk under "
                         f"moe_impl={impl}: {str(e).splitlines()[0][:200]}")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            print("serving [Mixtral dense]: decode chunks under moe_impl dense, auto and "
                  "dropless ran with set_sync_debug_mode('error'): no host sync", flush=True)
        del eng
    dense_toks, paged_toks = runs["Mixtral dense"]["tokens"], runs["Mixtral paged"]["tokens"]
    ids_by = {rid: ids for rid, ids, _ in specs[:8]}
    differ = [rid for rid in ids_by if dense_toks[rid] != paged_toks[rid]]
    print(f"serving [Mixtral]: {len(differ)} of {len(ids_by)} greedy streams differ between "
          "the dense and the paged pool", flush=True)
    for rid in differ:
        a, b = dense_toks[rid], paged_toks[rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gaps = [teacher_deficits(model, ids_by[rid], t, routes=Routes(
                    "pin", list(runs[pool]["book"].table(rid, ids_by[rid], t))))[j]
                if j < len(t) else float("nan")
                for t, pool in ((a, "Mixtral dense"), (b, "Mixtral paged"))]
        print(f"  {rid}: first differs at generated token {j}; deficit to the largest logit "
              f"with the pool's routes pinned: dense {float(gaps[0]):.4f}, paged "
              f"{float(gaps[1]):.4f} (TIE_TOL {TIE_TOL})", flush=True)
        if max(float(g) for g in gaps) > TIE_TOL:
            fail(f"serving [Mixtral]: {rid} departs between the pools by more than a near-tie")
    for label, st in list(chunk_steps.items()) + [("generate B=2 (decode step)", step),
                                                  ("generate B=2, dropless", step_dropless)]:
        print(f"decode step [{label}]: " + (
            "not measured" if st is None else
            f"{st[0]:.3f} device ms, {st[1]:.3f} host ms, idle share {st[2]:.3f}"), flush=True)
    # ---- RAGEngine: doc caches built through the MoE trunk, the DOC mode
    from gritlm_tpu_torch.rag import CacheMode, RAGEngine

    def rag_doc():
        eng = RAGEngine(model, max_new_tokens=16, encode_max_length=512)
        eng.build_index([{"text": t} for t in SENTENCES], batch_size=16, cache_docs=True)
        return eng.answer_batch(SENTENCES[:4], mode=CacheMode.DOC)

    res, launched = counted(rag_doc)
    print(f"rag [Mixtral doc]: {res[0].seconds * 1e3:.1f} ms/query (batch 4, 16 new tokens, "
          f"index and doc caches of the 16 sentences built first); launches {launched}; "
          f"answer {res[0].answer!r}", flush=True)
    if [r.passages[0]["text"] for r in res] != SENTENCES[:4]:
        fail("rag [Mixtral doc]: a query did not retrieve its own passage")
    if not launched.get("scores_segmax") or not launched.get("flash_decode"):
        fail(f"rag [Mixtral doc]: search or decode skipped its kernel: {launched}")

    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, runs, drive  # drive holds the model
    gc.collect()  # engines held in reference cycles (their on_token closures) keep their pools
    torch.cuda.empty_cache()

    # ---- w8 at depth MOE_W8_DEPTH, quantized from a bf16 model of that depth
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cfg8 = dataclasses.replace(mixtral_8x7b(), num_hidden_layers=MOE_W8_DEPTH)
    base = GritLM(cfg8, seed=0)
    bf16_bytes = quant.quantized_bytes(base.params)
    m8 = GritLM(cfg8, params=base.params, weight_quant=8)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    w8_bytes = quant.quantized_bytes(m8.params)
    print(f"weights [Mixtral w8, depth {MOE_W8_DEPTH}]: {w8_bytes / 2**30:.2f} GiB against "
          f"{bf16_bytes / 2**30:.2f} GiB bf16; built in {time.time() - t0:.1f} s, peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    before = dict(total)
    moe_generate_check("Mixtral w8", m8, enc, 16, counted)
    if total.get("w8a16_matmul", 0) == before.get("w8a16_matmul", 0):
        fail("generate [Mixtral w8]: decode did not go through K6")
    step8 = decode_step("Mixtral w8", m8, enc)
    print(f"decode step [Mixtral w8, B=2, depth {MOE_W8_DEPTH}]: " + (
        "not measured" if step8 is None else
        f"{step8[0]:.3f} device ms, {step8[1]:.3f} host ms, idle share {step8[2]:.3f}"),
        flush=True)
    del m8
    gc.collect()
    torch.cuda.empty_cache()

    path_launches["moe"] = total
    missing = [n for n in ("flash_attention", "fused_norm_mean_pool", "flash_decode",
                           "paged_decode", "w8a16_matmul") if not total.get(n)]
    print(f"MoE launches: {total}; peak allocated at depth {MOE_DEPTH}: {peak:.2f} GiB; "
          f"phase 13 {time.time() - t_phase:.0f} s", flush=True)
    if missing:
        fail(f"the MoE path never launched {missing}")

# Phase 15: MoE GRIT training at Mixtral-8x7B width. The LoRA step runs at
# phase 13's MOE_DEPTH (4 layers of random bf16 weights; at 16, 43.75 GiB,
# the step added 10.8 GiB at its peak on the 80 GB card); the router's gradient,
# the expert stacks' gradients, the capacity drops and the CLI at depth 2.
MOE_AUX_RTOL = 1e-5  # loss_gen against the CE plus the aux term recomputed in fp32
# the router gradient's aux part, (coef default) - (coef 0) against coef x
# the aux loss's own gradient: each of the three is an fp32 accumulation
# rounded once to bf16 (the router is a bf16 leaf), and the first two also
# carry the next-token loss's part, so the difference holds to a few bf16
# steps of the whole gradient: 2^-7 of |g_default| + |g_0| (Frobenius)
ROUTER_GRAD_RTOL = 2.0 ** -7
MOE_LAYER_RTOL = 1e-2  # dense combines in bf16, dropless and gshard in fp32


def moe_train_phase(dev, reset_counts, read_counts, path_launches, preset="mixtral_8x7b",
                    lengths=(256, 2048, 2048), depths=(MOE_DEPTH, 2), gen_len=512,
                    layer_tokens=(2, 512)) -> None:
    """Phase 15: MoE GRIT training at Mixtral-8x7B width (after phase 13;
    counts set to 0 before, read after). LoRA (r 16, alpha 64: wq/wk/wv/wo,
    the 4-D expert stacks are no target) at depth depths[0] on phase 10's
    batch (4 x group 2, query 256 / passage 2048 / generative 2048: 25,600
    tokens a step), moe_impl "auto" (dropless: every forward has >= 1024
    tokens), 3 steps: ms a step, tokens/s, peak GiB, finite losses (a
    fourth step profiled by profile_window), and
    loss_gen equal to the step's next-token loss plus coef x
    load_balancing_loss recomputed in fp32 from the step's own router
    logits (MOE_AUX_RTOL). Then at depth 2, full parameters, a generative
    batch of 4 x gen_len: the router's gradient with the default
    router_aux_coef minus with 0 against coef x the aux loss's own gradient
    (ROUTER_GRAD_RTOL; the dense impl, whose backward is deterministic);
    the expert stacks' gradients nonzero under dense, dropless and gshard;
    a LoRA step under gshard at capacity 0.25 (moe_dropped_frac > 0) and
    4.0 = E/k (exactly 0), one of them profiled through
    utils.profiling.trace (device events in its Chrome trace); one full-
    width layer under the three impls (output, input and expert gradients
    within MOE_LAYER_RTOL of dense's); `training.run --model_name_or_path
    <depth-2 checkpoint> --lora --moe_impl dropless --native_loader`, 2
    steps (finite, moe_dropped_frac in metrics.jsonl); host ms a batch of
    the native loader and of the Python pipeline (printed)."""
    import dataclasses
    import shutil

    import torch

    from gritlm_tpu_torch import config as cfgmod
    from gritlm_tpu_torch.models import transformer as tr
    from gritlm_tpu_torch.models.loader import save_checkpoint
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training import run as run_mod
    from gritlm_tpu_torch.training import train
    from gritlm_tpu_torch.training.data import (
        GritCollator,
        GritDataset,
        batch_iterator,
        load_train_dirs,
    )
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.native_loader import NativeGritLoader
    from gritlm_tpu_torch.utils import profiling

    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke_moe_train"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    synthetic_train_data(data)
    full = getattr(cfgmod, preset)()
    cfg = dataclasses.replace(full, num_hidden_layers=depths[0], moe_impl="auto")
    qlen, plen, glen = lengths
    emb, gen = load_train_dirs([str(data)])
    coll = GritCollator(ByteTokenizer(), query_max_len=qlen, passage_max_len=plen,
                        generative_max_len=glen)
    batch = next(batch_iterator(GritDataset(emb, gen, train_group_size=2, seed=0), coll, 4,
                                seed=0))
    valid = sum(int(part["attention_mask"].sum()) for part in batch.values())
    padded = sum(part["attention_mask"].size for part in batch.values())
    gcoll = GritCollator(ByteTokenizer(), generative_max_len=gen_len)
    gbatch = next(batch_iterator(GritDataset(emb, gen, mode="generative", seed=0), gcoll, 4,
                                 seed=0))
    gb = train.batch_to_device(gbatch, dev)["generative"]
    reset_counts()
    try:
        # ---- the LoRA step at depth, with its aux term recomputed
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        base = tr.init_params(cfg, 0, device=dev)
        tc = train.TrainConfig(learning_rate=1e-4, total_steps=6)
        run_step, state, _, _ = make_lora_train_state(cfg, tc, base, r=16, alpha=64, seed=0,
                                                      device=dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        print(f"moe train [LoRA]: Mixtral-8x7B width at depth {depths[0]}, "
              f"{tr.count_params(base) / 1e9:.3f} B params ({held / 2**30:.2f} GiB held), "
              f"{tr.count_params(state.params) / 1e6:.1f} M trained; init "
              f"{time.time() - t0:.1f} s", flush=True)
        seen = []  # each generative forward's (next-token loss, router logits, mask)
        next_token, balance = train.next_token_loss, train.load_balancing_loss

        def record_ce(*a, **k):
            out = next_token(*a, **k)
            seen.append([out.detach().clone()])
            return out

        def record_aux(logits, c, mask):
            seen[-1] += [logits.detach().clone(), mask.clone()]
            return balance(logits, c, mask)

        train.next_token_loss, train.load_balancing_loss = record_ce, record_aux
        metrics, step_s = [], []
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run_step(state, batch)
                metrics.append(m)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        finally:
            train.next_token_loss, train.load_balancing_loss = next_token, balance
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(step_s[1:])
        coef = cfg.router_aux_loss_coef
        errs = []
        for m, (ce, logits, mask) in zip(metrics, seen):
            aux = coef * tr.load_balancing_loss(logits.float(), cfg, mask)
            errs.append(float((m.loss_gen - (ce + aux)).abs() / m.loss_gen.abs()))
        print(f"moe train [LoRA, {depths[0]} layers, auto = dropless]: losses "
              f"{', '.join(f'{float(m.loss):.4f}' for m in metrics)}, loss_gen "
              f"{float(metrics[-1].loss_gen):.5f} of which aux {float(aux):.6f} (coef {coef}); "
              f"loss_gen against CE + aux recomputed in fp32: {max(errs):.2e} relative (rtol "
              f"{MOE_AUX_RTOL}); moe_dropped_frac {float(metrics[-1].moe_dropped_frac)}; "
              f"{med * 1e3:.1f} ms per step (median of steps 2-3, host clock) = "
              f"{padded / med:.0f} tokens/s ({valid / med:.0f} valid; {valid} valid of "
              f"{padded} padded a step); peak {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} "
              f"above the weights)", flush=True)
        if len(seen) != 3 or not all(
                np.isfinite(float(x)) for m in metrics for x in (m.loss, m.loss_gen, m.grad_norm)):
            fail(f"moe train [LoRA]: {len(seen)} generative forwards, metrics {metrics}")
        if max(errs) > MOE_AUX_RTOL or not float(aux) > 0:
            fail(f"moe train [LoRA]: loss_gen is not CE + coef x aux: {errs}")
        if float(metrics[-1].moe_dropped_frac) != 0.0:
            fail("moe train [LoRA]: the dropless impl dropped routes")
        launched = read_counts()
        if any(launched[n] == 0 for n in ("flash_attention", "flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv")):
            fail(f"moe train [LoRA]: the step skipped K1, K4 or K5: {launched}")
        profile_window(f"MoE LoRA step, {depths[0]} layers", lambda: run_step(state, batch))
        del state, run_step, base, seen, metrics, logits
        gc.collect()
        torch.cuda.empty_cache()

        # ---- depth 2, full parameters: the router's gradient, the experts'
        cfg2 = dataclasses.replace(full, num_hidden_layers=depths[1], moe_impl="dense")
        params = train.trainable(tr.init_params(cfg2, 1, device=dev))
        moe = params["layers"]["moe"]
        t0 = time.time()

        def grads(c, coef_, wrt):
            tc_ = train.TrainConfig(router_aux_coef=coef_)
            loss, _ = train.generative_loss(params, c, tc_, gb)
            return torch.autograd.grad(loss, wrt)

        (g_def,), (g_0,) = grads(cfg2, None, [moe["router"]]), grads(cfg2, 0.0, [moe["router"]])
        _, _, aux = tr.forward(params, cfg2, gb["input_ids"], attention_mask=gb["attention_mask"],
                               causal=True, remat=True, output_router_logits=True)
        (g_aux,) = torch.autograd.grad(
            tr.load_balancing_loss(aux["router_logits"], cfg2, gb["attention_mask"]),
            [moe["router"]])
        diff, want = g_def.float() - g_0.float(), coef * g_aux.float()
        err = float((diff - want).norm())
        tol = ROUTER_GRAD_RTOL * float(g_def.float().norm() + g_0.float().norm())
        print(f"moe train [router gradient, depth {depths[1]}, full parameters, dense]: "
              f"|g(coef {coef}) - g(0) - coef g_aux| {err:.3e} against |coef g_aux| "
              f"{float(want.norm()):.3e}, |g(coef)| {float(g_def.float().norm()):.3e} "
              f"(bound {tol:.3e}: 2^-7 of |g(coef)| + |g(0)|); relative to coef g_aux "
              f"{err / float(want.norm()):.3e}", flush=True)
        if not err <= tol or not float(want.norm()) > 2 * tol:
            fail("moe train [router gradient]: the aux loss's gradient does not reach the "
                 "router as coef x its own gradient")
        del g_def, g_0, g_aux, diff, want, aux
        for impl in ("dense", "dropless", "gshard"):
            ge = grads(dataclasses.replace(cfg2, moe_impl=impl), None,
                       [moe["gate"], moe["up"], moe["down"]])
            mx = [float(g.float().abs().max()) for g in ge]
            print(f"moe train [expert gradients, {impl}]: max |grad| gate/up/down "
                  f"{', '.join(f'{x:.3e}' for x in mx)}", flush=True)
            if not all(np.isfinite(x) and x > 0 for x in mx):
                fail(f"moe train [expert gradients, {impl}]: {mx}")
            del ge
        print(f"moe train [gradients at depth {depths[1]}]: {time.time() - t0:.1f} s",
              flush=True)

        # ---- capacity drops under gshard (LoRA, generative-only), one step profiled
        drops = {}
        for cf in (0.25, full.num_local_experts / full.num_experts_per_tok):
            cfg_g = dataclasses.replace(cfg2, moe_impl="gshard", capacity_factor=cf)
            tc = train.TrainConfig(mode="generative", learning_rate=1e-4, total_steps=4)
            run_step, state, _, _ = make_lora_train_state(cfg_g, tc, params, seed=0,
                                                          device=dev)
            state, m = run_step(state, gbatch)
            drops[cf] = float(m.moe_dropped_frac)
            if not np.isfinite(float(m.loss)):
                fail(f"moe train [gshard, capacity {cf}]: loss {float(m.loss)}")
        print(f"moe train [gshard, 4 x {gen_len} generative, depth {depths[1]}]: "
              f"moe_dropped_frac {drops}", flush=True)
        if not (drops[0.25] > 0 and drops[cf] == 0.0):
            fail(f"moe train [gshard]: drops {drops} (want > 0 at 0.25, exactly 0 at {cf})")
        for attempt in range(3):  # a trace now and then holds no device events (time_ms)
            out = work / f"trace{attempt}"
            with profiling.trace(str(out)):
                with profiling.annotate("moe LoRA step"):
                    state, m = run_step(state, gbatch)
            events = json.loads((out / "trace.json").read_text())["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if kernels:
                break
        busy = sum(e.get("dur", 0) for e in kernels) / 1e3
        print(f"moe train [profiling.trace of one gshard LoRA step]: {len(kernels)} kernel "
              f"events, {busy:.2f} device ms, trace {(out / 'trace.json').stat().st_size} bytes "
              f"(attempt {attempt + 1})", flush=True)
        if not kernels:
            fail("moe train [profiling.trace]: no device events in three traces")
        del state, run_step

        # ---- one full-width layer under the three impls
        gen_x = torch.Generator(device=dev).manual_seed(5)
        lp = {k: v[0].detach() for k, v in moe.items()}
        x = torch.randn((*layer_tokens, full.hidden_size), generator=gen_x,
                        device=dev).to(torch.bfloat16)
        w = torch.randn(x.shape, generator=gen_x, device=dev)
        runs = {}
        for impl, kw in (("dense", {}), ("dropless", {}), ("gshard", dict(
                capacity_factor=full.num_local_experts / full.num_experts_per_tok))):
            c = dataclasses.replace(cfg2, moe_impl=impl, **kw)
            xi = x.clone().requires_grad_(True)
            ex = {k: lp[k].clone().requires_grad_(True) for k in ("gate", "up", "down")}
            y, logits, drop = tr._moe_mlp({**lp, **ex}, xi, c)
            gs = torch.autograd.grad((y.float() * w).sum(), [xi, *ex.values()])
            runs[impl] = (y.detach(), gs, logits.detach(), float(drop))
            del xi, ex, y, gs
        y0, g0, l0, _ = runs["dense"]
        rels = {}
        for impl in ("dropless", "gshard"):
            y, gs, logits, drop = runs[impl]
            if not torch.equal(logits, l0) or drop != 0.0:
                fail(f"moe train [layer, {impl}]: router logits differ or routes dropped")
            rels[impl] = [float((a.float() - b.float()).norm() / b.float().norm())
                          for a, b in zip((y, *gs), (y0, *g0))]
        print(f"moe train [one full-width layer, {layer_tokens[0]} x {layer_tokens[1]} tokens]: "
              f"relative to dense (out, dx, dgate, dup, ddown): " + "; ".join(
                  f"{k} {', '.join(f'{r:.2e}' for r in v)}" for k, v in rels.items())
              + f" (rtol {MOE_LAYER_RTOL})", flush=True)
        if any(r > MOE_LAYER_RTOL for v in rels.values() for r in v):
            fail(f"moe train [layer]: the impls disagree: {rels}")
        del runs, lp, x, w, y0, g0, moe

        # ---- the CLI on a depth-2 checkpoint, with the native loader
        t0 = time.time()
        save_checkpoint(str(work / "ckpt"), cfg2, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        r = run_mod.main(["--train_data", str(data), "--model_name_or_path", str(work / "ckpt"),
                          "--mode", "unified", "--lora", "--moe_impl", "dropless",
                          "--native_loader", "--per_device_train_batch_size", "4",
                          "--train_group_size", "2", "--max_steps", "2", "--save_steps", "0",
                          "--logging_steps", "1", "--learning_rate", "1e-4",
                          "--query_max_len", str(qlen), "--passage_max_len", str(plen),
                          "--generative_max_len", str(glen), "--output_dir", str(work / "run"),
                          "--device", dev.type])
        rows = [json.loads(line) for line in
                (work / "run" / "metrics.jsonl").read_text().splitlines()]
        print(f"moe train [training.run --lora --moe_impl dropless --native_loader, depth "
              f"{depths[1]}]: {r['steps']} steps in {time.time() - t0:.1f} s (checkpoint write, "
              f"load and export included), final {r['final']}", flush=True)
        if r["steps"] != 2 or not all(np.isfinite(v) for v in r["final"].values()) or len(
                rows) != 2 or not all("moe_dropped_frac" in row for row in rows):
            fail(f"moe train [training.run]: {r}, metrics {rows}")

        # ---- host ms a batch: the native loader against the Python pipeline
        native = NativeGritLoader([str(data)], batch_size=4, train_group_size=2,
                                  query_max_len=qlen, passage_max_len=plen,
                                  generative_max_len=glen, seed=0)
        t0 = time.perf_counter()
        n_native = sum(1 for _ in native.epoch(0))
        native_ms = (time.perf_counter() - t0) * 1e3 / max(n_native, 1)
        native.close()
        t0 = time.perf_counter()
        n_py = sum(1 for _ in batch_iterator(GritDataset(emb, gen, train_group_size=2, seed=0),
                                             coll, 4, seed=0))
        py_ms = (time.perf_counter() - t0) * 1e3 / max(n_py, 1)
        print(f"moe train [input pipeline, 4 x group 2 at {qlen}/{plen}/{glen}]: native "
              f"loader {native_ms:.2f} host ms a batch ({n_native} batches), Python pipeline "
              f"{py_ms:.2f} ({n_py} batches)", flush=True)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    path_launches["moe_train"] = counts
    print(f"moe train launches: {counts}; phase 15 {time.time() - t_phase:.0f} s", flush=True)
    if any(counts[n] == 0 for n in ("flash_attention", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")):
        fail("moe train: the phase did not go through K1, K4 and K5")
    torch.cuda.empty_cache()


def flash_bwd_checks(dev, randn, max_err, B=2, S=2048, H=32, Hkv=8, Dh=128,
                     window=512) -> None:
    """K4 and K5 against the plain backward from the same saved LSE at
    B 2, S 2048 (bf16; H 32, Hkv 8, Dh 128 unless given): causal with right
    padding, bidirectional with padding, causal with a 512 window, and a
    row whose keys are all masked (its gradients exactly 0); K1's LSE
    against the plain one; FlashAttentionFn against autograd through the
    plain forward. A head dim without an instance (96) runs the 128 ones
    through flash_attention_bwd's zero pad. At Dh 128 the first case's K4
    and K5 are rerun and required bit-equal. Errors go to max_err under the
    kernels' names, with a [dh64] or [dh96] suffix below Dh 128."""
    import torch

    from gritlm_tpu_torch.ops import flash_attention as fa

    suffix = "" if Dh == 128 else f"[dh{Dh}]"
    names = [n + suffix for n in ("flash_attention", "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")]
    geometry = f"B{B} S{S} H{H} Hkv{Hkv} Dh{Dh}"
    q, k, v, do = randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh), randn(B, S, H, Dh)
    pad = torch.ones((B, S), dtype=torch.int32, device=dev)
    pad[1, S * 3 // 4:] = 0
    empty = pad.clone()
    empty[0] = 0
    for i, (label, mask, causal, window) in enumerate((
            ("causal, right padding", pad, True, None),
            ("bidirectional, padding", pad, False, None),
            (f"causal, window {window}", pad, True, window),
            ("bidirectional, row 0 fully masked", empty, False, None))):
        kw = dict(causal=causal, sliding_window=window)
        out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
        torch.cuda.synchronize()
        _, lse_plain = fa.flash_attention_plain(q, k, v, mask, return_lse=True, **kw)
        lse_err = float((lse - lse_plain).abs().max())
        want = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, **kw)
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g).all():
                fail(f"flash backward [{label}] {name}: shape, dtype or non-finite values")
            err, mag = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
            errs.append(err)
            if err > BWD_RTOL * mag:
                fail(f"flash backward [{label}] {name} disagrees with the plain version: "
                     f"{err} > {BWD_RTOL} x {mag}")
            if mask is empty and float(g[0].abs().max()) != 0.0:
                fail(f"flash backward [{label}] {name}: the fully masked row's gradient is "
                     "not exactly 0")
        if lse_err > LSE_ATOL:
            fail(f"flash_attention [{label}] LSE disagrees with the plain version: {lse_err}")
        for name, err in zip(names, (lse_err, errs[0], max(errs[1:]))):
            max_err[name] = max(max_err.get(name, 0.0), err)
        print(f"check flash backward [{label}, {geometry}]: max_abs_err dq {errs[0]:.3e} "
              f"(K4), dk {errs[1]:.3e} dv {errs[2]:.3e} (K5), lse {lse_err:.3e}; largest "
              f"gradients {', '.join(f'{float(w.float().abs().max()):.3f}' for w in want)} "
              f"(rtol {BWD_RTOL} of the largest, LSE atol {LSE_ATOL})", flush=True)
        if Dh == 128 and i == 0:
            again = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"flash backward [{label}]: a rerun of K4 and K5 is not bit-equal")
            print(f"check flash backward [{label}, {geometry}]: a rerun of K4 and K5 bit-equal",
                  flush=True)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves, pad, True, None, 0)
    got = torch.autograd.grad(out, leaves, do)
    ref = fa.flash_attention_plain(*leaves, pad, causal=True)
    want = torch.autograd.grad(ref, leaves, do)
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    mags = [float(w.float().abs().max()) for w in want]
    print(f"check FlashAttentionFn against autograd through the plain forward [causal, "
          f"right padding, {geometry}]: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
          f"{errs[2]:.3e} (rtol {BWD_RTOL} of {', '.join(f'{m:.3f}' for m in mags)})",
          flush=True)
    if any(e > BWD_RTOL * m for e, m in zip(errs, mags)):
        fail("FlashAttentionFn's gradients depart from autograd through the plain forward")
    del q, k, v, do, leaves, out, got, ref, want
    torch.cuda.empty_cache()


def synthetic_train_data(path: Path, n: int = 16, seed: int = 0, negatives: int = 2) -> None:
    """Embedding and generative JSONL whose texts fill the default training
    lengths with the byte tokenizer (query 256, passage 2048, generative
    2048 tokens): seeded random words; n samples of each, `negatives`
    passages a query."""
    rng = np.random.default_rng(seed)
    words = " ".join(SENTENCES).lower().replace(",", "").replace(".", "").split()

    def text(n_chars: int) -> str:
        out = []
        while sum(len(w) + 1 for w in out) < n_chars:
            out.append(words[int(rng.integers(len(words)))])
        return " ".join(out)

    path.mkdir(parents=True, exist_ok=True)
    with open(path / "emb.jsonl", "w") as f:
        for _ in range(n):
            passage = ["Represent the passage for retrieval", ""]
            row = {"query": ["Given a question, retrieve the passage that answers it", text(320)],
                   "pos": [[passage[0], text(2300)]],
                   "neg": [[passage[0], text(2300)] for _ in range(negatives)]}
            f.write(json.dumps(row) + "\n")
    with open(path / "gen.jsonl", "w") as f:
        for _ in range(n):
            f.write(json.dumps({"text": [text(200), text(2000)]}) + "\n")


def train_argv(work: Path, model, lengths, dev) -> list:
    """training.run's arguments for a LoRA run on `work`/data with the
    reference's batch (4 queries, group 2) at `lengths` (query, passage,
    generative): 3 steps, a checkpoint at step 2; `model` is
    ["--model_preset", name] or ["--model_name_or_path", dir]."""
    qlen, plen, glen = lengths
    return ["--train_data", str(work / "data"), *model, "--mode", "unified",
            "--lora", "--per_device_train_batch_size", "4", "--train_group_size", "2",
            "--query_max_len", str(qlen), "--passage_max_len", str(plen),
            "--generative_max_len", str(glen), "--max_steps", "3", "--save_steps", "2",
            "--logging_steps", "1", "--learning_rate", "1e-4", "--output_dir",
            str(work / "run"), "--device", dev.type]


def lora_run_checks(dev, cfg, argv, base_fn, label: str) -> dict:
    """training.run.main with `argv` (train_argv): 3 steps with a checkpoint
    at step 2, finite losses; a run resumed from step 2 ends at step 3 with
    the same losses (rtol 1e-3); the export (<output_dir>/export) read back
    by load_checkpoint equal to merge(base_fn(), the saved step-3 adapters)
    with the run's config. Returns the base params (base_fn's, built after
    the runs have freed their models)."""
    import torch

    from gritlm_tpu_torch.models.loader import load_checkpoint
    from gritlm_tpu_torch.training import run
    from gritlm_tpu_torch.training.lora import merge
    from gritlm_tpu_torch.training.train import leaves

    out = Path(argv[argv.index("--output_dir") + 1])
    t0 = time.time()
    r1 = run.main(argv)
    t_run = time.time() - t0
    steps = sorted(os.listdir(out / "checkpoints"))
    print(f"train [{label}, run.main, LoRA, {cfg.num_hidden_layers} layers]: {r1['steps']} "
          f"steps in {t_run:.1f} s (model init, export included), final {r1['final']}; "
          f"checkpoints {steps}", flush=True)
    if r1["steps"] != 3 or "step_2" not in steps or not all(
            np.isfinite(v) for v in r1["final"].values()):
        fail(f"train [{label}, run.main]: {r1}, checkpoints {steps}")
    t0 = time.time()
    r2 = run.main(argv + ["--resume_from_checkpoint", str(out / "checkpoints" / "step_2")])
    print(f"train [{label}, run.main resumed from step_2]: to step {r2['steps']} in "
          f"{time.time() - t0:.1f} s, final {r2['final']}", flush=True)
    if r2["steps"] != 3:
        fail(f"train [{label}, resume]: ended at step {r2['steps']}")
    for key in ("loss", "loss_emb", "loss_gen"):
        a, b = r1["final"][key], r2["final"][key]
        if abs(a - b) > 1e-3 * max(abs(a), 1e-6):
            fail(f"train [{label}, resume]: step 3 {key} {b} after resuming, {a} uninterrupted")
    # the export against the merge of the base and the saved adapters
    t0 = time.time()
    saved = torch.load(out / "checkpoints" / "step_3" / "state" / "train_state.pt",
                       map_location=dev, weights_only=True)
    base = base_fn()
    merged = merge(base, saved["params"], 64 / 16)
    cfg_back, back = load_checkpoint(r2["export"], device=dev)
    n_export = sum(os.path.getsize(f) for f in Path(r2["export"]).iterdir())
    same = all(torch.equal(a, b) for a, b in zip(leaves(merged), leaves(back)))
    print(f"train [{label}, export]: {n_export / 2**30:.2f} GiB of safetensors read back in "
          f"{time.time() - t0:.1f} s (with the base and the merge); equal to the merged "
          f"weights: {same}", flush=True)
    if not same or cfg_back != cfg or len(leaves(back)) != len(leaves(merged)):
        fail(f"train [{label}, export]: load_checkpoint does not read back the merged weights")
    del merged, back, saved
    torch.cuda.empty_cache()
    return base


def first_batch(work: Path, lengths):
    """The first batch (4 queries, group 2) of the synthetic data under
    `work`/data at `lengths`, with its valid and padded token counts."""
    from gritlm_tpu_torch.tokenizer import ByteTokenizer
    from gritlm_tpu_torch.training.data import (
        GritCollator,
        GritDataset,
        batch_iterator,
        load_train_dirs,
    )

    qlen, plen, glen = lengths
    emb, gen = load_train_dirs([str(work / "data")])
    coll = GritCollator(ByteTokenizer(), query_max_len=qlen, passage_max_len=plen,
                        generative_max_len=glen)
    batch = next(batch_iterator(GritDataset(emb, gen, train_group_size=2, seed=0), coll, 4,
                                seed=0))
    valid = sum(int(part["attention_mask"].sum()) for part in batch.values())
    padded = sum(part["attention_mask"].size for part in batch.values())
    return batch, valid, padded


def timed_steps(run_step, state, batch, n: int):
    """n steps of run_step on one batch: (state, losses, median host s a
    step over steps 2..n, peak GiB allocated since the first)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run_step(state, batch)
        losses.append(float(m.loss))
        step_s.append(time.perf_counter() - t0)
    return (state, losses, statistics.median(step_s[1:]),
            torch.cuda.max_memory_allocated() / 2**30)


def full_parameter_steps(dev, cfg, batch, valid: int, ckpt_dir=None) -> None:
    """3 full-parameter train steps of `cfg` (random weights, seed 2) on one
    batch: finite losses; ms a step (median of steps 2-3), valid tokens/s
    and the peak GiB the params, their state and the steps took. With
    `ckpt_dir`, the state after the steps is saved there as a training
    checkpoint (training/checkpoint.CheckpointManager: step_3/state)."""
    import torch

    from gritlm_tpu_torch.models.transformer import count_params, init_params
    from gritlm_tpu_torch.training.checkpoint import CheckpointManager
    from gritlm_tpu_torch.training.train import TrainConfig, init_train_state, train_step

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    params = init_params(cfg, 2, device=dev)
    n_params = count_params(params)
    tc = TrainConfig(total_steps=3)
    state = init_train_state(params, tc)
    del params
    state, losses, med, peak = timed_steps(lambda st, b: train_step(st, b, cfg, tc), state,
                                           batch, 3)
    peak -= base_mem / 2**30
    print(f"train [full parameters, {cfg.num_hidden_layers} layers]: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {med * 1e3:.1f} ms per step (median of "
          f"steps 2-3, host clock) = {valid / med:.0f} valid tokens/s; {n_params / 1e9:.3f} B "
          f"parameters, peak {peak:.2f} GiB (params, grads and two AdamW moments in bf16 "
          f"{4 * 2 * n_params / 2**30:.2f} GiB, the rest activations and transients)",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train [full parameters, {cfg.num_hidden_layers} layers]: losses {losses}")
    if ckpt_dir is not None:
        t0 = time.time()
        path = CheckpointManager(str(ckpt_dir)).save(state)
        print(f"train [full parameters]: state saved to {Path(path).name} in "
              f"{time.time() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()


# phase 10's LoRA and QLoRA steps on one batch: Mistral-7B width at 16
# layers (32 before phase 20; the time limit)
TRAIN_BATCH_DEPTH = 16


def training_phase(dev, reset_counts, read_counts, path_launches, preset="mistral_7b",
                   lengths=(256, 2048, 2048), depth=4) -> None:
    """GRIT training at Mistral-7B width (counts set to 0 before, read
    after): LoRA at depth 4 through training.run.main --model_name_or_path
    (3 steps, a checkpoint at step 2, a run resumed from it, the export read
    back equal; 32 layers before phase 20, whose run wrote and read back a
    13.5 GiB export); 4 LoRA steps on one batch and 3 QLoRA steps (the base
    in int8) on the same batch at TRAIN_BATCH_DEPTH; GradCache against the full
    batch and full-parameter training at depth 4 (for the script's time
    limit: phase 17 trains full parameters at full depth, on
    Llama-3.2-1B)."""
    import dataclasses
    import shutil

    import torch

    from gritlm_tpu_torch import config as cfgmod
    from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from gritlm_tpu_torch.models.transformer import count_params, init_params
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig, init_train_state, leaves, train_step

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    synthetic_train_data(work / "data")
    cfg = getattr(cfgmod, preset)()
    cfg4 = dataclasses.replace(cfg, num_hidden_layers=depth)
    argv = train_argv(work, ["--model_preset", preset], lengths, dev)
    base4 = work / "cli_base"
    save_checkpoint(str(base4), cfg4, init_params(cfg4, 42, device=dev))
    torch.cuda.empty_cache()
    cli_argv = train_argv(work, ["--model_name_or_path", str(base4)], lengths, dev)
    reset_counts()
    try:
        lora_run_checks(dev, cfg4, cli_argv, lambda: load_checkpoint(str(base4), device=dev)[1],
                        f"{preset}, depth {depth}")
        shutil.rmtree(base4, ignore_errors=True)
        cfg = dataclasses.replace(cfg, num_hidden_layers=min(cfg.num_hidden_layers,
                                                             TRAIN_BATCH_DEPTH))
        base = init_params(cfg, 42, device=dev)

        # ---- it learns: 4 LoRA steps on one fixed batch at lr 1e-4 (6 before
        # phase 19: the time limit)
        batch, valid, padded = first_batch(work, lengths)
        tc = TrainConfig(learning_rate=1e-4, total_steps=4)
        run_step, state, _, _ = make_lora_train_state(cfg, tc, base, seed=0, device=dev)
        state, losses, med, peak = timed_steps(run_step, state, batch, 4)
        print(f"train [LoRA, {cfg.num_hidden_layers} layers, one batch, lr 1e-4]: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; {med * 1e3:.1f} ms per step "
              f"(median of steps 2-4, host clock) = {valid / med:.0f} valid tokens/s, "
              f"{padded / med:.0f} padded tokens/s ({valid} valid of {padded} padded tokens "
              f"a step); peak {peak:.2f} GiB; {count_params(state.params) / 1e6:.1f} M "
              "trained parameters", flush=True)
        if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
            fail(f"train [learns]: losses {losses}")
        profile_window(f"LoRA train step, {cfg.num_hidden_layers} layers",
                       lambda: run_step(state, batch))
        del state, run_step

        # ---- QLoRA: the same base quantized to int8 (the bf16 copy freed), 3 steps
        run_step, state, _, _ = make_lora_train_state(cfg, tc, base, seed=0, device=dev,
                                                      quantize=True)
        del base
        torch.cuda.empty_cache()
        state, losses, med, peak_q = timed_steps(run_step, state, batch, 3)
        print(f"train [QLoRA, int8 base, {cfg.num_hidden_layers} layers, one batch]: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; {med * 1e3:.1f} ms per step (median "
              f"of steps 2-3, host clock) = {valid / med:.0f} valid tokens/s; peak "
              f"{peak_q:.2f} GiB against LoRA's {peak:.2f} GiB", flush=True)
        if not all(np.isfinite(losses)):
            fail(f"train [QLoRA]: losses {losses}")
        del state, run_step
        torch.cuda.empty_cache()

        # ---- GradCache against the full batch, depth 4, full parameters
        params = init_params(cfg4, 1, device=dev)
        runs = []
        for gc in (1, 2):
            tc = TrainConfig(gc_chunks=gc, total_steps=10)  # update 1 has LR 0: params stay
            state = init_train_state(params, tc)
            state, m = train_step(state, batch, cfg4, tc)
            grads = [t.grad.float() for t in leaves(state.params)]
            norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
            runs.append((m, [g / norm for g in grads]))
            params = state.params
        (m1, g1), (m2, g2) = runs
        cos = float(sum((a * b).sum() for a, b in zip(g1, g2)))
        leaf_cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(g1, g2)]
        worst = int(np.argmin(leaf_cos))
        le1, le2 = float(m1.loss_emb), float(m2.loss_emb)
        print(f"train [GradCache, {depth} layers]: loss_emb {le2:.5f} with gc_chunks 2, "
              f"{le1:.5f} with 1; gradient cosine {cos:.6f} (min {COSINE_MIN}), per "
              f"parameter from {leaf_cos[worst]:.6f} (leaf {worst} of {len(leaf_cos)}, "
              f"shape {tuple(g1[worst].shape)}); loss_gen {float(m2.loss_gen):.5f} / "
              f"{float(m1.loss_gen):.5f}", flush=True)
        if abs(le1 - le2) > GC_LOSS_RTOL * abs(le1) or cos < COSINE_MIN:
            fail("train [GradCache]: gc_chunks 2 departs from the full batch")
        del runs, g1, g2, grads, state, params
        torch.cuda.empty_cache()

        # ---- full-parameter training, depth 4
        full_parameter_steps(dev, cfg4, batch, valid)

        # ---- the projection head: run.main --projection, full parameters, depth 4
        projection_training(dev, cfg4, work, argv)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    path_launches["training"] = counts
    print(f"training launches: {counts}")
    if any(counts[n] == 0 for n in ("flash_attention", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")):
        fail("training did not go through K1, K4 and K5")
    torch.cuda.empty_cache()


def projection_training(dev, cfg4, work: Path, lora_argv) -> None:
    """`training.run --model_name_or_path <a depth-4 checkpoint of the
    width> --projection PROJECTION`, full parameters, 3 steps on the phase's
    data: finite losses, the head moved from its draw (init_projection at
    the run's seed + 1), and the export reloads through
    GritLM.from_pretrained and encodes to PROJECTION columns."""
    import torch

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from gritlm_tpu_torch.models.transformer import init_params, init_projection
    from gritlm_tpu_torch.training import run

    base = work / "base4"
    save_checkpoint(str(base), cfg4, init_params(cfg4, 3, device=dev))
    argv = [a for a in lora_argv if a != "--lora"]
    i = argv.index("--model_preset")
    argv[i:i + 2] = ["--model_name_or_path", str(base)]
    for flag, value in (("--output_dir", str(work / "projection")), ("--save_steps", "0")):
        argv[argv.index(flag) + 1] = value
    argv += ["--projection", str(PROJECTION)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    r = run.main(argv)
    t_run = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    seed = json.loads((work / "projection" / "run_args.json").read_text())["seed"]
    start = init_projection(cfg4, PROJECTION, seed + 1, device=dev)
    _, back = load_checkpoint(r["export"], device=dev)
    head = back["projection"]["kernel"]
    moved = float((head.float() - start["kernel"].float()).abs().max())
    del back
    pm = GritLM.from_pretrained(r["export"])
    emb = pm.encode(SENTENCES[:4])
    print(f"train [--projection {PROJECTION}, full parameters, {cfg4.num_hidden_layers} "
          f"layers, run.main]: {r['steps']} steps in {t_run:.1f} s (model load and export "
          f"included), final {r['final']}; peak {peak:.2f} GiB; the head moved by up to "
          f"{moved:.3e}; the export encodes to {emb.shape}", flush=True)
    if r["steps"] != 3 or not all(np.isfinite(v) for v in r["final"].values()):
        fail(f"train [--projection]: {r}")
    if tuple(head.shape) != (cfg4.hidden_size, PROJECTION) or moved == 0.0:
        fail(f"train [--projection]: head {tuple(head.shape)} moved by {moved}")
    if emb.shape != (4, PROJECTION) or not np.isfinite(emb).all():
        fail(f"train [--projection]: the export encodes to {emb.shape}")
    del pm, start
    torch.cuda.empty_cache()


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """ms of one call of fn between two CUDA events around `reps` calls
    launched back to back (after warm-up): the device's time for the calls,
    which never reads low when a profiler trace drops kernels."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_names(fn, top: int = 6) -> str:
    """The device kernels of one call of fn by torch.profiler, largest
    first, as 'ms name' (for a library call: which backend ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        return "(no device events recorded)"
    events.sort(key=lambda e: -e.self_device_time_total)
    return "; ".join(f"{e.self_device_time_total / 1e3:.4f} ms {e.key[:80]}"
                     for e in events[:top])


def training_times(dev, randn, times, H=32, Hkv=8, Dh=128,
                   shapes=((8, 2048, False), (4, 2048, True)), f32=False) -> None:
    """K1 with its LSE, K4 and K5 at the passage shape (B 8, S 2048, 32/8
    heads, bidirectional, no padding) and at the generative shape (B 4,
    S 2048, causal), at head dim Dh (a compiled instance: 128 or 64; the
    rows' names take a [dh64] suffix at 64), beside their bounds and the backward of
    scaled_dot_product_attention on the same inputs (one library call that
    computes dq, dk and dv together; `is_causal` for the causal row). With
    `f32` (randn then draws fp32), the fp32 forms (rows' names with F32),
    bound at the card's fp32 FMA rate (f32_peak), beside SDPA at fp32 (TF32
    off; its backend printed). Each
    time is taken two ways: CUDA events around calls launched back to back
    (the figure kept) and torch.profiler's device sum; the plain versions'
    by the events alone (the profiler dropped most of their kernels once,
    reading them below the kernels' own times). Operations count the
    (query, key) pairs the mask keeps: one product is 2 x pairs x heads x
    Dh; the library does 5 products, K4 3 and K5 4. A reading above the
    card's peak is impossible: it is marked invalid and the table's library
    time is then null. The bidirectional row fills `times`."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.ops import flash_attention as fa
    from gritlm_tpu_torch.ops.flash_attention import keep_mask

    suffix, tag = ("", "") if Dh == 128 else (f"[dh{Dh}]", f" Dh{Dh}")
    if f32:
        suffix, tag = suffix + F32, tag + " fp32"
    peak = f32_peak() if f32 else PEAK_BF16_FLOPS
    for B, S, causal in shapes:
        label = f"B{B} S{S} {'causal' if causal else 'bidirectional'}{tag}"
        q, k, v, do = (randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh),
                       randn(B, S, H, Dh))
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        kw = dict(causal=causal)
        out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
        delta = fa.attention_delta(out, do)
        pairs = int(keep_mask(mask, S, S, causal=causal, sliding_window=None, offset=0,
                              device=dev).expand(B, -1, -1).sum())
        product = 2.0 * pairs * H * Dh  # one product over every kept (query, key) pair
        ins = nbytes(q, k, v, do, lse, delta, mask)

        def tflops(n_products, ms):
            rate = n_products * product / (ms * 1e-3) / 1e12
            return rate, peak_note(rate, peak / 1e12)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        if f32:
            print(f"  SDPA backend at fp32 [{label}]: {sdpa_backend(qt, kt, vt, None)}",
                  flush=True)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

        lib_ev = event_ms(library)
        lib_prof, _ = time_ms(library, reps=10)
        rate_ev, bad_ev = tflops(5, lib_ev)
        rate_prof, bad_prof = tflops(5, lib_prof)
        print(f"time library [{label}] backward of scaled_dot_product_attention (dq, dk, dv): "
              f"events {lib_ev:.4f} ms = {rate_ev:.1f} TFLOP/s{bad_ev}; profiler "
              f"{lib_prof:.4f} ms = {rate_prof:.1f} TFLOP/s{bad_prof} (5 products of "
              f"{product / 1e9:.1f} GFLOP, {pairs} kept pairs); kernels: "
              f"{kernel_names(library)}", flush=True)
        lib_ms = None if bad_ev else lib_ev  # an impossible reading stays out of the table
        rows = {
            "flash_attention_bwd_dq" + suffix: (
                lambda: fa.flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, **kw),
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta, **kw),
                3, ins + nbytes(q)),
            "flash_attention_bwd_dkv" + suffix: (
                lambda: fa.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, **kw),
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta, **kw),
                4, ins + nbytes(k, v)),
        }
        pair_ms = 0.0
        for name, (fk, fp, n_products, byt) in rows.items():
            ms = event_ms(fk)
            prof_ms, _ = time_ms(fk, reps=10)
            pair_ms += ms
            bms, by = bound(n_products * product, byt, peak)
            rate, bad = tflops(n_products, ms)
            plain_ms = event_ms(fp, reps=2, warmup=1)
            plain = f", plain {plain_ms:.4f}"
            if not causal:
                times[name] = (ms, plain_ms, lib_ms, bms, by)
            print(f"time {name} [{label}]: events {ms:.4f} ms = {rate:.1f} TFLOP/s{bad} "
                  f"({bms / ms * 100:.1f}% of bound {bms:.4f} ms, {by}); profiler "
                  f"{prof_ms:.4f} ms{plain}; library {lib_ev:.4f} (events)", flush=True)
        print(f"time K4 + K5 [{label}]: {pair_ms:.4f} ms against the library's {lib_ev:.4f} "
              f"({pair_ms / lib_ev:.2f}x{'' if lib_ms else ', library reading INVALID'})",
              flush=True)
        # K1 with its LSE (the training forward) beside SDPA's forward on
        # inputs that require grad (it then also keeps what its backward needs)
        ms = event_ms(lambda: fa.flash_attention(q, k, v, mask, return_lse=True, **kw))
        prof_ms, _ = time_ms(lambda: fa.flash_attention(q, k, v, mask, return_lse=True, **kw),
                             reps=10)
        ms0 = event_ms(lambda: fa.flash_attention(q, k, v, mask, **kw))

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_f = event_ms(lib_fwd)
        lib_f_prof, _ = time_ms(lib_fwd, reps=10)
        bms, by = bound(2 * product, nbytes(q, k, v, mask, q) + B * H * S * 4, peak)
        rate, bad = tflops(2, ms)
        lib_rate, lib_bad = tflops(2, lib_f)
        prof_bad, lib_prof_bad = tflops(2, prof_ms)[1], tflops(2, lib_f_prof)[1]
        plain_f = event_ms(lambda: fa.flash_attention_plain(
            q, k, v, mask, return_lse=True, **kw), reps=2, warmup=1)
        plain = f"; plain {plain_f:.4f}"
        print(f"time flash_attention with LSE [{label}]: events {ms:.4f} ms = {rate:.1f} "
              f"TFLOP/s{bad} ({bms / ms * 100:.1f}% of bound {bms:.4f} ms, {by}); profiler "
              f"{prof_ms:.4f} ms{prof_bad}; without LSE {ms0:.4f} (events){plain}; library "
              f"(scaled_dot_product_attention forward) events {lib_f:.4f} = {lib_rate:.1f} "
              f"TFLOP/s{lib_bad}, profiler {lib_f_prof:.4f}{lib_prof_bad}; K1 / library "
              f"{ms / lib_f:.2f}x", flush=True)
        del q, k, v, do, qt, kt, vt, lib_out, out, lse, delta
        torch.cuda.empty_cache()


# Phase 16: Llama-3.2-1B at its published width and depth, random bf16
# weights: the values of meta-llama/Llama-3.2-1B's config.json
# (https://huggingface.co/meta-llama/Llama-3.2-1B/blob/main/config.json).
# Head dim 64, 32 query heads over 8 KV heads, tied embeddings, llama3 RoPE
# scaling: 1.236 B parameters, 2.47 GB in bf16, 32 KiB of bf16 KV a token.
LLAMA_32_1B = {
    "model_type": "llama", "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32, "num_key_value_heads": 8,
    "head_dim": 64, "vocab_size": 128256, "max_position_embeddings": 131072,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "torch_dtype": "bfloat16",
}
LLAMA = "llama-3.2-1b"  # its paths' keys in the launch counts: serving (16) ...
LLAMA_PATHS = (LLAMA, f"{LLAMA} rag", f"{LLAMA} training")  # ... RAG (16), training (17)
# phase 17's LoRA loss with the fused LM head against the unfused one: fp32
# logits from the bf16 hidden state and head against logits rounded to bf16
FUSED_CE_RTOL = 1e-2
# K1, K3, K8 (phase 16) and K4, K5 (phase 17) checked at (Dh, H, Hkv):
# Llama-3.2-1B, the Qwen2-0.5B geometry (group 7, Kv * Dh 128) and Dh 96
# (K1, K4 and K5 through their zero-pad to 128)
HEAD_DIM_GEOMETRIES = ((64, 32, 8), (64, 14, 2), (96, 16, 8))
# the kernels line's rows of the Dh-64 instances: name -> the wrapper's
# name; their launches are the wrapper's on the Llama-3.2-1B paths
DH64_ROWS = {"flash_attention[dh64]": "flash_attention", "flash_decode[dh64]": "flash_decode",
             "paged_decode[dh64]": "paged_decode",
             "flash_attention_bwd_dq[dh64]": "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv[dh64]": "flash_attention_bwd_dkv"}


def head_dim_checks(dev, randn, max_err) -> None:
    """K1, K3 and K8 against their plain versions at each of
    HEAD_DIM_GEOMETRIES: K1's phase-2 shapes with their LSE (k1_cases), K3's
    (k3_cases: Sq 1 and 64, the int8 cache, the serving call), the verify
    chunk with [B] offsets, bf16 and int8, bit-equal to K8 (k3_verify), and
    K8's serving shapes, bf16 and int8 pages of 256 slots, Sq 1 and the
    causal Sq 8 chunk (k8_cases). Errors go to max_err under the kernel's
    name with a [dh64] or [dh96] suffix."""
    import torch

    for Dh, H, Hkv in HEAD_DIM_GEOMETRIES:
        suffix = f"[dh{Dh}]"
        print(f"head dim {Dh}, H {H}, Hkv {Hkv}:", flush=True)
        cases, lse_cases = [], []
        k1_cases(dev, randn, cases, lse_cases, H, Hkv, Dh, name="flash_attention" + suffix)
        k3_cases(dev, randn, cases, H, Hkv, Dh, name="flash_decode" + suffix)
        k8_cases(dev, randn, cases, 8, H, Hkv, Dh, name="paged_decode" + suffix)
        check_cases(cases, lse_cases, max_err)
        del cases, lse_cases
        k3_verify(dev, randn, None, max_err, H, Hkv, Dh, name="flash_decode" + suffix,
                  timed=False)
        torch.cuda.empty_cache()


def k1_times(dev, randn, times, H=32, Hkv=8, Dh=64, name="flash_attention[dh64]") -> None:
    """K1 at head dim Dh, the encode shape (bidirectional B 4 S 512, a padded
    tail: the table's row) and the prefill shape with its LSE (causal B 8 S
    2048), by CUDA events around replays of a graph of ten calls, beside
    SDPA the same way and the bound; the plain version timed at the first
    shape."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.ops import flash_attention
    from gritlm_tpu_torch.ops.flash_attention import keep_mask

    for label, B, S, causal in (("bidirectional B4 S512", 4, 512, False),
                                ("causal LSE B8 S2048", 8, 2048, True)):
        q, k, v = randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh)
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        mask[-1, S * 3 // 4:] = 0
        keep = keep_mask(mask, S, S, causal=causal, sliding_window=None, offset=0,
                         device=dev).expand(B, S, S)
        bms, by = bound(4.0 * int(keep.sum()) * H * Dh,
                        int(keep.any(1).sum()) * Hkv * Dh * 2 * 2 + nbytes(q, q, mask)
                        + (B * H * S * 4 if causal else 0))
        qt, kt, vt, am = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), keep[:, None]

        def call(q=q, k=k, v=v, mask=mask, causal=causal):
            return flash_attention.flash_attention(q, k, v, mask, causal=causal,
                                                   return_lse=causal)

        def library(qt=qt, kt=kt, vt=vt, am=am):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, enable_gqa=True)

        ms, library_ms = graph_ms(call, calls=10), graph_ms(library, calls=10)
        rate, lib_rate = (4.0 * int(keep.sum()) * H * Dh / (t * 1e-3) / 1e12
                          for t in (ms, library_ms))
        line = (f"time {name} [{label}]: {ms:.4f} ms = {rate:.1f} TFLOP/s"
                f"{peak_note(rate, PEAK_BF16_FLOPS / 1e12)} ({bms / ms * 100:.1f}% of bound "
                f"{bms:.4f} ms, {by}); library (scaled_dot_product_attention) "
                f"{library_ms:.4f} ms = {lib_rate:.1f} TFLOP/s"
                f"{peak_note(lib_rate, PEAK_BF16_FLOPS / 1e12)} (CUDA graph replays)")
        if peak_note(lib_rate, PEAK_BF16_FLOPS / 1e12):
            library_ms = None  # an impossible reading stays out of the table
        if name not in times:  # the table's row
            plain_ms = time_ms(lambda: flash_attention.flash_attention_plain(
                q, k, v, mask, causal=causal), reps=10)[0]
            times[name] = (ms, plain_ms, library_ms, bms, by)
            line += f"; plain {plain_ms:.4f}"
        print(line, flush=True)
        del q, k, v, qt, kt, vt, am, keep
        torch.cuda.empty_cache()


def llama_phase(dev, randn, reset_counts, read_counts, path_launches, times, max_err,
                t_start) -> None:
    """Phase 16: head dims 64 and 96 (head_dim_checks), then Llama-3.2-1B at
    its published width and depth (LLAMA_32_1B through
    ModelConfig.from_hf_config), random bf16 weights from seed 0, with the
    launch counts set to 0 before each run and summed after: encode of the
    16 sentences (K1 + K2) at cosine >= COSINE_MIN to the same model through
    the plain versions, sentences/s; greedy generate at B = 2 (32 tokens),
    every token within TIE_TOL by teacher forcing, the decode step's device
    and host ms and idle share; phase 7's serving workload (24 generation
    and 8 embedding requests) through dense, paged and paged-int8 pools
    (INT8_KV_TIE_TOL over int8 KV), tokens/s and TTFT p50; RAGEngine over
    the 16 passages in the seven cache modes (rag_phase). K1, K2, K3, K8
    and K9 must each launch. Then the Dh-64 rows' times: K1 (k1_times), K3
    (k3_times, and the verify chunk by k3_verify) and K8 (k8_times) at the
    Llama-3.2-1B heads."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import ModelConfig
    from gritlm_tpu_torch.models.transformer import count_params
    from gritlm_tpu_torch.ops import flash_attention, fused_pool
    from gritlm_tpu_torch.serving import ServingEngine

    t_phase = time.time()
    head_dim_checks(dev, randn, max_err)
    print(f"phase 16: head-dim checks {time.time() - t_phase:.0f} s", flush=True)
    cfg = ModelConfig.from_hf_config(LLAMA_32_1B)
    if cfg.dtype != "bfloat16" or cfg.rope_scaling_type != "llama3" or any(
            getattr(cfg, key) != LLAMA_32_1B[key] for key in (
                "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "head_dim", "vocab_size", "tie_word_embeddings")):
        fail(f"phase 16: the Llama-3.2-1B config reads as {cfg}")
    t0 = time.time()
    model = GritLM(cfg, seed=0)  # random bf16 weights drawn on the card
    torch.cuda.synchronize()
    print(f"model [phase 16]: Llama-3.2-1B width and depth, {count_params(model.params) / 1e9:.3f} "
          f"B params, head dim {cfg.head_dim_}, init {time.time() - t0:.1f} s", flush=True)
    total = {}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        for n, c in read_counts().items():
            total[n] = total.get(n, 0) + c
        return out

    def encode_all():
        a = model.encode(SENTENCES[:8])
        b = model.encode(SENTENCES[8:], instruction=INSTRUCTION)
        return torch.cat([torch.from_numpy(a), torch.from_numpy(b)])

    emb = counted(encode_all)
    if tuple(emb.shape) != (16, cfg.hidden_size) or not torch.isfinite(emb).all():
        fail(f"encode [phase 16]: shape {tuple(emb.shape)} or non-finite values")
    if float((emb.norm(dim=-1) - 1).abs().max()) > 1e-3:
        fail("encode [phase 16]: embeddings are not unit vectors")
    wrapped = ((flash_attention, "flash_attention"), (fused_pool, "fused_norm_mean_pool"))
    saved = [getattr(mod, n) for mod, n in wrapped]
    for mod, n in wrapped:  # the same model through the plain versions on the card
        setattr(mod, n, getattr(mod, n + "_plain"))
    try:
        emb_plain = encode_all()
    finally:
        for (mod, n), fn in zip(wrapped, saved):
            setattr(mod, n, fn)
    cos = F.cosine_similarity(emb, emb_plain, dim=-1)
    print(f"encode [phase 16] kernels vs plain versions: min cosine {float(cos.min()):.6f}",
          flush=True)
    if cos.min() < COSINE_MIN:
        fail(f"encode [phase 16] through the kernels departs from the plain versions: "
             f"{cos.tolist()}")
    torch.cuda.synchronize()
    t0 = time.time()
    encode_all()
    torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"encode [phase 16]: 16 sentences in {dt * 1e3:.1f} ms = {16 / dt:.1f} sentences/s",
          flush=True)

    tok = model.tokenizer
    enc = tok(["<s><|user|>\n" + SENTENCES[4] + " " + SENTENCES[7] + "\n<|assistant|>\n",
               "<s><|user|>\nExplain: " + SENTENCES[2] + "\n<|assistant|>\n"])
    res = counted(lambda: model.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                                  max_new_tokens=32))
    gaps = torch.cat([teacher_deficits(
        model, enc["input_ids"][b, :int(enc["attention_mask"][b].sum())].tolist(),
        res.tokens[b, :int(res.num_valid[b])].tolist()) for b in range(2)])
    print(f"generate [phase 16]: B=2, {int(res.num_valid.sum())} tokens; teacher forcing: "
          f"largest deficit {float(gaps.max()):.4f} (TIE_TOL {TIE_TOL}), the argmax at "
          f"{float((gaps == 0).float().mean()):.3f} of them", flush=True)
    if float(gaps.max()) > TIE_TOL:
        fail(f"generate [phase 16]: a token is {float(gaps.max())} below its position's max logit")
    decode_step(LLAMA, model, enc)

    drive, specs = serving_workload(model, reset_counts, read_counts, total)
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=dev)
    rates = {}
    for label, pool, tol in (("dense bf16", {}, TIE_TOL),
                             ("paged bf16", dict(paged=True, page_size=256), TIE_TOL),
                             ("paged int8", dict(paged=True, page_size=256, kv_quant=True),
                              INT8_KV_TIE_TOL)):
        eng = ServingEngine(cfg, model.params, **pool, **kw)
        run = drive(f"{LLAMA} {label}", eng, specs, 8, tie_tol=tol)
        rates[label] = (run["rate"], run["ttft50"])
        del eng, run
        gc.collect()
    print(f"serving [phase 16]: generated tokens/s and TTFT p50 by pool: " + ", ".join(
        f"{k} {r:.1f} tok/s, {t:.3f} s" for k, (r, t) in rates.items()), flush=True)
    print(f"phase 16: model paths {time.time() - t_phase:.0f} s", flush=True)

    rag_key = f"{LLAMA} rag"
    rag_eng = rag_phase(model, reset_counts, read_counts, path_launches, key=rag_key)
    del rag_eng
    path_launches[LLAMA] = total
    launched = {n: total.get(n, 0) + path_launches[rag_key].get(n, 0) for n in total}
    print(f"{LLAMA} launches (encode, generate, serving, rag): {launched}", flush=True)
    for n in ("flash_attention", "fused_norm_mean_pool", "flash_decode", "paged_decode",
              "scores_segmax"):
        if launched.get(n, 0) == 0:
            fail(f"phase 16: {n} was never launched on the Llama-3.2-1B paths")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    k1_times(dev, randn, times)
    k3_times(dev, randn, times, H=32, Hkv=8, Dh=64, name="flash_decode[dh64]")
    k3_verify(dev, randn, times, max_err, H=32, Hkv=8, Dh=64, name="flash_decode[dh64]")
    k8_times(dev, randn, times, H=32, Hkv=8, Dh=64, name="paged_decode[dh64]")
    print(f"phase 16: {time.time() - t_phase:.0f} s; total {time.time() - t_start:.0f} s",
          flush=True)


def hf_keys(cfg) -> set:
    """The tensor names an HF export of a dense (not MoE) config holds, as
    the JAX package's exporter (gritlm_tpu/models/loader.py save_checkpoint)
    writes them: no lm_head.weight when the embeddings are tied."""
    keys = {"model.embed_tokens.weight", "model.norm.weight"}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        keys |= {f"{p}.input_layernorm.weight", f"{p}.post_attention_layernorm.weight"}
        keys |= {f"{p}.self_attn.{x}_proj.weight" for x in "qkvo"}
        keys |= {f"{p}.mlp.{x}_proj.weight" for x in ("gate", "up", "down")}
        if cfg.attention_bias:
            keys |= {f"{p}.self_attn.{x}_proj.bias" for x in "qkv"}
    if not cfg.tie_word_embeddings:
        keys.add("lm_head.weight")
    return keys


def safetensors_keys(path: Path) -> set:
    """The tensor names of every safetensors file under `path`, from their
    headers alone."""
    import struct

    keys = set()
    for f in sorted(path.glob("*.safetensors")):
        with open(f, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            keys |= set(json.loads(fh.read(n))) - {"__metadata__"}
    return keys


def bwd_dh96_times(dev, randn, B=8, S=2048, H=16, Hkv=8, Dh=96) -> None:
    """The backward at Dh 96 (flash_attention_bwd: q, k, v and dO zero-padded
    to 128, K4 and K5 at 128 with scale 96^-0.5, the gradients sliced back)
    at the passage shape (B 8, S 2048, bidirectional, H 16, Hkv 8), by CUDA
    events around calls launched back to back, beside the bound of the same
    work at Dh 96 (7 products of 2 x pairs x H x 96 operations) and the
    backward of scaled_dot_product_attention at Dh 96 and the plain
    backward; the kernels alone on inputs padded beforehand."""
    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch.ops import flash_attention as fa

    q, k, v, do = randn(B, S, H, Dh), randn(B, S, Hkv, Dh), randn(B, S, Hkv, Dh), randn(B, S, H, Dh)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    out, lse = fa.flash_attention(q, k, v, mask, causal=False, return_lse=True)
    delta = fa.attention_delta(out, do)
    ms = event_ms(lambda: fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal=False))
    padded = [F.pad(t, (0, 128 - Dh)) for t in (q, k, v, do)]
    kw = dict(causal=False, scale=Dh ** -0.5)
    ms_kernels = event_ms(lambda: (fa.flash_attention_bwd_dq(*padded[:3], mask, padded[3], lse,
                                                             delta, **kw),
                                   fa.flash_attention_bwd_dkv(*padded[:3], mask, padded[3], lse,
                                                              delta, **kw)))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    lib_ms = event_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                  retain_graph=True))
    plain_ms = event_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, do,
                                                             causal=False), reps=2, warmup=1)
    flops = 7 * 2.0 * B * S * S * H * Dh
    bms, by = bound(flops, nbytes(q, k, v, do, lse, delta, mask, q, k, v))
    print(f"time flash_attention_bwd [dh96, B{B} S{S} bidirectional H{H} Hkv{Hkv}]: "
          f"{ms:.4f} ms with the pads and slices, {ms_kernels:.4f} ms K4 + K5 at width 128 "
          f"({bms / ms * 100:.1f}% of the Dh-96 bound {bms:.4f} ms, {by}); library "
          f"(scaled_dot_product_attention backward, Dh 96) {lib_ms:.4f} ms; plain "
          f"{plain_ms:.4f} (events)", flush=True)
    del q, k, v, do, out, lse, delta, padded, qt, kt, vt, lib_out
    torch.cuda.empty_cache()


def llama_train_phase(dev, randn, reset_counts, read_counts, path_launches, times, max_err,
                      work: Path, lengths=(256, 2048, 2048)) -> None:
    """Phase 17: GRIT training of Llama-3.2-1B at its published width and
    depth (LLAMA_32_1B: head dim 64, tied embeddings), random bf16 weights
    from seed 42 written as a checkpoint. First K4 and K5 (and K1's LSE)
    against the plain backward at HEAD_DIM_GEOMETRIES (flash_bwd_checks).
    Then, with the counts set to 0 before and read after: LoRA through
    training.run.main --model_name_or_path on phase 10's synthetic JSONL at
    the reference's lengths (3 steps, a checkpoint at step 2, a resumed
    run, the export read back equal and holding the JAX exporter's tensor
    names: no lm_head); 4 LoRA steps on one batch (the loss falls); 2 of
    them again with the fused LM-head loss (losses within FUSED_CE_RTOL);
    3 QLoRA steps; 3 full-parameter steps at full depth, their state saved
    as a training checkpoint (`work`/full); for each ms a step, valid
    tokens/s and peak GiB. K1, K4 and K5 must each launch (all at Dh 64).
    Then the [dh64] rows of K4 and K5 (training_times at Dh 64), K1 [dh96]
    (k1_times) and the padded Dh-96 backward (bwd_dh96_times). `work` is
    left for phase 18's tools leg (the export under `work`/run/export, the
    checkpoint under `work`/full); the caller removes it."""
    import dataclasses
    import shutil

    import torch

    from gritlm_tpu_torch.config import ModelConfig
    from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from gritlm_tpu_torch.models.transformer import count_params, init_params
    from gritlm_tpu_torch.training.lora import make_lora_train_state
    from gritlm_tpu_torch.training.train import TrainConfig

    t_phase = time.time()
    for Dh, H, Hkv in HEAD_DIM_GEOMETRIES:
        flash_bwd_checks(dev, randn, max_err, H=H, Hkv=Hkv, Dh=Dh)
    print(f"phase 17: backward checks {time.time() - t_phase:.0f} s", flush=True)
    cfg = ModelConfig.from_hf_config(LLAMA_32_1B)
    shutil.rmtree(work, ignore_errors=True)
    synthetic_train_data(work / "data")
    base_dir = work / "base"
    save_checkpoint(str(base_dir), cfg, init_params(cfg, 42, device=dev))
    torch.cuda.empty_cache()
    argv = train_argv(work, ["--model_name_or_path", str(base_dir)], lengths, dev)
    reset_counts()
    base = lora_run_checks(dev, cfg, argv, lambda: load_checkpoint(str(base_dir),
                                                                   device=dev)[1], LLAMA)
    keys, want = safetensors_keys(work / "run" / "export"), hf_keys(cfg)
    print(f"train [{LLAMA}, export]: {len(keys)} tensors, the JAX exporter's names: "
          f"{keys == want} (lm_head.weight: {'lm_head.weight' in keys})", flush=True)
    if keys != want:
        fail(f"train [{LLAMA}, export]: tensor names differ from the JAX exporter's: "
             f"{sorted(keys ^ want)[:8]}")
    print(f"model [phase 17]: Llama-3.2-1B width and depth, {count_params(base) / 1e9:.3f} B "
          f"params, head dim {cfg.head_dim_}, tied embeddings", flush=True)

    batch, valid, padded = first_batch(work, lengths)
    tc = TrainConfig(learning_rate=1e-4, total_steps=4)
    run_step, state, _, _ = make_lora_train_state(cfg, tc, base, seed=0, device=dev)
    state, losses, med, peak = timed_steps(run_step, state, batch, 4)
    print(f"train [{LLAMA}, LoRA, one batch, lr 1e-4]: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {med * 1e3:.1f} ms per step (median "
          f"of steps 2-4, host clock) = {valid / med:.0f} valid tokens/s ({valid} valid of "
          f"{padded} padded tokens a step); peak {peak:.2f} GiB; "
          f"{count_params(state.params) / 1e6:.1f} M trained parameters", flush=True)
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"train [{LLAMA}, learns]: losses {losses}")
    del state, run_step
    torch.cuda.empty_cache()

    # the same steps with the fused LM-head loss (--fused_ce; the
    # reference's default, as above, takes the [8192 x 128256] logits whole)
    tc_f = dataclasses.replace(tc, fused_ce=True)
    run_step, state, _, _ = make_lora_train_state(cfg, tc_f, base, seed=0, device=dev)
    state, losses_f, med_f, peak_f = timed_steps(run_step, state, batch, 2)
    print(f"train [{LLAMA}, LoRA, fused_ce]: losses {', '.join(f'{x:.4f}' for x in losses_f)} "
          f"(unfused {losses[0]:.4f}, {losses[1]:.4f}); {med_f * 1e3:.1f} ms for step 2 "
          f"= {valid / med_f:.0f} valid tokens/s; peak {peak_f:.2f} GiB against the "
          f"unfused loss's {peak:.2f} GiB", flush=True)
    if any(abs(a - b) > FUSED_CE_RTOL * abs(b) for a, b in zip(losses_f, losses)):
        fail(f"train [{LLAMA}, fused_ce]: losses {losses_f} against {losses[:2]}")
    del state, run_step
    torch.cuda.empty_cache()

    run_step, state, _, _ = make_lora_train_state(cfg, tc, base, seed=0, device=dev,
                                                  quantize=True)
    del base
    torch.cuda.empty_cache()
    state, losses, med, peak_q = timed_steps(run_step, state, batch, 3)
    print(f"train [{LLAMA}, QLoRA, int8 base, one batch]: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {med * 1e3:.1f} ms per step (median "
          f"of steps 2-3, host clock) = {valid / med:.0f} valid tokens/s; peak "
          f"{peak_q:.2f} GiB against LoRA's {peak:.2f} GiB", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train [{LLAMA}, QLoRA]: losses {losses}")
    del state, run_step
    torch.cuda.empty_cache()

    full_parameter_steps(dev, cfg, batch, valid, ckpt_dir=work / "full")
    torch.cuda.synchronize()
    counts = read_counts()
    path_launches[LLAMA_PATHS[2]] = counts
    print(f"{LLAMA} training launches: {counts}; phase 17 training "
          f"{time.time() - t_phase:.0f} s", flush=True)
    if any(counts[n] == 0 for n in ("flash_attention", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")):
        fail("phase 17: Llama-3.2-1B training did not go through K1, K4 and K5")
    training_times(dev, randn, times, Dh=64)
    k1_times(dev, randn, times, H=16, Hkv=8, Dh=96, name="flash_attention[dh96]")
    bwd_dh96_times(dev, randn)
    print(f"phase 17: {time.time() - t_phase:.0f} s", flush=True)


def k9_f32_times(dev, times, Q=256, N=2**18, D=4096) -> None:
    """K9 [f32] at the retrieval eval's search shape: a 256-query block
    against an fp32 corpus of 2^18 rows of 4096 (4.3 GB; TREC-COVID's
    171,332 docs rounded up to a power of two), every row real, unit rows.
    CUDA events around calls launched back to back: the kernel, its plain
    version and the library (torch.mm in fp32 with TF32 off, masked_fill,
    amax). The bound is the larger of the bytes (corpus and queries read
    once, scores and segment maxima written once) over PEAK_BYTES and the
    products over this card's fp32 FMA rate: its SM count (device
    properties) x 128 fp32 lanes x 2 x its maximum SM clock
    (nvidia-smi clocks.max.sm)."""
    import torch

    from gritlm_tpu_torch.ops import scores_segmax

    gen = torch.Generator(device=dev).manual_seed(9)

    def unit(n):
        x = torch.randn((n, D), generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    q = unit(Q)
    emb = torch.empty((N, D), device=dev)
    for a in range(0, N, 65536):
        emb[a:a + 65536] = unit(min(65536, N - a))
    nd = N
    masked = (torch.arange(N, device=dev) >= nd)[None]

    def library():
        s = torch.mm(q, emb.t()).masked_fill(masked, float("-inf"))
        return s, s.view(Q, -1, 128).amax(-1)

    ms = event_ms(lambda: scores_segmax.scores_segmax(q, emb, nd), reps=10)
    plain_ms = event_ms(lambda: scores_segmax.scores_segmax_plain(q, emb, nd), reps=3, warmup=1)
    library_ms = event_ms(library, reps=10)
    peak = f32_peak()
    flops = 2.0 * Q * nd * D
    byt = nd * D * 4 + Q * D * 4 + Q * N * 4 + -(-N // 128) * Q * 4
    t_ops, t_bytes = flops / peak * 1e3, byt / PEAK_BYTES * 1e3
    bms, by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    rate, lib_rate = flops / (ms * 1e-3) / 1e12, flops / (library_ms * 1e-3) / 1e12
    print(f"time {K9_F32} [Q{Q} N{N} D{D} fp32, {nd} docs] by events: {ms:.4f} ms = "
          f"{rate:.1f} TFLOP/s{peak_note(rate, peak / 1e12)} ({bms / ms * 100:.1f}% of bound "
          f"{bms:.4f} ms, {by}: fp32 FMA peak {peak / 1e12:.1f} TFLOP/s, bytes "
          f"{t_bytes:.4f} ms); plain {plain_ms:.4f}; library "
          f"(torch.mm fp32, TF32 off, + masked_fill + amax) {library_ms:.4f} ms = "
          f"{lib_rate:.1f} TFLOP/s{peak_note(lib_rate, peak / 1e12)}", flush=True)
    if peak_note(lib_rate, peak / 1e12):
        library_ms = None  # an impossible reading stays out of the table
    times[K9_F32] = (ms, plain_ms, library_ms, bms, by)
    del q, emb, masked
    torch.cuda.empty_cache()


EVAL_TASK = "SyntheticPlanted"  # phase 18's BEIR-layout task
EVAL_DOCS, EVAL_QUERIES, EVAL_PLANTED = 1024, 128, 64
EVAL_RERANK = 10  # --rerank_top_k
# The search ids of phase 18 against a plain fp32 top-k over q @ emb^T: an id
# may differ only where the two scores tie within K9 [f32]'s tolerance. The
# kernel's FMA chain and cuBLAS sum the same 4096 fp32 products in another
# order; on these scores (normalized embeddings of one random model, all
# near 1) that moves a score by about 1e-6 (the first chip run: values
# 2.4e-6 apart, two ids swapped 1.85e-6 apart), so a closer pair's order
# is decided by rounding
EVAL_TIE = K9_F32_ATOL
# Log-likelihoods of the same pairs in two batchings (batched against one
# example at a time), and score_continuations against a plain log-softmax
# of the logits of the same batched forward
MC_ATOL = 1e-3
# score_continuations against a plain log-softmax of one forward a pair: a
# forward of another shape takes other cuBLAS GEMMs, and with random bf16
# weights at full depth their rounding moves a sum of log-probabilities by
# up to one bf16 step of its magnitude (a chip run: 0.605 of -226.4, the
# same pair padded to another width agreeing to 1e-5), so the bound is
# relative: 2^-8 of the sum
LL_SHAPE_RTOL = 2.0 ** -8


def eval_words() -> list:
    return sorted(set(" ".join(SENTENCES).lower().replace(",", "").replace(".", "").split()))


def random_text(rng, words, lo: int, hi: int) -> str:
    """Random words of the vocabulary, cut to lo-hi bytes (the byte
    tokenizer's tokens)."""
    n = int(rng.integers(lo, hi + 1))
    out = []
    while sum(len(w) + 1 for w in out) <= n:
        out.append(words[int(rng.integers(len(words)))])
    return " ".join(out)[:n].strip()


def planted_task(path: Path, seed: int = 0) -> list:
    """A BEIR-layout task under `path` (corpus.jsonl, queries.jsonl,
    qrels.tsv): EVAL_DOCS docs (a title of 2-4 words and 150-300 bytes of
    text), EVAL_QUERIES queries with one relevant doc each. The first
    EVAL_PLANTED are planted: each is its relevant doc's text exactly as
    encode_corpus joins title and text; the rest are 16-48-byte random
    queries. Returns the planted query ids."""
    rng = np.random.default_rng(seed)
    words = eval_words()
    docs, seen = [], set()
    while len(docs) < EVAL_DOCS:
        title = " ".join(words[int(i)] for i in rng.integers(len(words), size=rng.integers(2, 5)))
        text = random_text(rng, words, 150, 300)
        if title + " " + text not in seen:
            seen.add(title + " " + text)
            docs.append({"_id": f"d{len(docs)}", "title": title, "text": text})
    rel = rng.permutation(EVAL_DOCS)[:EVAL_QUERIES]
    queries = []
    for i in range(EVAL_QUERIES):
        d = docs[int(rel[i])]
        text = (d["title"] + " " + d["text"] if i < EVAL_PLANTED
                else random_text(rng, words, 16, 48))
        queries.append({"_id": f"q{i}", "text": text})
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "corpus.jsonl", "w") as f:
        f.writelines(json.dumps(d) + "\n" for d in docs)
    with open(path / "queries.jsonl", "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    with open(path / "qrels.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.writelines(f"q{i}\td{int(rel[i])}\t1\n" for i in range(EVAL_QUERIES))
    return [f"q{i}" for i in range(EVAL_PLANTED)]


def wrap_attr(stack, obj, name: str, make):
    """Replace obj.name by make(original) until `stack` closes."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    stack.callback(setattr, obj, name, orig)


def synced_timer(log: dict, key: str):
    """A wrapper factory that times each call (synchronized before and
    after) into log[key]."""
    import torch

    def make(orig):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            log.setdefault(key, []).append(time.perf_counter() - t)
            return out
        return call
    return make


def mteb_leg(dev, work: Path, reset_counts, read_counts, path_launches) -> None:
    """Phase 18's MTEB leg: `eval.mteb.main` (--model_preset mistral_7b
    --no_instruction --rerank_top_k 10 --device cuda) on the planted task,
    then `eval.aggregate.main` over its output folder. Checks and figures
    in eval_phase's docstring."""
    import contextlib

    import torch

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import mistral_7b
    from gritlm_tpu_torch.eval import aggregate, retrieval
    from gritlm_tpu_torch.eval import mteb as mteb_cli
    from gritlm_tpu_torch.eval.rerank import GenerativeReranker
    from gritlm_tpu_torch.index import FlatIndex

    planted = planted_task(work / "data" / EVAL_TASK)
    results_dir = work / "results" / "mistral_7b"
    cache_dir = work / "rerank_cache"
    argv = ["--model_preset", "mistral_7b", "--local_data_dir", str(work / "data"),
            "--task_names", EVAL_TASK, "--no_instruction", "--rerank_top_k", str(EVAL_RERANK),
            "--top_k", str(2 * EVAL_RERANK),  # a tail below the reranked head
            "--device", "cuda", "--output_folder", str(results_dir),
            "--rerank_cache_dir", str(cache_dir)]
    metric_calls, searches, walls = [], [], {}

    def record_metrics(orig):
        def call(results, qrels, k_values=(1, 3, 5, 10, 100)):
            metric_calls.append((results, qrels))
            return orig(results, qrels, k_values)
        return call

    def record_search(orig):
        def call(self, queries, k, mode=None):
            out = orig(self, queries, k, mode)
            searches.append((self, queries, k, out))
            return out
        return call

    reset_counts()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        wrap_attr(stack, retrieval, "retrieval_metrics", record_metrics)
        wrap_attr(stack, FlatIndex, "search", record_search)
        wrap_attr(stack, GritLM, "encode_corpus", synced_timer(walls, "docs"))
        wrap_attr(stack, GritLM, "encode_queries", synced_timer(walls, "queries"))
        wrap_attr(stack, GenerativeReranker, "rerank", synced_timer(walls, "rerank"))
        mteb_cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    path_launches["eval (mteb)"] = counts
    cli_s = time.time() - t0
    gc.collect()  # the CLI's model
    torch.cuda.empty_cache()
    L = mistral_7b().num_hidden_layers
    rerank_k1 = counts["flash_attention"] - L * counts["fused_norm_mean_pool"]
    print(f"eval [mteb CLI, {EVAL_DOCS} docs, {EVAL_QUERIES} queries, rerank top "
          f"{EVAL_RERANK}]: {cli_s:.1f} s (model init included); launches {counts}; K1 in the "
          f"rerank forwards {rerank_k1} (K1 less {L} a K2 launch of encode)", flush=True)
    if (counts["flash_attention"] == 0 or counts["fused_norm_mean_pool"] == 0
            or counts[K9_F32] == 0 or counts["scores_segmax"] != 0):
        fail("eval [mteb]: encode and search did not go through K1, K2 and K9 [f32] alone")
    if rerank_k1 != L * EVAL_QUERIES:  # one forward of 10 prompts a query
        fail(f"eval [mteb]: {rerank_k1} K1 launches in the rerank forwards, expected "
             f"{L * EVAL_QUERIES}")
    out_path = results_dir / f"{EVAL_TASK}.json"
    if not out_path.exists():
        fail(f"eval [mteb]: {out_path.name} was not written")
    written = json.loads(out_path.read_text())["metrics"]
    if "ndcg_at_10" not in written or "rerank_ndcg_at_10" not in written:
        fail(f"eval [mteb]: the task JSON lacks the dense or the reranked metrics: "
             f"{sorted(written)[:6]}")
    if len(metric_calls) != 2 or len(searches) != 1:
        fail(f"eval [mteb]: {len(metric_calls)} metric calls and {len(searches)} searches")

    (dense, qrels), (reranked, _) = metric_calls
    sub = {q: qrels[q] for q in planted}
    m_dense = retrieval.retrieval_metrics({q: dense[q] for q in planted}, sub, (1, 10))
    m_rr = retrieval.retrieval_metrics({q: reranked[q] for q in planted}, sub, (1, 10))
    print(f"eval [mteb, all {EVAL_QUERIES} queries]: dense ndcg@10 {written['ndcg_at_10']}, "
          f"recall@1 {written['recall_at_1']}; reranked ndcg@10 {written['rerank_ndcg_at_10']}, "
          f"recall@1 {written['rerank_recall_at_1']}", flush=True)
    print(f"eval [mteb, {len(planted)} planted queries]: dense recall@1 {m_dense['recall_at_1']}, "
          f"ndcg@10 {m_dense['ndcg_at_10']}; reranked recall@1 {m_rr['recall_at_1']}, ndcg@10 "
          f"{m_rr['ndcg_at_10']}, recall@10 {m_rr['recall_at_10']} (random weights: the "
          f"yes-logit carries no relevance, so the reranked head's order is not gated)",
          flush=True)
    if m_dense["recall_at_1"] != 1.0 or m_dense["ndcg_at_10"] < 0.99:
        fail(f"eval [mteb]: planted dense metrics {m_dense}")
    if m_rr["recall_at_10"] != 1.0:
        fail(f"eval [mteb]: a planted doc left the reranked head: {m_rr}")
    for qid, scores in reranked.items():
        head = [d for d, _ in sorted(dense[qid].items(), key=lambda x: -x[1])[:EVAL_RERANK]]
        tail = [s for d, s in scores.items() if d not in head]
        yes = json.loads((cache_dir / EVAL_TASK / f"{qid}.json").read_text())
        if tail and min(scores[d] for d in head) <= max(tail):
            fail(f"eval [mteb]: query {qid}'s reranked head is not above its tail")
        if max(head, key=lambda d: scores[d]) != max(head, key=lambda d: yes[d]):
            fail(f"eval [mteb]: query {qid}'s reranked first is not its largest yes-logit")

    index, q, k, (got_s, got_i) = searches[0]
    emb = index.embeddings[:index.n_docs]
    plain = q.float() @ emb.T
    want_s, want_i = torch.topk(plain, k, dim=1)
    got_i_t = torch.from_numpy(got_i).long().to(dev)
    at_got = plain.gather(1, got_i_t)
    differ = got_i_t != want_i
    tie_gap = float((at_got - want_s)[differ].abs().max()) if differ.any() else 0.0
    val_err = float((torch.from_numpy(got_s).to(dev) - want_s).abs().max())
    print(f"eval [search, fp32 index of {index.n_docs} x {index.dim}]: ids against a plain "
          f"fp32 top-{k}: {int(differ.sum())} of {differ.numel()} differ, largest score gap "
          f"there {tie_gap:.2e} (ties within {EVAL_TIE}); values max abs err {val_err:.2e}",
          flush=True)
    if tie_gap > EVAL_TIE or val_err > K9_F32_ATOL:
        fail("eval [search]: FlatIndex.search departs from a plain fp32 top-k")
    q256 = torch.cat([q, q]).contiguous()
    block = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.search(q256, k=k)
        block.append(time.perf_counter() - t)
    n_prompts = sum(min(EVAL_RERANK, len(r)) for r in dense.values())
    print(f"eval [rates]: {EVAL_DOCS / sum(walls['docs']):.1f} docs/s and "
          f"{EVAL_QUERIES / sum(walls['queries']):.1f} queries/s encoded (batch 64); a "
          f"256-query block searched at fp32 in {statistics.median(block) * 1e3:.3f} ms (host "
          f"clock, median of 5); {n_prompts / sum(walls['rerank']):.1f} rerank prompts/s "
          f"({n_prompts} prompts)", flush=True)
    del searches, index, q, q256, emb, plain
    torch.cuda.empty_cache()
    aggregate.main([str(work / "results")])
    print(f"eval [aggregate]: MTEB-format scores in {results_dir.name}: "
          f"{aggregate.collect_scores(str(results_dir))} (the offline CLI writes "
          f"{{task, metrics}}, which holds no MTEB split)", flush=True)


def generative_leg(dev, work: Path, reset_counts, read_counts, path_launches) -> None:
    """Phase 18's generative leg on GritLM(mistral_7b(), mode="unified")
    (the CLI's weights: seed 0). Checks and figures in eval_phase's
    docstring."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import mistral_7b
    from gritlm_tpu_torch.data_prep import mine_hard_negatives, validate_file
    from gritlm_tpu_torch.eval import generative
    from gritlm_tpu_torch.models.transformer import forward_lm

    rng = np.random.default_rng(1)
    words = eval_words()
    gm = GritLM(mistral_7b(), mode="unified")
    tok = gm.tokenizer

    # multiple choice, batched (32 pairs a forward) against one example at a time
    items = [{"question": random_text(rng, words, 60, 120) + "?",
              "choices": [random_text(rng, words, 8, 24) for _ in range(4)],
              "answer": int(rng.integers(4))} for _ in range(32)]
    captured = {}

    def capture(key):
        def make(orig):
            def call(*a, **kw):
                out = orig(*a, **kw)
                captured.setdefault(key, []).append(out)
                return out
            return call
        return make

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        wrap_attr(stack, generative, "_loglikelihood_batch", capture("batched"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_b = generative.eval_multiple_choice(gm, items, batch_size=32)
        torch.cuda.synchronize()
        t_mc = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    with contextlib.ExitStack() as stack:
        wrap_attr(stack, generative, "_loglikelihood_batch", capture("sequential"))
        acc_s = generative.eval_multiple_choice(gm, items, batch_size=4)
    sb, ss = np.concatenate(captured["batched"]), np.concatenate(captured["sequential"])
    mc_err = float(np.abs(sb - ss).max())
    print(f"eval [multiple choice, 32 items x 4 choices]: accuracy {acc_b['accuracy']:.1f} "
          f"batched, {acc_s['accuracy']:.1f} one item a forward; log-likelihoods max abs diff "
          f"{mc_err:.2e} (atol {MC_ATOL}); {len(sb) / t_mc:.1f} log-likelihood pairs/s (batch "
          f"32, host clock); peak {peak:.2f} GiB", flush=True)
    if not np.isfinite(sb).all() or mc_err > MC_ATOL or acc_b != acc_s:
        fail("eval [multiple choice]: batched and sequential scoring disagree")

    ctx = generative.format_chat([items[0]["question"]])
    options = [" " + c for c in items[0]["choices"]]
    got = np.asarray(generative.score_continuations(gm, ctx, options))
    n_ctx = len(tok._encode_one(ctx, add_special_tokens=True))

    def plain_scores(texts):
        """Sum of the continuations' log-softmax over one forward of `texts`."""
        enc = tok(texts, max_length=1024)
        ids = torch.as_tensor(enc["input_ids"], device=dev).long()
        mask = torch.as_tensor(enc["attention_mask"], device=dev)
        with torch.inference_mode():
            logp = F.log_softmax(forward_lm(gm.params, gm.config, ids, attention_mask=mask,
                                            causal=True)[0].float(), dim=-1)
        out = []
        for r in range(len(texts)):
            n = int(mask[r].sum())
            picked = logp[r, :n - 1].gather(1, ids[r, 1:n, None])[:, 0]
            out.append(float(picked[n_ctx - 1:].sum()))
        return np.asarray(out)

    same = plain_scores([ctx + o for o in options])  # the same batch: the same forward
    apart = np.concatenate([plain_scores([ctx + o]) for o in options])  # one forward a pair
    sc_err = float(np.abs(got - same).max())
    rel = float((np.abs(got - apart) / np.abs(apart)).max())
    print(f"eval [score_continuations, 4 options]: {np.round(got, 4).tolist()}; max abs diff "
          f"{sc_err:.2e} against a plain log-softmax of the same forward (atol {MC_ATOL}); "
          f"against one forward a pair max abs diff {float(np.abs(got - apart).max()):.3e}, "
          f"relative {rel:.2e} (rtol {LL_SHAPE_RTOL:.2e})", flush=True)
    if sc_err > MC_ATOL or rel > LL_SHAPE_RTOL:
        fail("eval [score_continuations]: departs from the plain log-softmax")
    counts_ll = read_counts()

    # greedy generation: GSM8K-style and QA, batch 4
    gsm = [{"question": random_text(rng, words, 40, 100) + "?", "answer": str(int(rng.integers(100)))}
           for _ in range(8)]
    qa = [{"question": random_text(rng, words, 20, 60) + "?",
           "answers": [random_text(rng, words, 4, 12)]} for _ in range(8)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_gsm = generative.eval_gsm8k(gm, gsm, max_new_tokens=64, batch_size=4)
    r_qa = generative.eval_qa_generation(gm, qa, batch_size=4)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = read_counts()
    row_steps = 8 * 64 + 8 * 32
    print(f"eval [generation]: gsm8k exact_match {r_gsm['exact_match']:.1f} (n {r_gsm['n']}), qa "
          f"{ {k: round(v, 2) for k, v in r_qa.items()} }; {row_steps / t_gen:.1f} generated "
          f"tokens/s (rows x max_new_tokens over the host clock, batch 4); launches {counts}",
          flush=True)
    if (r_gsm["n"] != 8 or len(r_gsm["predictions"]) != 8 or r_qa["n"] != 8
            or counts["flash_attention"] == 0 or counts["flash_decode"] == 0):
        fail("eval [generation]: gsm8k/qa did not run 8 items each through K1 and K3")
    path_launches["eval (generative)"] = {n: counts_ll.get(n, 0) + counts.get(n, 0)
                                          for n in counts}

    # hard-negative mining over a bf16 index (K9's bf16 kernel)
    rows = [{"query": random_text(rng, words, 16, 48),
             "pos": [f"{i} " + random_text(rng, words, 150, 300)], "neg": []} for i in range(256)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mined = mine_hard_negatives(gm, rows, k=7)
    torch.cuda.synchronize()
    t_mine = time.perf_counter() - t0
    counts = read_counts()
    path_launches["eval (mining)"] = counts
    own = sum(any(n in r["pos"] for n in m["neg"]) for r, m in zip(rows, mined))
    short = sum(len(m["neg"]) != 7 for m in mined)
    print(f"eval [mining, 256 rows, k 7]: {t_mine:.1f} s; rows with an own positive among "
          f"their negatives {own}, rows short of 7 {short}; K9 bf16 launches "
          f"{counts['scores_segmax']}, fp32 {counts[K9_F32]}", flush=True)
    if own or short or counts["scores_segmax"] == 0 or counts[K9_F32] != 0:
        fail("eval [mining]: own positives mined, rows short, or not through K9's bf16 kernel")
    del gm
    gc.collect()
    torch.cuda.empty_cache()

    synthetic_train_data(work / "train")  # phase 10's synthetic JSONL
    for name in ("emb.jsonl", "gen.jsonl"):
        v = validate_file(str(work / "train" / name))
        print(f"eval [data_prep.validate_file {name}]: {v['kind']}, {v['rows']} rows, "
              f"errors {v['errors']}", flush=True)
        if not v["valid"]:
            fail(f"eval [data_prep]: phase 10's {name} does not validate")


def eval_phase(dev, reset_counts, read_counts, path_launches) -> None:
    """Phase 18's eval leg at Mistral-7B width (random bf16 weights, seed 0),
    counts set to 0 before each run and read after. mteb_leg:
    `eval.mteb.main` on a planted BEIR task (planted_task: 1,024 docs, 128
    queries, 64 of them planted) with the generative reranker (top 10):
    the task JSON written; on the planted queries dense recall@1 = 1 and
    ndcg@10 >= 0.99, and the planted doc still in the reranked head
    (recall@10 = 1; the reranked recall@1 is printed: a random model's
    yes-logit carries no relevance); every query's reranked head above its
    tail and led by its largest yes-logit (the reranker's cache files);
    K1, K2 and K9 [f32] launched, K9's bf16 kernel not, and K1 launched
    L times a query in the rerank forwards; the search's ids equal a plain
    fp32 top-k over q @ emb^T up to ties within EVAL_TIE; docs/s and
    queries/s encoded, ms a 256-query block search at fp32, rerank
    prompts/s; then `eval.aggregate.main` over the output folder.
    generative_leg, on GritLM(mistral_7b(), mode="unified"):
    eval_multiple_choice on 32 four-choice items batched (32 pairs a
    forward) against one item a forward, log-likelihoods within MC_ATOL
    (log-likelihood pairs/s, peak GiB); score_continuations against a
    plain log-softmax of the same batched forward (MC_ATOL) and of one
    forward_lm a pair (LL_SHAPE_RTOL); eval_gsm8k (8
    items, 64 new tokens, batch 4) and eval_qa_generation (8 items) through
    K1 and K3 (generated tokens/s); mine_hard_negatives on 256 rows (k 7):
    no row gets its own positive, through K9's bf16 kernel; and
    data_prep.validate_file on phase 10's synthetic JSONL."""
    import shutil

    t_phase = time.time()
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    try:
        mteb_leg(dev, work, reset_counts, read_counts, path_launches)
        generative_leg(dev, work, reset_counts, read_counts, path_launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 18 (eval): {time.time() - t_phase:.0f} s", flush=True)


def tools_phase(dev, work: Path, reset_counts, read_counts, path_launches) -> None:
    """Phase 18's tools leg on phase 17's Llama-3.2-1B run under `work`
    (full width and depth): `tools verify-checkpoint --device cuda --fp32`
    on its export at the tool's default --parity_tol, 2e-3 (ok: loaded in
    fp32; the transformers oracle, where the machine has it, within it; the
    fixture cosines finite in [-1, 1] and printed; the fp32 forms of K1 and
    K2 and K9 [f32] launched, and no bf16 K1 or K2, counts set to 0 before
    and read after);
    `shard --max_shard_gb 1` read back equal by
    load_checkpoint; `strip-prefix` with the keys expected; `export-hf` on
    the full-parameter checkpoint read back equal to that state's
    params."""
    import torch

    from gritlm_tpu_torch import tools
    from gritlm_tpu_torch.models.loader import load_checkpoint
    from gritlm_tpu_torch.training.checkpoint import STATE_FILE

    def same_tree(a, b, path="") -> bool:
        if isinstance(a, dict) or isinstance(b, dict):
            return (isinstance(a, dict) and isinstance(b, dict) and set(a) == set(b)
                    and all(same_tree(a[k], b[k], f"{path}/{k}") for k in a))
        return a.dtype == b.dtype and torch.equal(a, b)

    t_phase = time.time()
    export = work / "run" / "export"
    verdict = work / "verdict.json"
    reset_counts()
    try:
        tools.main(["verify-checkpoint", "--model", str(export), "--device", "cuda", "--fp32",
                    "--out", str(verdict)])
    except SystemExit as e:
        fail(f"tools [verify-checkpoint]: exited {e.code}")
    torch.cuda.synchronize()
    counts = read_counts()
    path_launches["tools"] = counts
    v = json.loads(verdict.read_text())
    sims = v["cosine_fixture"]["sims"]
    print(f"tools [verify-checkpoint, {LLAMA} export]: ok {v['ok']}, load {v['load']}, "
          f"torch_parity {v['torch_parity']}, fixture cosines {sims} (random weights: "
          f"matches_gritlm7b {v['cosine_fixture']['matches_gritlm7b']}), retrieval smoke "
          f"{v['retrieval_smoke']}; launches {counts}", flush=True)
    if not v["ok"] or v["load"]["dtype"] != "float32" or not all(np.isfinite(sims)) \
            or max(abs(x) for x in sims) > 1.0:
        fail(f"tools [verify-checkpoint --fp32]: verdict {v}")
    if counts["flash_attention" + F32] == 0 or counts["fused_norm_mean_pool" + F32] == 0 \
            or counts[K9_F32] == 0 or counts["flash_attention"] or counts["fused_norm_mean_pool"]:
        fail("tools [verify-checkpoint --fp32]: did not go through K1 [f32], K2 [f32] and "
             "K9 [f32] alone")

    _, want = load_checkpoint(str(export), device=dev)
    tools.main(["shard", "--model", str(export), "--out", str(work / "sharded"),
                "--max_shard_gb", "1"])
    n_files = len(list((work / "sharded").glob("*.safetensors")))
    _, got = load_checkpoint(str(work / "sharded"), device=dev)
    same = same_tree(got, want)
    print(f"tools [shard --max_shard_gb 1]: {n_files} files, read back equal: {same}", flush=True)
    if n_files < 2 or not (work / "sharded" / "model.safetensors.index.json").exists() or not same:
        fail("tools [shard]: not sharded or not read back equal")
    del got, want

    tools.main(["strip-prefix", "--model", str(export), "--out", str(work / "stripped")])
    keys = safetensors_keys(work / "stripped")
    expect = {k[len("model."):] if k.startswith("model.") else k
              for k in safetensors_keys(export)}
    print(f"tools [strip-prefix model.]: {len(keys)} keys as expected: {keys == expect}",
          flush=True)
    if keys != expect:
        fail(f"tools [strip-prefix]: keys {sorted(keys ^ expect)[:6]}")

    ckpt = work / "full" / "step_3"
    tools.main(["export-hf", "--checkpoint", str(ckpt), "--config", str(export / "config.json"),
                "--out", str(work / "exported")])
    state = torch.load(ckpt / "state" / STATE_FILE, map_location="cpu", weights_only=True,
                       mmap=True)["params"]
    _, back = load_checkpoint(str(work / "exported"), device="cpu")
    same = same_tree(back, state)
    print(f"tools [export-hf {ckpt.name}]: read back equal to the "
          f"state's params: {same}; phase 18 (tools) {time.time() - t_phase:.0f} s", flush=True)
    if not same:
        fail("tools [export-hf]: the export does not read back the checkpoint's params")


def f32_cases(dev, randf, cases, lse_cases) -> None:
    """The fp32 forms' phase-2 cases (names with F32), held to F32_ATOL and
    rerun bit-equal by check_cases: K1 [f32] at phase 2's three shapes
    (bidirectional, causal with a window, a prefill at an offset over a
    cache view) with its LSE at Dh 128 (H 32, Hkv 8), 64 (32, 8) and 96 (16,
    8: zero-padded to 128); K2 [f32] at B 8 S 512 mean and weightedmean; K3
    [f32] at Sq 1 and 64, over an int8 cache, and at the serving call; K8
    [f32] at K8_SHAPES on pools of pages of 32 and of 256 slots, required
    bit-equal to K3 [f32] on the same logical cache."""
    from gritlm_tpu_torch.ops import fused_pool

    k1, k2 = "flash_attention" + F32, "fused_norm_mean_pool" + F32
    for H, Hkv, Dh in ((32, 8, 128), (32, 8, 64), (16, 8, 96)):
        k1_cases(dev, randf, cases, lse_cases, H=H, Hkv=Hkv, Dh=Dh, name=k1, atol=F32_ATOL)
    hidden, gamma, pmask = pool_case(dev, randf, 8, 512, 4096)
    for method in ("mean", "weightedmean"):
        kw = dict(eps=1e-5, method=method)
        cases.append((k2, f"{method} B8 S512 D4096",
                      lambda kw=kw: fused_pool.fused_norm_mean_pool(hidden, gamma, pmask, **kw),
                      lambda kw=kw: fused_pool.fused_norm_mean_pool_plain(
                          hidden, gamma, pmask, **kw),
                      None, 0.0, 0.0, F32_ATOL))  # timed cold by k2_times
    k3_cases(dev, randf, cases, name="flash_decode" + F32, atol=F32_ATOL)
    for page in (32, 256):
        k8_cases(dev, randf, cases, name="paged_decode" + F32, atol=F32_ATOL, page=page)


def f32_checks(dev, randf, max_err) -> None:
    """The fp32 forms' checks beyond f32_cases: K1 [f32] with a row whose
    keys are all masked (output 0, LSE NEG_INF) at Dh 64, 96 and 128; K2
    [f32] at K2_SHAPES (an empty row, D 3584, strided rows; mean and
    weightedmean, normalized and not, reruns bit-equal); K3 [f32] at the
    verify chunk (Sq 8, [B] offsets) over an fp32 and an int8 cache,
    bit-equal to K8 [f32] on the same logical cache."""
    import torch

    from gritlm_tpu_torch.ops import flash_attention as fa

    name = "flash_attention" + F32
    for H, Hkv, Dh in ((32, 8, 128), (32, 8, 64), (16, 8, 96)):
        q, k, v = randf(2, 200, H, Dh), randf(2, 333, Hkv, Dh), randf(2, 333, Hkv, Dh)
        mask = torch.ones((2, 333), dtype=torch.int32, device=dev)
        mask[1] = 0
        for causal in (False, True):
            out, lse = fa.flash_attention(q, k, v, mask, causal=causal, offset=133 * causal,
                                          return_lse=True)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_plain(q, k, v, mask, causal=causal,
                                                      offset=133 * causal, return_lse=True)
            err = max(float((out - want).abs().max()), float((lse - want_lse).abs().max()))
            empty = bool(torch.count_nonzero(out[1]) == 0) and bool((lse[1] == fa.NEG_INF).all())
            print(f"check {name} [a row with every key masked, Dh{Dh} "
                  f"{'causal' if causal else 'bidirectional'}]: max_abs_err {err:.3e} (atol "
                  f"{F32_ATOL}); the row 0 with LSE NEG_INF: {empty}", flush=True)
            if err > F32_ATOL or not empty:
                fail(f"{name}: a fully masked row ({err}, {empty})")
            max_err[name] = max(max_err.get(name, 0.0), err)
    k2_checks(dev, randf, max_err, name="fused_norm_mean_pool" + F32, atol=F32_ATOL)
    k3_verify(dev, randf, {}, max_err, name="flash_decode" + F32, timed=False, atol=F32_ATOL)


def f32_times(dev, randf, times) -> None:
    """The fp32 forms of K2, K3 and K8 timed cold as their bf16 forms are,
    each bound at the larger of its bytes and its operations at this
    card's fp32 FMA rate (f32_peak): K3 [f32] at k3_times' four shapes
    (the first the kernels line's row) and the verify chunk (fp32 and int8
    caches), K8 [f32] at Sq 1 and 8 over fp32 pages and Sq 1 over int8
    pages, K2 [f32] at B 8 S 512 D 4096 mean (the row) and weightedmean. K1
    [f32] is timed in phase 9's loop at its first phase-2 case."""
    t0 = time.time()
    k3_times(dev, randf, times, name="flash_decode" + F32, atol=F32_ATOL)
    k3_verify(dev, randf, times, {}, name="flash_decode" + F32, atol=F32_ATOL)
    k8_times(dev, randf, times, name="paged_decode" + F32, atol=F32_ATOL,
             shapes=((1, False), (8, False), (1, True)))
    k2_times(dev, randf, times, name="fused_norm_mean_pool" + F32, shapes=K2_TIMES[:2])
    print(f"fp32 forms timed in {time.time() - t0:.0f} s", flush=True)


# Phase 19's exactness check: the same fp32 model at full width and depth 2
# on the card (the kernels' fp32 forms, cuBLAS fp32 GEMMs, TF32 off) and on
# the CPU (the plain versions, the CPU's GEMMs). Each side rounds every sum
# to fp32 in its own order: about sqrt(K) x 2^-24 = 7e-6 of a value's scale
# at the widest sum (K 14336, the MLP's down projection), some ten such
# steps in series over two layers, the final norm and the LM head, so the
# embeddings and the logits are held to 1e-4 of their largest magnitude.
F32_EXACT_RTOL = 1e-4
F32_EXACT_DEPTH = 2


def to_device(tree, dev):
    """A parameter tree with every tensor moved to `dev`."""
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def f32_phase(dev, emb_bf16, enc_long, reset_counts, read_counts, path_launches) -> None:
    """Phase 19, GritLM at fp32 activations at Mistral-7B width (after
    phase 18's eval leg, with the bf16 Mistral model freed; TF32 off). First
    the exactness check at depth F32_EXACT_DEPTH, the card against the same
    model on the CPU (F32_EXACT_RTOL); then at full depth, random fp32
    weights from seed 0 (27 GiB), counts set to 0 before each run and summed
    after: encode of the 16 sentences (sentences/s; the cosine to phase 3's
    bf16 embeddings of the same seed printed, not gated); greedy generate at
    B 2 (phase 4's long prompts, 32 tokens, each token within TIE_TOL of its
    position's largest logit), the decode step's device / host ms and idle
    share; phase 7's 8-request cut through a dense pool (with its 8
    embedding requests), a paged pool (page 256), a paged int8-KV pool
    (INT8_KV_TIE_TOL) and a dense speculative pool (spec_k 7), each request
    complete and teacher-forced, tokens/s. The path must launch the fp32
    forms of K1, K2, K3 and K8 and no bf16 K1, K2, K3 or K8. Prints the
    weights' GiB and the peak GiB."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from gritlm_tpu_torch import GritLM, serving
    from gritlm_tpu_torch.config import mistral_7b
    from gritlm_tpu_torch.models.transformer import count_params, forward_lm
    from gritlm_tpu_torch.serving import ServingEngine

    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 19: TF32 is on; the fp32 path's products must be fp32")
    cfg = dataclasses.replace(mistral_7b(), dtype="float32")
    total = {}

    def add(counts):
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c

    def encode_all(m):
        a = m.encode(SENTENCES[:8])
        b = m.encode(SENTENCES[8:], instruction=INSTRUCTION)
        return torch.cat([torch.from_numpy(a), torch.from_numpy(b)])

    # exactness: depth 2 on the card against the same model on the CPU
    card = GritLM(dataclasses.replace(cfg, num_hidden_layers=F32_EXACT_DEPTH), seed=0)
    host = GritLM(card.config, params=to_device(card.params, "cpu"), device="cpu")
    ids = torch.from_numpy(np.asarray(enc_long["input_ids"])).long()
    am = torch.from_numpy(np.asarray(enc_long["attention_mask"])).int()
    reset_counts()
    e_card = encode_all(card)
    with torch.inference_mode():
        l_card = forward_lm(card.params, card.config, ids.to(dev), attention_mask=am.to(dev),
                            causal=True)[0].float().cpu()
    torch.cuda.synchronize()
    add(read_counts())
    t0 = time.time()
    e_host = encode_all(host)
    with torch.inference_mode():
        l_host = forward_lm(host.params, host.config, ids, attention_mask=am,
                            causal=True)[0].float()
    valid = am.bool()
    e_err = float((e_card - e_host).abs().max()) / float(e_host.abs().max())
    l_err = float((l_card - l_host)[valid].abs().max()) / float(l_host[valid].abs().max())
    print(f"f32 [exactness, depth {F32_EXACT_DEPTH}, card against CPU ({time.time() - t0:.0f} s "
          f"on the CPU)]: embeddings max |diff| / max |value| {e_err:.3e}, logits over "
          f"{int(valid.sum())} positions {l_err:.3e} (rtol {F32_EXACT_RTOL}); min cosine "
          f"{float(F.cosine_similarity(e_card, e_host, dim=-1).min()):.8f}", flush=True)
    if not (e_err <= F32_EXACT_RTOL and l_err <= F32_EXACT_RTOL):
        fail(f"f32: the card departs from the CPU at depth {F32_EXACT_DEPTH}: {e_err}, {l_err}")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    # full width and depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = GritLM(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"f32 model: Mistral-7B width and depth, {count_params(model.params) / 1e9:.3f} B "
          f"params, {count_params(model.params) * 4 / 2**30:.2f} GiB of fp32 weights, init "
          f"{time.time() - t0:.1f} s", flush=True)
    reset_counts()
    emb = encode_all(model)
    torch.cuda.synchronize()
    t0 = time.time()
    emb2 = encode_all(model)
    torch.cuda.synchronize()
    dt = time.time() - t0
    add(read_counts())
    cos = F.cosine_similarity(emb, emb_bf16, dim=-1)
    print(f"f32 encode: 16 sentences in {dt * 1e3:.1f} ms = {16 / dt:.1f} sentences/s; rerun "
          f"bit-equal {torch.equal(emb, emb2)}; cosine to phase 3's bf16 embeddings of the same "
          f"seed: min {float(cos.min()):.4f}, mean {float(cos.mean()):.4f} (printed, not gated)",
          flush=True)
    if tuple(emb.shape) != (16, 4096) or not torch.isfinite(emb).all() \
            or float((emb.norm(dim=-1) - 1).abs().max()) > 1e-5:
        fail(f"f32 encode: shape {tuple(emb.shape)}, non-finite values or norms off 1")

    reset_counts()
    res = model.generate_from_ids(enc_long["input_ids"], enc_long["attention_mask"],
                                  max_new_tokens=32)
    torch.cuda.synchronize()
    add(read_counts())
    gaps = []
    for b in range(res.tokens.shape[0]):
        prompt = enc_long["input_ids"][b, :int(enc_long["attention_mask"][b].sum())].tolist()
        toks = res.tokens[b, :int(res.num_valid[b])].tolist()
        gaps.append(teacher_deficits(model, prompt, toks))
    gaps = torch.cat(gaps)
    print(f"f32 generate B=2, 32 tokens: teacher forcing over {len(gaps)} tokens: largest "
          f"deficit to the max logit {float(gaps.max()):.4f} (tolerance {TIE_TOL}); sample "
          f"{model.tokenizer.decode(res.tokens[0].tolist())!r}", flush=True)
    if float(gaps.max()) > TIE_TOL:
        fail(f"f32 generate: a token sits {float(gaps.max())} below its position's max logit")
    reset_counts()
    step = decode_step("fp32", model, enc_long)
    add(read_counts())

    drive, specs = serving_workload(model, reset_counts, read_counts, total, f32=True)
    specs = specs[:8]  # phase 7's 8-request cut
    tok = model.tokenizer
    kw = dict(max_batch=8, max_len=4096, chunk_size=16, eos_id=tok.eos_token_id,
              pad_id=tok.pad_token_id, device=dev)
    rates = {}
    pools = (("dense fp32", dict(), 8, TIE_TOL),
             ("paged fp32", dict(paged=True, page_size=256), 0, TIE_TOL),
             ("paged int8 KV, fp32", dict(paged=True, page_size=256, kv_quant=True), 0,
              INT8_KV_TIE_TOL),
             ("speculative dense fp32", dict(speculative=True, spec_k=SPEC_K, spec_ngram=3), 0,
              TIE_TOL))
    for label, extra, n_embeds, tie in pools:
        eng = ServingEngine(model.config, model.params, **extra, **kw)
        run = drive(label, eng, specs, n_embeds, tie_tol=tie)
        rates[label] = run["rate"]
        if label == "dense fp32":
            chunk = profile_decode_chunk(label, eng, serving._decode_chunk_program, specs)
            print(f"serving [{label}]: decode step at B=8 " + (
                "not measured" if chunk is None else
                f"{chunk[0]:.3f} device ms, {chunk[1]:.3f} host ms, idle share {chunk[2]:.3f}"),
                flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    path_launches["fp32"] = total
    bf16 = {n: total.get(n, 0) for n in F32_INFERENCE}
    f32 = {n: total.get(n + F32, 0) for n in F32_INFERENCE}
    print(f"f32 path launches: fp32 forms {f32}, bf16 forms {bf16}; decode step at B=2 "
          + ("not measured" if step is None else
             f"{step[0]:.3f} device ms, {step[1]:.3f} host ms, idle share {step[2]:.3f}")
          + "; generated tokens/s by pool: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase 19 "
          f"{time.time() - t_phase:.0f} s", flush=True)
    if any(c == 0 for c in f32.values()) or any(bf16.values()):
        fail("f32 path: a kernel's fp32 form never launched, or a bf16 form did")
    del model
    gc.collect()
    torch.cuda.empty_cache()


# Phase 20's head dims and layouts for K4 [f32] and K5 [f32] against the
# plain backward: (label, B, S, (Dh, H, Hkv), causal, window, mask), the
# mask "full", "pad" (row 1's last quarter masked) or "empty" (and row 0
# fully masked)
F32_BWD_CASES = (
    ("bidirectional", 8, 2048, (128, 32, 8), False, None, "full"),
    ("causal", 4, 2048, (128, 32, 8), True, None, "full"),
    ("causal, window 512, right padding", 2, 2048, (128, 32, 8), True, 512, "pad"),
    ("bidirectional, row 0 fully masked", 2, 2048, (128, 32, 8), False, None, "empty"),
    ("causal, right padding", 2, 2048, (64, 32, 8), True, None, "pad"),
    ("bidirectional, padding", 2, 2048, (64, 14, 2), False, None, "pad"),
    ("causal, row 0 fully masked", 2, 2048, (96, 16, 8), True, None, "empty"),
)


def f32_bwd_checks(dev, randf, max_err) -> None:
    """K4 [f32] and K5 [f32] (through flash_attention_bwd) against the plain
    backward from the same saved LSE (K1 [f32]'s) at F32_BWD_CASES: the
    kernels line's shapes (B 8 S 2048 bidirectional, B 4 S 2048 causal at
    32/8 heads, Dh 128), a window with right padding, a fully masked row
    (exactly zero gradients), Dh 64 (its instances) and 96 (padded to 128);
    each within BWD_F32_RTOL of the largest gradient, rerun bit-equal, one
    fp32 launch each a call and no bf16 launch (TF32 off)."""
    import torch

    from gritlm_tpu_torch.ops import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32:
        fail("K4/K5 [f32] checks: TF32 is on; the plain versions' products must be fp32")
    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    names = ("flash_attention_bwd_dq" + F32, "flash_attention_bwd_dkv" + F32)
    for label, B, S, (Dh, H, Hkv), causal, window, kind in F32_BWD_CASES:
        geometry = f"B{B} S{S} H{H} Hkv{Hkv} Dh{Dh}"
        q, k, v, do = (randf(B, S, H, Dh), randf(B, S, Hkv, Dh), randf(B, S, Hkv, Dh),
                       randf(B, S, H, Dh))
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if kind != "full":
            mask[1, S * 3 // 4:] = 0
        if kind == "empty":
            mask[0] = 0
        kw = dict(causal=causal, sliding_window=window)
        out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, **kw)
        before = [(w.f32_launches, w.launches) for w in wrappers]
        got = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, **kw)
        torch.cuda.synchronize()
        if [(w.f32_launches, w.launches) for w in wrappers] != [(f + 2, b) for f, b in before]:
            fail(f"K4/K5 [f32] [{label}]: not one fp32 launch each a call")
        want = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, **kw)
        errs, mags = [], []
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
            if g.shape != w.shape or g.dtype != torch.float32 or not torch.isfinite(g).all():
                fail(f"K4/K5 [f32] [{label}] {name}: shape, dtype or non-finite values")
            if not torch.equal(g, a):
                fail(f"K4/K5 [f32] [{label}] {name}: a rerun is not bit-equal")
            err, mag = float((g - w).abs().max()), float(w.abs().max())
            errs.append(err)
            mags.append(mag)
            if err > BWD_F32_RTOL * mag:
                fail(f"K4/K5 [f32] [{label}] {name} disagrees with the plain version: {err} > "
                     f"{BWD_F32_RTOL} x {mag}")
            if kind == "empty" and float(g[0].abs().max()) != 0.0:
                fail(f"K4/K5 [f32] [{label}] {name}: the fully masked row's gradient is not 0")
        for name, err in zip(names, (errs[0], max(errs[1:]))):
            max_err[name] = max(max_err.get(name, 0.0), err)
        print(f"check flash backward [f32, {label}, {geometry}]: max_abs_err dq {errs[0]:.3e} "
              f"(K4 [f32]), dk {errs[1]:.3e} dv {errs[2]:.3e} (K5 [f32]) against largest "
              f"gradients {', '.join(f'{m:.3f}' for m in mags)} (rtol {BWD_F32_RTOL}); rerun "
              "bit-equal", flush=True)
        del q, k, v, do, out, lse, got, again, want
        torch.cuda.empty_cache()


def f32_quant_leg(dev, reset_counts, read_counts, path_launches) -> None:
    """fp32 activations through K6 and K7 at decode rows: Llama-3.2-1B
    (LLAMA_32_1B at fp32, random weights from seed 0) with weight_quant 8
    and 4, greedy generate at B 2 (phase 4's long prompts, 16 tokens; counts
    set to 0 before, read after: K6 / K7 must launch); each generated token
    held, teacher-forced, within TIE_TOL of its position's largest logit in
    a forward of the same model whose quantized products take x cast to
    bf16 before the plain product (the function the kernels compute on an
    fp32 caller's x, as the JAX wrappers cast it)."""
    import dataclasses

    import torch

    from gritlm_tpu_torch import GritLM
    from gritlm_tpu_torch.config import ModelConfig
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.ops import quant_matmul as qm

    cfg = dataclasses.replace(ModelConfig.from_hf_config(LLAMA_32_1B), dtype="float32")
    params = init_params(cfg, 0, device=dev)
    prompts = ["<s><|user|>\n" + SENTENCES[4] + " " + SENTENCES[7] + "\n<|assistant|>\n",
               "<s><|user|>\nExplain: " + SENTENCES[2] + "\n<|assistant|>\n"]
    kernels = {8: ("w8a16_matmul", qm.w8a16_matmul, qm.w8a16_matmul_plain),
               4: ("w4a16_matmul", qm.w4a16_matmul, qm.w4a16_matmul_plain)}

    def bf16_x(plain):
        return lambda x, node: plain(x.to(torch.bfloat16), node).to(x.dtype)

    for bits, (name, wrapper, plain) in kernels.items():
        m = GritLM(cfg, params=params, weight_quant=bits, device=dev)
        enc = m.tokenizer(prompts)
        reset_counts()
        res = m.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=16)
        torch.cuda.synchronize()
        counts = read_counts()
        path_launches[f"fp32 w{bits} generate"] = counts
        setattr(qm, name, bf16_x(plain))
        try:
            gaps = []
            for b in range(enc["input_ids"].shape[0]):
                ids = enc["input_ids"][b, :int(enc["attention_mask"][b].sum())].tolist()
                toks = res.tokens[b, :int(res.num_valid[b])].tolist()
                gaps.append(teacher_deficits(m, ids, toks))
        finally:
            setattr(qm, name, wrapper)
        worst = float(torch.cat(gaps).max())
        print(f"generate [fp32 w{bits}a16, {LLAMA}]: B=2, 16 tokens; {name} launches "
              f"{counts[name]} on fp32 x; teacher forcing through x cast to bf16 before the "
              f"plain product: largest deficit {worst:.4f} (TIE_TOL {TIE_TOL})", flush=True)
        if counts[name] == 0:
            fail(f"fp32 w{bits}: generate did not go through {name}")
        if worst > TIE_TOL:
            fail(f"fp32 w{bits}: a token departs from the bf16-x product's logits ({worst})")
        del m, res
    del params
    gc.collect()
    torch.cuda.empty_cache()


def f32_train_leg(dev, work: Path, model_dir: Path, flags, key: str, path_launches,
                  reset_counts, read_counts, lengths=(256, 2048, 2048)):
    """`training.run --dtype float32 --model_name_or_path model_dir` with
    `flags` (--lora, --qlora, none: full parameters, --gc_chunks) on
    `work`/data (train_argv's batch and lengths; 3 steps, lr 1e-4, no
    intermediate checkpoint; the final checkpoint and export are written
    and removed after), counts set to 0 before and read after into
    path_launches[key]: K1, K4 and K5 must launch their fp32 forms and no
    bf16 form. Returns the steps' metrics rows (metrics.jsonl); prints
    losses, ms a step (host clock between the rows of steps 2 and 3), valid
    tokens/s and the peak GiB of the run (model load and export
    included)."""
    import shutil

    import torch

    from gritlm_tpu_torch.training import run

    out = work / f"run_{len(path_launches)}"
    argv = train_argv(work, ["--model_name_or_path", str(model_dir)], lengths, dev)
    argv = [a for a in argv if a != "--lora"] + ["--dtype", "float32", *flags]
    for flag, value in (("--save_steps", "0"), ("--output_dir", str(out))):
        argv[argv.index(flag) + 1] = value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    r = run.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    path_launches[key] = counts
    t_run = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    shutil.rmtree(out, ignore_errors=True)
    losses = [row["loss"] for row in rows]
    step_s = rows[-1]["time"] - rows[-2]["time"]
    f32 = {n: counts[n + F32] for n in F32_TRAINING}
    bf16 = {n: counts[n] for n in F32_TRAINING}
    print(f"train [{key}, run.main]: {r['steps']} steps in {t_run:.1f} s (model load, final "
          f"checkpoint and export included); losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"{step_s * 1e3:.1f} ms for step 3 (host clock between metrics rows) = "
          f"{25600 / step_s:.0f} valid tokens/s; peak {peak:.2f} GiB; fp32 launches {f32}, "
          f"bf16 {bf16}", flush=True)
    if r["steps"] != 3 or len(rows) != 3 or not all(np.isfinite(losses)):
        fail(f"train [{key}]: {r}, metrics {rows}")
    if losses[-1] >= losses[0]:
        fail(f"train [{key}]: the loss does not fall on the batch: {losses}")
    if any(c == 0 for c in f32.values()) or any(bf16.values()):
        fail(f"train [{key}]: K1, K4 or K5 did not launch its fp32 form, or a bf16 form ran")
    return rows


def f32_train_phase(dev, randf, reset_counts, read_counts, path_launches, times,
                    max_err, lengths=(256, 2048, 2048)) -> None:
    """Phase 20, GRIT training at fp32 (after phase 18's tools leg, every
    earlier model freed; TF32 off): K4 [f32] and K5 [f32] against the plain
    backward (f32_bwd_checks) and timed (training_times at fp32: B 8 S 2048
    bidirectional, the kernels line's row, and B 4 S 2048 causal at Dh 128;
    B 8 S 2048 bidirectional at Dh 64); fp32 activations through K6 and K7
    at decode rows (f32_quant_leg); then `training.run --dtype float32`
    (f32_train_leg) on one synthetic batch repeated (4 queries, group 2 with
    one negative each, 4 generative texts: 25,600 valid tokens a step, so
    every step sees the same batch; the first update's learning rate is 0,
    so the loss falls from step 1 to step 3): Llama-3.2-1B at its published
    width and depth (random fp32 weights from seed 42 written as a
    checkpoint) with LoRA, QLoRA (int8 base) and full parameters, and
    Mistral-7B width at depth 4 (fp32, seed 42) with LoRA in GradCache
    chunks of 2 (step 1's loss_emb within GC_F32_RTOL of an unchunked step
    from the same base and adapters on the same batch, taken in this
    process). The unfused LM-head loss fits at fp32 and V 128256 (its
    [8192 x 128256] fp32 logits), so no leg needs --fused_ce."""
    import dataclasses
    import shutil

    import torch

    from gritlm_tpu_torch.config import ModelConfig, mistral_7b
    from gritlm_tpu_torch.models.loader import load_checkpoint, save_checkpoint
    from gritlm_tpu_torch.models.transformer import init_params
    from gritlm_tpu_torch.training.arguments import parse_args
    from gritlm_tpu_torch.training.lora import make_lora_train_state

    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 20: TF32 is on; the fp32 path's products must be fp32")
    f32_bwd_checks(dev, randf, max_err)
    training_times(dev, randf, times, f32=True)
    training_times(dev, randf, times, Dh=64, shapes=((8, 2048, False),), f32=True)
    print(f"phase 20: checks and timings {time.time() - t_phase:.0f} s", flush=True)
    f32_quant_leg(dev, reset_counts, read_counts, path_launches)
    print(f"phase 20: K6/K7 on fp32 x, at {time.time() - t_phase:.0f} s", flush=True)
    work = ROOT / "build" / "chip_smoke_f32_train"
    shutil.rmtree(work, ignore_errors=True)
    try:
        synthetic_train_data(work / "data", n=4, negatives=1)
        models = {
            LLAMA: dataclasses.replace(ModelConfig.from_hf_config(LLAMA_32_1B), dtype="float32"),
            "mistral_7b depth 4": dataclasses.replace(mistral_7b(), num_hidden_layers=4,
                                                      dtype="float32"),
        }
        for i, (name, cfg) in enumerate(models.items()):
            save_checkpoint(str(work / f"model{i}"), cfg, init_params(cfg, 42, device=dev))
            torch.cuda.empty_cache()
        gc_flags = ["--lora", "--gc_chunks", "2"]
        legs = ((LLAMA, 0, ["--lora"], "LoRA"), (LLAMA, 0, ["--qlora"], "QLoRA, int8 base"),
                (LLAMA, 0, [], "full parameters"),
                ("mistral_7b depth 4", 1, gc_flags, "LoRA, GradCache 2 chunks"))
        rows = {}
        for name, i, flags, kind in legs:
            rows[name] = f32_train_leg(dev, work, work / f"model{i}", flags,
                                       f"fp32 training {name} {kind}", path_launches,
                                       reset_counts, read_counts, lengths)
            torch.cuda.empty_cache()
        # GradCache against the unchunked step: step 1 of the same run (the
        # base from the checkpoint, the adapters from the run's seed) on the
        # same batch in one chunk, in this process
        argv = train_argv(work, ["--model_name_or_path", str(work / "model1")], lengths,
                          dev) + ["--dtype", "float32", *gc_flags[1:]]
        args = parse_args(argv)
        tc = dataclasses.replace(args.to_train_config(3), gc_chunks=1)
        cfg, base = load_checkpoint(str(work / "model1"), dtype="float32", device=dev)
        run_step, state, _, _ = make_lora_train_state(cfg, tc, base, r=args.lora_r,
                                                      alpha=args.lora_alpha, seed=args.seed,
                                                      device=dev)
        batch, _, _ = first_batch(work, lengths)
        _, m = run_step(state, batch)
        a, b = float(m.loss_emb), rows["mistral_7b depth 4"][0]["loss_emb"]
        print(f"train [fp32 GradCache, mistral_7b depth 4]: step 1 loss_emb {b:.6f} in 2 "
              f"chunks (run.main), {a:.6f} unchunked (rtol {GC_F32_RTOL})", flush=True)
        if abs(a - b) > GC_F32_RTOL * abs(a):
            fail(f"fp32 GradCache: loss_emb {b} against {a} unchunked")
        del base, state, run_step
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20: {time.time() - t_phase:.0f} s", flush=True)


def profile_window(label: str, fn, top: int = 10):
    """Device time by kernel over one call of `fn` (torch.profiler), and the
    share of the window's wall time the device was idle. Returns (wall ms,
    device busy ms), or None for a trace without device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    events = [e for e in prof.key_averages()  # kernels only: ops would count twice
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:  # an empty trace (see time_ms): no idle share to report
        print(f"profile [{label}]: wall {wall_ms:.2f} ms, no device events recorded")
        return None
    print(f"profile [{label}]: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return wall_ms, busy_ms


if __name__ == "__main__":
    sys.exit(main())
