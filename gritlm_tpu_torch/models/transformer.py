"""Decoder-only transformer (Mistral / Mixtral family) on PyTorch tensors.

Port of gritlm_tpu.models.transformer. Params are a nested dict of tensors
with the layer axis stacked first, the same tree as the JAX package:

  params = {
    "embed":   {"embedding": [V, D]},
    "layers": {
      "ln1": {"scale": [L, D]},
      "attn": {"wq": [L, D, H*Dh], "wk": [L, D, Kv*Dh], "wv": [L, D, Kv*Dh],
               "wo": [L, H*Dh, D]},            # + bq/bk/bv for Qwen2
      "ln2": {"scale": [L, D]},
      # dense: "mlp": {"gate": [L, D, F], "up": [L, D, F], "down": [L, F, D]}
      # MoE:   "moe": {"router": [L, D, E], "gate": [L, E, D, F],
      #                "up": [L, E, D, F], "down": [L, E, F, D]}
    },
    "final_ln": {"scale": [D]},
    "lm_head": {"kernel": [D, V]},             # optional
  }

The layer loop is a Python loop. With a cache, each layer writes its K/V
into the cache tensors in place (the JAX package returns new arrays) and
attends against the full cache buffer. With `row_offsets` (the serving
decode step, and the speculative verify chunk) every row appends at its own
slots, into a dense `KVCache` or a paged `PagedKVCache`.

`forward` runs under autograd when its caller records (training); the
inference entry points (generate, GritLM.encode, the serving programs) run
it under `torch.inference_mode()` themselves. `remat=True` recomputes each
layer in the backward pass (one `torch.utils.checkpoint` per layer, the
JAX package's `jax.checkpoint`); `remat_policy` keeps the matrix products'
outputs as the JAX package's named policies do (selective activation
checkpointing, `remat_context`). A kernel leaf may be a lazy
LoRA node `{"w", "A", "B"}` (training/lora.apply_lora_lazy): `_w` resolves
it to W + A @ B one layer at a time, so no full effective copy of the
weights exists. A serving leaf may stack several adapters
(training/lora.stack_adapters): `_mm` adds each batch row's own adapter's
delta. A kernel leaf may also be quantized (training/quant.py):
`_mm` sends int8 and int4 serving leaves to the quantized matmuls (K6, K7)
and `_w` dequantizes an int8 QLoRA base one layer at a time. Each layer's
leaves are views of the stacked tensors (`_unstack`), so the kernels read a
layer's weights in place.

A Mixtral config (`cfg.is_moe`) replaces each layer's MLP with `_moe_mlp`:
token-choice top-k routing over E experts, run by `cfg.moe_impl` as the
JAX package runs it ("dense": every expert on every token; "dropless":
the (token, choice) pairs sorted by expert through grouped matmuls;
"gshard": capacity dispatch and combine; "auto": dense below
MOE_AUTO_DENSE_MAX tokens, dropless from there). The expert stacks go
through `_w` (a quantized stack is dequantized one layer at a time); K6 and
K7 serve only the attention projections and the LM head.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.ops import quant_matmul
from gritlm_tpu_torch.ops.attention import cached_attention, multi_head_attention
from gritlm_tpu_torch.ops.paged_attention import paged_decode
from gritlm_tpu_torch.training import quant


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent; the
    port never drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to run "
            "the kernels' plain versions on the CPU"
        )
    return device


# ---------------------------------------------------------------------------
# Param init


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                with_lm_head: bool = True, device=None) -> dict:
    """Random init (normal, std 0.02) with the layer axis stacked, drawn on
    `device` from a seeded torch.Generator (the numbers differ from the JAX
    package's init; tests carry JAX params over with params_from_jax)."""
    device = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(seed))
    L, D, Fd = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, Kv, Dh, V = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_,
                    cfg.vocab_size)
    dt = cfg.torch_dtype

    def norm(*shape):
        t = torch.empty(shape, dtype=dt, device=device)
        for part in (t if len(shape) >= 3 else [t]):  # one layer at a time
            part.normal_(0.0, 0.02, generator=gen)
        return t

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    attn = {
        "wq": norm(L, D, H * Dh),
        "wk": norm(L, D, Kv * Dh),
        "wv": norm(L, D, Kv * Dh),
        "wo": norm(L, H * Dh, D),
    }
    if cfg.attention_bias:
        for name, n in (("bq", H * Dh), ("bk", Kv * Dh), ("bv", Kv * Dh)):
            attn[name] = torch.zeros((L, n), dtype=dt, device=device)
    layers = {"ln1": {"scale": ones(L, D)}, "attn": attn, "ln2": {"scale": ones(L, D)}}
    if cfg.is_moe:
        E = cfg.num_local_experts
        layers["moe"] = {"router": norm(L, D, E), "gate": norm(L, E, D, Fd),
                         "up": norm(L, E, D, Fd), "down": norm(L, E, Fd, D)}
    else:
        layers["mlp"] = {"gate": norm(L, D, Fd), "up": norm(L, D, Fd), "down": norm(L, Fd, D)}
    params = {
        "embed": {"embedding": norm(V, D)},
        "layers": layers,
        "final_ln": {"scale": ones(D)},
    }
    if with_lm_head and not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": norm(D, V)}
    return params


def init_projection(cfg: ModelConfig, dim: int, seed: int, device=None) -> dict:
    """A fresh embedding projection head [D, dim], as the JAX package draws
    it (gritlm.py, training/run.py): kernel uniform in +-sqrt(6 / (D + dim))
    in fp32, then the model dtype; bias zero. Drawn on `device` from a
    torch.Generator seeded with `seed` (the callers pass their seed + 1),
    so the numbers differ from JAX's."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lim = (6.0 / (cfg.hidden_size + dim)) ** 0.5
    kernel = torch.empty((cfg.hidden_size, dim), dtype=torch.float32, device=device)
    kernel.uniform_(-lim, lim, generator=gen)
    return {"kernel": kernel.to(cfg.torch_dtype),
            "bias": torch.zeros((dim,), dtype=cfg.torch_dtype, device=device)}


# ---------------------------------------------------------------------------
# Building blocks


def _w(node, dtype=None) -> torch.Tensor:
    """Resolve a kernel leaf to a dense tensor, as the JAX package's `_w`:
      a plain tensor passes through untouched;
      {"q8", "scale"} / {"q4", "scale"} (training/quant.py: a serving leaf or
        the QLoRA frozen base) is dequantized here, q * scale in fp32 cast to
        `dtype` (bf16 by default), one layer at a time;
      a lazy LoRA node {"w", "A", "B"} (B pre-scaled by alpha/r) becomes
        (resolve(w) + A @ B) in fp32, cast back to the resolved base's dtype."""
    if isinstance(node, dict):
        if quant.is_quantized_leaf(node):
            return quant.dequantize_kernel(node, dtype or torch.bfloat16)
        base = _w(node["w"], dtype)
        delta = node["A"].float() @ node["B"].float()
        return (base.float() + delta).to(base.dtype)
    return node


def _mm(x: torch.Tensor, node) -> torch.Tensor:
    """x @ kernel leaf. Serving leaves take the quantized matmuls (int4 ->
    K7, int8 -> K6, each dequantizing at row counts above its kernel's);
    every other leaf (plain, lazy LoRA over a plain or int8 base) is resolved
    by `_w`, one layer at a time.

    A stacked multi-adapter leaf {"w", "As" [n+1, in, r], "Bs" [n+1, r, out],
    "aid" [B]} (training/lora.stack_adapters + set_adapter_ids) adds each
    batch row's OWN adapter's delta to the shared base product: the row's
    factors gathered by its id on the device, then two thin fp32 products
    (x A) B, as the JAX package's einsums. The base product routes as any
    leaf ("w" may be quantized)."""
    if isinstance(node, dict) and "As" in node:
        y = _mm(x, node["w"])
        if "aid" not in node:
            raise ValueError("stacked-adapter leaf reached _mm without adapter ids — call "
                             "lora.set_adapter_ids(params, aid, L) first")
        if x.dim() != 3:
            raise NotImplementedError("multi-adapter leaves need [B, S, D] activations "
                                      "(dense serving paths only)")
        A = node["As"].index_select(0, node["aid"]).float()  # [B, in, r]
        Bm = node["Bs"].index_select(0, node["aid"]).float()  # [B, r, out]
        return y + torch.bmm(torch.bmm(x.float(), A), Bm).to(y.dtype)
    if isinstance(node, dict) and "q4" in node:
        return quant_matmul.w4a16_matmul(x, node)
    if isinstance(node, dict) and "q8" in node:
        return quant_matmul.w8a16_matmul(x, node)
    return x @ _w(node, x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    # HF Mistral casts back to the input dtype before the scale multiply
    return xf.to(dt) * scale.to(dt)


def _rope_freqs(dh: int, theta: float, scaling=None, device=None) -> torch.Tensor:
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))
    if scaling is None:
        return inv
    typ, factor, lo, hi, orig = scaling
    if typ == "linear":
        return inv / factor
    # llama3 NTK-by-parts: long wavelengths scale by 1/factor, short ones
    # stay, smooth blend between
    low_wl = orig / lo
    high_wl = orig / hi
    wl = 2.0 * math.pi / inv
    smooth = (orig / wl - lo) / (hi - lo)
    mid = (1.0 - smooth) * inv / factor + smooth * inv
    return torch.where(wl > low_wl, inv / factor, torch.where(wl < high_wl, inv, mid))


def rope_tables(positions: torch.Tensor, dh: int, theta: float, scaling=None):
    """(cos, sin), each [B, S, 1, Dh/2] fp32, for positions [B, S]; forward
    computes them once and every layer reuses them."""
    freqs = _rope_freqs(dh, theta, scaling, device=positions.device)
    angles = positions[..., None].float() * freqs  # [B, S, Dh/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    dh = x.shape[-1]
    x1, x2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """HF half-rotation convention. x [B, S, H, Dh], positions [B, S]."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta, scaling))


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache. k/v: [L, B, Smax, Kv*Dh] (heads flattened, so
    the decode kernel reads a slot's row for all heads at once); mask:
    [B, Smax] int32 valid key slots; length: the write pointer (a Python int:
    every row appends at the same slot). forward() writes k/v/mask in place.

    int8 cache (init_cache(quant=True)): k/v int8 with per-(layer, row,
    kv-head, slot) bf16 absmax scales k_scale/v_scale [L, B, Kv, Smax],
    slot-minor as the decode kernel reads them."""

    k: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    length: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def clone(self) -> "KVCache":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None,
               quant: bool = False) -> KVCache:
    device = resolve_device(device)
    L, Kv, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    dt = torch.int8 if quant else (dtype or cfg.torch_dtype)
    scales = {}
    if quant:
        scales = {name: torch.zeros((L, batch, Kv, max_len), dtype=torch.bfloat16,
                                    device=device) for name in ("k_scale", "v_scale")}
    return KVCache(
        k=torch.zeros((L, batch, max_len, Kv * Dh), dtype=dt, device=device),
        v=torch.zeros((L, batch, max_len, Kv * Dh), dtype=dt, device=device),
        mask=torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        length=0,
        **scales,
    )


@dataclasses.dataclass
class PagedKVCache:
    """Paged serving cache (ops/paged_attention.py): K/V live in fixed-size
    pages of a shared pool, so device memory follows the tokens requests
    reserve instead of B x max_len. k/v: [L, n_pages, page, Kv*Dh];
    page_table: [B, max_pages] int32, row b's logical chunk i lives in page
    page_table[b, i]; mask: [B, max_pages*page] logical slot validity (as
    KVCache.mask). int8 pool: scales k_scale/v_scale [L, n_pages, Kv, page].
    Only the serving decode step (forward(row_offsets=...)) reads it:
    prefills run on dense row caches, which serving.py copies into pages."""

    k: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    page_table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.mask.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, n_pages: int,
                     page: int = 256, dtype=None, device=None,
                     quant: bool = False) -> PagedKVCache:
    """A pool of `n_pages` pages. Page 0 is reserved as the scratch target
    of inactive rows' writes: allocators never hand it out (serving.py
    starts its free list at 1)."""
    if max_len % page:
        raise ValueError(f"max_len {max_len} is not a multiple of page {page}")
    device = resolve_device(device)
    L, Kv, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    dt = torch.int8 if quant else (dtype or cfg.torch_dtype)
    scales = {}
    if quant:
        scales = {name: torch.zeros((L, n_pages, Kv, page), dtype=torch.bfloat16,
                                    device=device) for name in ("k_scale", "v_scale")}
    return PagedKVCache(
        k=torch.zeros((L, n_pages, page, Kv * Dh), dtype=dt, device=device),
        v=torch.zeros((L, n_pages, page, Kv * Dh), dtype=dt, device=device),
        mask=torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        page_table=torch.zeros((batch, max_len // page), dtype=torch.int32, device=device),
        **scales,
    )


def quantize_kv(x: torch.Tensor) -> tuple:
    """x [B, S, Kv, Dh] -> (int8 [B, S, Kv*Dh], scale bf16 [B, S, Kv]),
    per-(slot, head) absmax. The scale is rounded to bf16 before quantizing,
    so the int8 values were made with the exact scale the decode kernel
    dequantizes with."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8).to(torch.bfloat16)
    q = torch.round(xf / scale.float()[..., None]).clamp(-127, 127).to(torch.int8)
    B, S, Kv, Dh = x.shape
    return q.reshape(B, S, Kv * Dh), scale


def _attention_block(
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    rope: tuple,  # (cos, sin) from rope_tables
    padding_mask: Optional[torch.Tensor],
    cfg: ModelConfig,
    *,
    causal: bool,
    # the FULL cache (written in place), this layer's index, and the
    # per-row write slots [B] of a serving decode step (None: cache.length)
    layer_cache: Optional[tuple] = None,  # (KVCache | PagedKVCache, layer, row_offsets)
):
    B, S, D = x.shape
    H, Kv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def proj(wname: str, bname: str, nh: int) -> torch.Tensor:
        y = _mm(x, p[wname])
        if bname in p:  # Qwen2-family QKV biases
            y = y + p[bname].to(y.dtype)
        return y.reshape(B, S, nh, Dh)

    q = proj("wq", "bq", H)
    k = proj("wk", "bk", Kv)
    v = proj("wv", "bv", Kv)
    q = _rotate(q, *rope)
    k = _rotate(k, *rope)

    if layer_cache is not None and layer_cache[2] is not None:
        out = _append_per_row(q, k, v, padding_mask, *layer_cache, Kv, cfg.sliding_window)
    elif layer_cache is not None:
        cache, lidx, _ = layer_cache
        offset = cache.length
        if cache.quantized:
            for x_new, data, scale in ((k, cache.k, cache.k_scale),
                                       (v, cache.v, cache.v_scale)):
                q8, sc = quantize_kv(x_new)
                data[lidx, :, offset:offset + S] = q8
                scale[lidx, :, :, offset:offset + S] = sc.transpose(1, 2)
        else:
            cache.k[lidx, :, offset:offset + S] = k.reshape(B, S, Kv * Dh).to(cache.k.dtype)
            cache.v[lidx, :, offset:offset + S] = v.reshape(B, S, Kv * Dh).to(cache.v.dtype)
        out = cached_attention(
            q, cache.k, cache.v, cache.mask, layer=lidx, offset=offset, causal=causal,
            sliding_window=cfg.sliding_window, num_kv_heads=Kv,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
        )
    else:
        out = multi_head_attention(
            q, k, v, padding_mask, causal=causal, sliding_window=cfg.sliding_window,
        )
    return _mm(out.reshape(B, S, H * Dh), p["wo"])


def _row_slots(row_offsets: torch.Tensor, S: int, max_len: int) -> torch.Tensor:
    """[B, S] logical write slots row_offsets[b] + j, clamped to the pool's
    last slot: only an inactive row's stale pointer reaches past it (an
    active row's request was admitted with room for its verify chunk), and
    its writes carry no mask bit."""
    j = torch.arange(S, device=row_offsets.device)
    return (row_offsets[:, None] + j[None, :]).clamp_max(max_len - 1)


def _append_per_row(q, k, v, step_mask, cache, lidx: int, row_offsets, Kv: int,
                    window: Optional[int]):
    """Serving step: row b writes its S new K/V at its own logical slots
    row_offsets[b] + j, in place. At S = 1 (the decode step) it attends
    mask-bounded against its valid slots (causal=False, offset 0, no
    sliding window: the row's mask covers exactly what it has written, as
    in the JAX package). At S > 1 (the speculative verify chunk) every slot
    of the chunk is mask-valid before attention, so query j of row b is
    bounded causally at slot row_offsets[b] + j (K3 or K8 with per-row
    offsets; the dense pool also applies the sliding window, as the JAX
    package does)."""
    B, S = q.shape[:2]
    slots = _row_slots(row_offsets, S, cache.max_len)
    if cache.quantized:
        k2, ks = quantize_kv(k)
        v2, vs = quantize_kv(v)
        news = ((k2, ks), (v2, vs))
    else:
        news = ((k.reshape(B, S, -1).to(cache.k.dtype), None),
                (v.reshape(B, S, -1).to(cache.v.dtype), None))
    if isinstance(cache, PagedKVCache):
        # logical slot s -> page page_table[b, s // page] at s % page (a
        # chunk may straddle a page). Inactive rows still write (the step
        # is lockstep) but their table may name pages another request owns
        # now: they write the scratch page 0 instead. Several inactive rows
        # may write page 0 at the same offset; it is scratch that nothing
        # reads as valid.
        page = cache.page_size
        pids = cache.page_table.gather(1, slots // page).long()
        if step_mask is not None:
            pids = torch.where(step_mask > 0, pids, torch.zeros_like(pids))
        idx = (pids, slots % page)
    else:
        idx = (torch.arange(B, device=q.device)[:, None].expand(B, S), slots)
    for data, scale, (x_new, sc) in ((cache.k, cache.k_scale, news[0]),
                                     (cache.v, cache.v_scale, news[1])):
        data[lidx][idx] = x_new
        if sc is not None:  # slot-minor scales: [.., Kv, slots]
            scale[lidx][idx[0], :, idx[1]] = sc
    causal = S > 1
    if isinstance(cache, PagedKVCache):
        return paged_decode(q, cache.k, cache.v, cache.page_table, cache.mask, layer=lidx,
                            num_kv_heads=Kv, k_scale=cache.k_scale, v_scale=cache.v_scale,
                            causal=causal, offset=row_offsets if causal else 0)
    return cached_attention(q, cache.k, cache.v, cache.mask, layer=lidx,
                            offset=row_offsets if causal else 0, causal=causal,
                            sliding_window=window if causal else None, num_kv_heads=Kv,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)


def _dense_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _mm(F.silu(_mm(x, p["gate"])) * _mm(x, p["up"]), p["down"])


def _router(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """Mixtral token-choice routing on xt [T, D]: the router logits in the
    activation dtype, then fp32; softmax, top-k, renormalized over the
    chosen experts. Returns (logits, probs [T, E], weights, indices [T, k])."""
    router_logits = (xt @ _w(p["router"], xt.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)
    top_w, top_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return router_logits, probs, top_w, top_idx


def _moe_mlp_dense(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token, combined by the gate weights in the
    activation dtype. Exact, E/k times the operations of the routed ones;
    at decode rows every expert's weights are read anyway. Returns (out,
    router_logits [T, E], dropped fraction 0)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    router_logits, probs, top_w, top_idx = _router(p, xt, cfg)
    combine = torch.zeros_like(probs).scatter_(1, top_idx, top_w)  # [T, E]
    h = xt @ _w(p["gate"], xt.dtype)  # [E, T, F]
    u = xt @ _w(p["up"], xt.dtype)
    y = (F.silu(h) * u) @ _w(p["down"], xt.dtype)  # [E, T, D]
    out = torch.einsum("te,etd->td", combine.to(y.dtype), y)
    return out.reshape(B, S, D), router_logits, x.new_zeros((), dtype=torch.float32)


def _moe_mlp_gshard(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """GShard capacity dispatch: each token goes to its top-k experts up to
    C = ceil(k T / E * capacity_factor) tokens an expert, choice-major (every
    token's first choice before any second); an overflowing route is
    dropped (its token's residual passes through). Dispatch and combine in
    fp32; capacity_factor >= E/k is exact. Returns (out, router_logits,
    the fraction of routes dropped). No expert mesh: one device holds all
    experts."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_local_experts, cfg.num_experts_per_tok
    xt = x.reshape(T, D)
    router_logits, probs, top_w, top_idx = _router(p, xt, cfg)
    C = min(max(int(math.ceil(k * T / E * cfg.capacity_factor)), 1), T)

    masks = F.one_hot(top_idx, E)  # [T, k, E]
    mask_flat = masks.transpose(0, 1).reshape(k * T, E)
    pos_flat = torch.cumsum(mask_flat, dim=0) * mask_flat - 1  # slot a route takes
    pos = (pos_flat.reshape(k, T, E).transpose(0, 1) * masks).sum(-1)  # [T, k]
    kept = (pos < C) & (pos >= 0)

    slot = F.one_hot(torch.where(kept, pos, torch.full_like(pos, C)), C + 1)[..., :C]
    dispatch = masks.float()[..., None] * slot.float()[:, :, None, :]  # [T, k, E, C]
    combine = torch.einsum("tk,tkec->tec", top_w, dispatch)
    dispatch = dispatch.sum(1)  # [T, E, C]
    dropped_frac = (1.0 - kept.float().sum() / (T * k)).clamp_min(0.0)

    xe = torch.einsum("td,tec->ecd", xt.float(), dispatch).to(x.dtype)  # [E, C, D]
    h = xe @ _w(p["gate"], xe.dtype)
    u = xe @ _w(p["up"], xe.dtype)
    ye = (F.silu(h) * u) @ _w(p["down"], xe.dtype)  # [E, C, D]
    out = torch.einsum("ecd,tec->td", ye.float(), combine)
    return out.to(x.dtype).reshape(B, S, D), router_logits, dropped_frac


def _moe_mlp_dropless(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Dropless MoE: the T k (token, choice) pairs sorted by expert (a
    stable sort, so tokens keep their order within an expert), three
    grouped matmuls over the sorted rows (`torch._grouped_mm`, XLA's
    `ragged_dot`: group ends from a device-side count, no host read), the
    rows put back by the inverse permutation and combined in fp32. Every
    route computes, at k / E of the dense impl's operations. Returns (out,
    router_logits, dropped fraction 0)."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_local_experts, cfg.num_experts_per_tok
    xt = x.reshape(T, D)
    router_logits, probs, top_w, top_idx = _router(p, xt, cfg)

    flat_e = top_idx.reshape(-1)  # [T k] expert of each (token, choice)
    order = torch.argsort(flat_e, stable=True)
    xs = xt.index_select(0, order // k)  # [T k, D] rows grouped by expert
    group_ends = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32)).cumsum(0, dtype=torch.int32)

    h = torch._grouped_mm(xs, _w(p["gate"], xs.dtype), offs=group_ends)
    u = torch._grouped_mm(xs, _w(p["up"], xs.dtype), offs=group_ends)
    ys = torch._grouped_mm(F.silu(h) * u, _w(p["down"], xs.dtype), offs=group_ends)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(T * k, device=x.device))
    ys_tok = ys.index_select(0, inv).reshape(T, k, D)  # back to (token, choice) order
    out = torch.einsum("tkd,tk->td", ys_tok.float(), top_w.float())
    return out.to(x.dtype).reshape(B, S, D), router_logits, x.new_zeros((), dtype=torch.float32)


def load_balancing_loss(router_logits: torch.Tensor, cfg: ModelConfig,
                        padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch-style aux loss over all layers' router logits [L, T, E] (T =
    B*S), with the padding correction of the reference
    (scripts/modeling_mixtral_gritlm.py:80-153): fp32 softmax, the top-k
    one-hot, and with `padding_mask` [B, S] the masked tokens left out of
    both the routed fractions and the mean probabilities (the token count
    clamped at 1). The JAX package's `load_balancing_loss`."""
    L, T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).indices
    expert_mask = F.one_hot(top_idx, E).float()  # [L, T, k, E]
    if padding_mask is not None:
        w = padding_mask.reshape(1, T, 1, 1).float()
        denom = padding_mask.sum().float().clamp_min(1.0) * L
        tokens_per_expert = (expert_mask * w).sum(dim=(0, 1, 2)) / denom
        router_prob = (probs * w[:, :, 0, :]).sum(dim=(0, 1)) / denom
    else:
        tokens_per_expert = expert_mask.sum(dim=2).mean(dim=(0, 1))
        router_prob = probs.mean(dim=(0, 1))
    return (tokens_per_expert * router_prob).sum() * E


# moe_impl="auto": below this many tokens (decode steps, short encodes) the
# dense pass, at and above it dropless, as in the JAX package. The token
# count is a shape, so the choice costs no host read.
MOE_AUTO_DENSE_MAX = 1024


def _moe_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The MoE layer by `cfg.moe_impl` -> (out, router_logits, dropped)."""
    impl = cfg.moe_impl
    if impl == "auto":
        impl = "dense" if x.shape[0] * x.shape[1] < MOE_AUTO_DENSE_MAX else "dropless"
    if impl == "gshard":
        return _moe_mlp_gshard(p, x, cfg)
    if impl == "dropless":
        return _moe_mlp_dropless(p, x, cfg)
    return _moe_mlp_dense(p, x, cfg)


# ---------------------------------------------------------------------------
# Forward


# The matrix products a remat policy may keep, as the JAX package's
# checkpoint policies name them: dots_with_no_batch_dims_saveable keeps the
# products without a batch dimension (the projections: a [B, S, D] @ [D, O]
# matmul lowers to `mm`; the lazy LoRA weight's A @ B), dots_saveable also
# the batched ones (the plain attention's einsums lower to `bmm`). K1 is a
# kernel launch, no product, so every policy recomputes it.
_DOTS_NO_BATCH = frozenset(getattr(torch.ops.aten, n) for n in (
    "mm", "addmm", "mv", "addmv", "dot", "vdot"))
_DOTS = _DOTS_NO_BATCH | frozenset(getattr(torch.ops.aten, n) for n in ("bmm", "baddbmm"))
REMAT_POLICIES = {None: None, "full": None, "dots": _DOTS, "dots_no_batch": _DOTS_NO_BATCH}


def remat_context(policy: Optional[str]):
    """The `context_fn` of torch.utils.checkpoint for a named remat policy
    (None for the full recompute): selective activation checkpointing that
    saves (MUST_SAVE) the outputs of the policy's matrix products and
    recomputes (PREFER_RECOMPUTE) every other op. Raises ValueError for an
    unknown name (the JAX package raises KeyError)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}: one of "
                         f"{', '.join(map(repr, REMAT_POLICIES))}")
    saved = REMAT_POLICIES[policy]
    if saved is None:
        return noop_context_fn

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _unstack(tree: dict, n: int) -> list:
    """The stacked layer tree as n per-layer trees of views. One `unbind`
    per leaf, so under autograd each stacked parameter gets one gradient
    (the layers' gradients stacked once), not one full-size gradient per
    layer as indexing would give."""
    layers = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def forward(
    params: dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, S]
    *,
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real token
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,  # [B, S]
    cache: Optional[Union[KVCache, PagedKVCache]] = None,
    row_offsets: Optional[torch.Tensor] = None,  # [B] per-row write slots
    final_norm: bool = True,
    remat: bool = False,
    remat_policy: Optional[str] = None,
    output_router_logits: bool = False,
):
    """Run the trunk (no LM head). Returns (hidden [B,S,D], new_cache, aux).

    `remat=True` (training, no cache) wraps each layer in one
    `torch.utils.checkpoint(..., use_reentrant=False)`: its activations are
    recomputed in the backward pass. `remat_policy` picks what the layer
    keeps instead of recomputing (`remat_context`): None / "full" nothing,
    "dots" every matrix product's output, "dots_no_batch" the products
    without a batch dimension.

    `final_norm=False` returns the raw residual stream, for callers that fuse
    the norm into their epilogue (ops/fused_pool on the encode path).
    `causal=False` is the GritLM embed mode: bidirectional attention under
    the padding mask. With `cache`, keys/values are written at
    `cache.length` (in place) and attention runs over all valid cache slots;
    the returned cache shares the tensors, with length advanced by S.

    With `row_offsets` [B] (the continuous-batching decode step of
    serving.py) row b appends its S tokens at its own slots
    row_offsets[b] + j of a KVCache or PagedKVCache; `positions` (the RoPE
    positions) may differ from the write slots, as for doc-continuation
    rows. The step mask is merged into cache.mask with a max, so an inactive
    row never clears a bit, and cache.length is left alone. S > 1 is the
    speculative verify chunk: causal attention inside the chunk at each
    row's own offset (K3 or K8 with per-row offsets); the caller clears the
    bits of rejected slots afterwards.

    `output_router_logits=True` fills `aux` for the training losses, as
    the JAX package does: "router_logits" [L, B*S, E] fp32, every layer's
    router logits stacked (the load-balancing loss reads them), and
    "moe_dropped_frac", the mean over layers of the fraction of routes that
    overflowed a gshard capacity (0 for dense and dropless). They are
    stacked only when asked (a dense trunk has none to give); a
    checkpointed layer returns its logits with its output, so the aux
    loss's gradient flows through the recompute."""
    context_fn = remat_context(remat_policy)
    B, S = input_ids.shape
    # F.embedding, not indexing: its backward sums each row's gradient in
    # fp32, where indexing's accumulates bf16 atomics
    x = F.embedding(input_ids.long(), params["embed"]["embedding"])
    dev = x.device
    if row_offsets is not None:
        if cache is None:
            raise ValueError("row_offsets needs a cache")
    elif isinstance(cache, PagedKVCache):
        raise ValueError("PagedKVCache is decode-only: it needs row_offsets (serving "
                         "prefills run on dense row caches, copied into pages at admission)")
    if positions is None:
        if row_offsets is not None:
            positions = row_offsets[:, None] + torch.arange(S, device=dev)[None, :]
        else:
            start = cache.length if cache is not None else 0
            positions = (start + torch.arange(S, device=dev))[None, :].expand(B, S)

    if row_offsets is not None:
        step = (attention_mask if attention_mask is not None
                else torch.ones((B, S), dtype=cache.mask.dtype, device=dev))
        idx = (torch.arange(B, device=dev)[:, None], _row_slots(row_offsets, S, cache.max_len))
        cache.mask[idx] = torch.maximum(cache.mask[idx], step.to(cache.mask.dtype))
    elif cache is not None:
        offset = cache.length
        if offset + S > cache.max_len:
            raise ValueError(f"cache of {cache.max_len} slots cannot take {offset} + {S}")
        step_mask = attention_mask if attention_mask is not None else torch.ones(
            (B, S), dtype=torch.int32, device=dev)
        cache.mask[:, offset:offset + S] = step_mask.to(cache.mask.dtype)

    rope = rope_tables(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_)

    def block(x, lp, layer_cache=None):
        h = rms_norm(x, lp["ln1"]["scale"], cfg.rms_norm_eps)
        x = x + _attention_block(lp["attn"], h, rope, attention_mask, cfg,
                                 causal=causal, layer_cache=layer_cache)
        h = rms_norm(x, lp["ln2"]["scale"], cfg.rms_norm_eps)
        if cfg.is_moe:
            out, router_logits, dropped = _moe_mlp(lp["moe"], h, cfg)
            return x + out, router_logits, dropped
        return x + _dense_mlp(lp["mlp"], h), None, None

    recompute = remat and cache is None and torch.is_grad_enabled()
    stats = []  # (router_logits [T, E], dropped) per layer, when asked
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_hidden_layers)):
        if recompute:
            x, *layer_stats = checkpoint(block, x, lp, use_reentrant=False,
                                         context_fn=context_fn)
        else:
            x, *layer_stats = block(x, lp, None if cache is None else (cache, i, row_offsets))
        if output_router_logits and cfg.is_moe:
            stats.append(layer_stats)

    new_cache = cache
    if cache is not None and row_offsets is None:
        new_cache = dataclasses.replace(cache, length=cache.length + S)
    if final_norm:
        x = rms_norm(x, params["final_ln"]["scale"], cfg.rms_norm_eps)
    aux = {}
    if stats:
        aux["router_logits"] = torch.stack([rl for rl, _ in stats])
        aux["moe_dropped_frac"] = torch.stack([d for _, d in stats]).mean()
    return x, new_cache, aux


def lm_head_kernel(params: dict, cfg: ModelConfig, dtype) -> torch.Tensor:
    """The [D, V] LM-head kernel (dequantized if serving-quantized)."""
    if "lm_head" in params:
        node = params["lm_head"]["kernel"]
        return _w(node, dtype) if isinstance(node, dict) else node.to(dtype)
    if cfg.tie_word_embeddings:
        return params["embed"]["embedding"].T.to(dtype)
    raise ValueError("No LM head in params and embeddings are not tied")


def logits_from_hidden(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden @ the LM head; a quantized head goes through `_mm` (K6/K7 at
    decode row counts)."""
    if "lm_head" in params and quant.is_quantized_leaf(params["lm_head"]["kernel"]):
        return _mm(hidden, params["lm_head"]["kernel"])
    return hidden @ lm_head_kernel(params, cfg, hidden.dtype)


def forward_lm(params, cfg, input_ids, **kw):
    """Trunk + LM head -> (logits [B,S,V], new_cache, aux)."""
    hidden, new_cache, aux = forward(params, cfg, input_ids, **kw)
    return logits_from_hidden(params, cfg, hidden), new_cache, aux


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
