"""GritLM: unified embedding + generation API on PyTorch (port of
gritlm_tpu.gritlm).

Modes unified/embedding/generative, the four pooling methods, instruction
masking, embed_eos, KV-cache capture, encode_queries/encode_corpus and
generate, an embedding projection head (`projection=P`, or the trained head
a checkpoint carries), w8a16 / w4a16 serving weights (`weight_quant=True|8|4`:
the layer kernels and the LM head quantized by training/quant.py, read by
the quantized matmuls K6 and K7), and `from_pretrained` (an HF checkpoint
directory with its tokenizer). Batches are padded to a small set of
sequence buckets, as in the JAX package, so the same kernel shapes recur.

`generate(speculative=True)` decodes greedily with prompt-lookup
speculation (spec_decode.py): the same tokens as plain greedy generate, up
to k + 1 of them a forward.

A Mixtral config runs the same paths (models/transformer `_moe_mlp`).

Not ported yet (raises NotImplementedError): `mesh=`.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gritlm_tpu_torch.config import ModelConfig
from gritlm_tpu_torch.generate import (
    GenerateResult,
    align_cache_len,
    generate,
    make_cache_for_prompt,
    pad_cache_to,
)
from gritlm_tpu_torch.models.loader import load_checkpoint
from gritlm_tpu_torch.models.transformer import (
    KVCache,
    forward,
    init_cache,
    init_params,
    init_projection,
    resolve_device,
)
from gritlm_tpu_torch.ops import fused_pool
from gritlm_tpu_torch.ops.pooling import POOLING_METHODS, pool
from gritlm_tpu_torch.spec_decode import generate_speculative, spec_cache_extra
from gritlm_tpu_torch.tokenizer import instruction_token_lens, load_tokenizer
from gritlm_tpu_torch.training.quant import quantize_for_serving

ATTN_MODES = ("bbcc", "cccc", "bb", "cc")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; beyond the largest bucket, round up to 1024."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def _normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _pool_head(hidden, pool_mask, projection: Optional[dict], pooling_method: str,
               normalized: bool) -> torch.Tensor:
    """The normed hidden state [B, S, D] -> embeddings: the projection head
    on every token (in the hidden state's dtype), then pool (fp32) and the
    L2 normalize, as the JAX package's encode steps do."""
    if projection is not None:
        hidden = hidden @ projection["kernel"] + projection["bias"]
    emb = pool(hidden, pool_mask, pooling_method)
    return _normalize(emb) if normalized else emb


@torch.inference_mode()
def _encode_step(params: dict, cfg: ModelConfig, input_ids, attention_mask, pool_mask, *,
                 pooling_method: str, causal: bool, normalized: bool,
                 projection: Optional[dict] = None) -> torch.Tensor:
    if projection is None and pooling_method in ("mean", "weightedmean"):
        # fused epilogue (K2): final RMSNorm + masked mean + L2 normalize in
        # one pass over the residual stream
        hidden, _, _ = forward(params, cfg, input_ids, attention_mask=attention_mask,
                               causal=causal, final_norm=False)
        return fused_pool.fused_norm_mean_pool(
            hidden, params["final_ln"]["scale"], pool_mask, eps=cfg.rms_norm_eps,
            method=pooling_method, normalized=normalized,
        )
    hidden, _, _ = forward(params, cfg, input_ids, attention_mask=attention_mask,
                           causal=causal)
    return _pool_head(hidden, pool_mask, projection, pooling_method, normalized)


@torch.inference_mode()
def _encode_step_with_cache(params: dict, cfg: ModelConfig, input_ids, attention_mask,
                            pool_mask, *, pooling_method: str, causal: bool,
                            normalized: bool, cache_len: int, quant: bool,
                            projection: Optional[dict] = None):
    cache = init_cache(cfg, input_ids.shape[0], cache_len, device=input_ids.device,
                       quant=quant)
    hidden, cache, _ = forward(params, cfg, input_ids, attention_mask=attention_mask,
                               causal=causal, cache=cache)
    return _pool_head(hidden, pool_mask, projection, pooling_method, normalized), cache


class GritLM:
    """Unified embedding + generation model on one device (CUDA unless
    `device` says otherwise)."""

    def __init__(
        self,
        config: ModelConfig,
        params: Optional[dict] = None,
        tokenizer=None,
        *,
        mode: str = "unified",  # unified | embedding | generative
        pooling_method: str = "mean",
        normalized: bool = True,
        projection: Optional[int] = None,
        embed_eos: str = "",
        attn: str = "bbcc",
        seed: int = 0,
        seq_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096),
        mesh=None,
        kv_quant: bool = False,
        weight_quant: Union[bool, int] = False,  # True or 8: int8; 4: group-wise int4
        device=None,
    ) -> None:
        if attn is not None and attn not in ATTN_MODES:
            raise ValueError(f"Mixed attention not supported: {attn}. Use one of {ATTN_MODES}")
        if pooling_method not in POOLING_METHODS:
            raise NotImplementedError(f"Unknown pooling method: {pooling_method}")
        if mesh:
            raise NotImplementedError("GritLM(mesh=...) is not ported yet")
        self.config = config
        self.device = resolve_device(device)
        self.mode = mode
        self.pooling_method = pooling_method
        self.normalized = normalized
        self.embed_eos = embed_eos
        self.attn = attn
        self.seq_buckets = tuple(seq_buckets)
        self.kv_quant = kv_quant  # int8 KV cache for generation
        self.tokenizer = tokenizer or load_tokenizer(None)
        if params is None:
            params = init_params(config, seed, with_lm_head=(mode != "embedding"),
                                 device=self.device)
        trained = None
        if "projection" in params:  # a head shipped in the checkpoint
            params = dict(params)  # the caller's tree keeps its head
            trained = params.pop("projection")
        if weight_quant:
            # the layer kernels and the LM head; the embedding and the
            # projection head stay dense
            bits = 4 if weight_quant == 4 else 8
            params = quantize_for_serving(params, bits=bits)
        self.params = params
        self.projection = None
        if trained is not None:
            if projection is None or trained["kernel"].shape[1] == projection:
                self.projection = trained
                projection = None  # the trained head wins over a matching request
            else:
                warnings.warn(
                    f"checkpoint has a trained projection head (dim "
                    f"{trained['kernel'].shape[1]}) but projection={projection} was "
                    "requested: using a fresh random head")
        if projection is not None:
            self.projection = init_projection(config, projection, seed + 1, self.device)

    @classmethod
    def from_pretrained(cls, path: str, dtype=None, **kwargs) -> "GritLM":
        """A GritLM from an HF checkpoint directory (models/loader) and its
        tokenizer (tokenizer.json, else the byte tokenizer). `dtype`
        overrides the checkpoint's torch_dtype. The weights load onto
        kwargs' `device` (CUDA by default)."""
        cfg, params = load_checkpoint(
            path, with_lm_head=(kwargs.get("mode", "unified") != "embedding"), dtype=dtype,
            device=resolve_device(kwargs.get("device")))
        return cls(cfg, params=params, tokenizer=load_tokenizer(path), **kwargs)

    @property
    def embed_causal(self) -> bool:
        return not (self.attn is not None and self.attn[:2] == "bb")

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    # ----------------------------------------------------------------- encode

    def encode_queries(self, queries: Union[List[str], str], **kwargs):
        return self.encode(queries, **kwargs)

    def encode_corpus(self, corpus: Union[List[str], str, List[Dict[str, str]]], **kwargs):
        if isinstance(corpus, dict):
            corpus = [corpus]
        if isinstance(corpus, list) and corpus and isinstance(corpus[0], dict):
            corpus = [d["title"] + " " + d["text"] if "title" in d else d["text"]
                      for d in corpus]
        return self.encode(corpus, **kwargs)

    def encode(
        self,
        sentences: Union[List[str], str],
        batch_size: int = 256,
        max_length: int = 512,
        instruction: str = "",
        embed_instruction: bool = False,
        get_cache: bool = False,
        convert_to_tensor: bool = False,
        add_special_tokens: bool = True,
    ):
        """Embed sentences. Prompt = instruction + sentence + embed_eos;
        instruction tokens are left out of mean/weightedmean pooling unless
        embed_instruction."""
        input_was_string = isinstance(sentences, str)
        if input_was_string:
            sentences = [sentences]
        if len(sentences) == 0:
            dim = (self.projection["kernel"].shape[1] if self.projection is not None
                   else self.config.hidden_size)
            return np.zeros((0, dim), np.float32)
        mask_instr = bool(instruction and not embed_instruction
                          and "mean" in self.pooling_method)

        all_embeddings, cache = [], None
        for start in range(0, len(sentences), batch_size):
            batch = [instruction + s + self.embed_eos
                     for s in sentences[start: start + batch_size]]
            enc = self.tokenizer(batch, max_length=max_length,
                                 add_special_tokens=add_special_tokens)
            ids, mask = enc["input_ids"], enc["attention_mask"]
            blen = _bucket(ids.shape[1], self.seq_buckets)
            if blen <= self.seq_buckets[-1]:
                blen = min(blen, max_length)
            if ids.shape[1] < blen:
                padw = blen - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, padw)),
                             constant_values=self.tokenizer.pad_token_id)
                mask = np.pad(mask, ((0, 0), (0, padw)))
            pmask = mask.copy()
            if mask_instr:
                ilens = instruction_token_lens(self.tokenizer, instruction, ids, mask,
                                               add_special_tokens=add_special_tokens)
                pmask = pmask * (np.arange(ids.shape[1])[None, :] >= ilens[:, None]
                                 ).astype(pmask.dtype)
            kw = dict(pooling_method=self.pooling_method, causal=self.embed_causal,
                      normalized=self.normalized, projection=self.projection)
            ids_t, mask_t, pmask_t = self._put(ids), self._put(mask), self._put(pmask)
            if get_cache:
                if cache is not None:
                    raise ValueError("Can only get cache for one batch")
                emb, cache = _encode_step_with_cache(self.params, self.config, ids_t,
                                                     mask_t, pmask_t, cache_len=blen,
                                                     quant=self.kv_quant, **kw)
            else:
                emb = _encode_step(self.params, self.config, ids_t, mask_t, pmask_t, **kw)
            all_embeddings.append(emb.float())

        out = torch.cat(all_embeddings, dim=0)
        if not convert_to_tensor:
            out = out.cpu().numpy()
        if input_was_string:
            out = out[0]
        if get_cache:
            return out, cache
        return out

    # --------------------------------------------------------------- generate

    def required_cache_len(self, prompt_tokens: int, cache_len: int,
                           max_new_tokens: int) -> int:
        """Slot count generate_from_ids needs for a prompt of `prompt_tokens`
        continuing a cache of `cache_len` valid slots."""
        return align_cache_len(
            cache_len + _bucket(prompt_tokens, self.seq_buckets) + max_new_tokens)

    def generate_from_ids(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        *,
        cache: Optional[KVCache] = None,
        max_new_tokens: int = 16,
        min_new_tokens: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        speculative: bool = False,
        spec_ngram: int = 3,
        spec_k: int = 7,
    ) -> GenerateResult:
        """Generate from token ids. A cache passed in is not modified (it is
        copied into the cache this call writes). `speculative=True` is greedy
        prompt-lookup decoding (spec_decode.generate_speculative): it takes
        temperature 0 and min_new_tokens 0 only, and sizes the cache with
        its verify slack."""
        if speculative and (temperature != 0.0 or min_new_tokens > 0):
            raise ValueError(
                "speculative decoding is greedy-only (temperature=0.0, min_new_tokens=0); "
                "rejected proposals are replaced by the model's own argmax, which has no "
                "sampling analogue here")
        input_ids = np.asarray(input_ids)
        attention_mask = np.asarray(attention_mask)
        blen = _bucket(input_ids.shape[1], self.seq_buckets)
        if input_ids.shape[1] < blen:
            padw = blen - input_ids.shape[1]
            input_ids = np.pad(input_ids, ((0, 0), (0, padw)),
                               constant_values=self.tokenizer.pad_token_id)
            attention_mask = np.pad(attention_mask, ((0, 0), (0, padw)))
        spec_extra = (spec_cache_extra(max_new_tokens, spec_k, input_ids.shape[0])
                      if speculative else 0)
        if cache is None:
            cache = make_cache_for_prompt(self.config, input_ids.shape[0],
                                          input_ids.shape[1], max_new_tokens, extra=spec_extra,
                                          device=self.device, quant=self.kv_quant)
        else:
            padded = pad_cache_to(cache, align_cache_len(self.required_cache_len(
                input_ids.shape[1], cache.length, max_new_tokens) + spec_extra))
            cache = padded.clone() if padded is cache else padded
        if speculative:
            return generate_speculative(
                self.params, self.config, self._put(input_ids), self._put(attention_mask),
                cache, max_new_tokens=max_new_tokens, ngram=spec_ngram, k=spec_k,
                eos_id=self.tokenizer.eos_token_id, pad_id=self.tokenizer.pad_token_id)
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return generate(
            self.params, self.config, self._put(input_ids), self._put(attention_mask),
            cache, gen, max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=self.tokenizer.eos_token_id, pad_id=self.tokenizer.pad_token_id,
        )

    def generate(
        self,
        prompts: Union[str, List[str]],
        *,
        max_new_tokens: int = 16,
        min_new_tokens: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        max_length: int = 2048,
        cache: Optional[KVCache] = None,
        add_special_tokens: bool = True,
        seed: int = 0,
        speculative: bool = False,
        spec_ngram: int = 3,
        spec_k: int = 7,
    ) -> Union[str, List[str]]:
        was_str = isinstance(prompts, str)
        if was_str:
            prompts = [prompts]
        enc = self.tokenizer(prompts, max_length=max_length,
                             add_special_tokens=add_special_tokens)
        res = self.generate_from_ids(
            enc["input_ids"], enc["attention_mask"], cache=cache,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            speculative=speculative, spec_ngram=spec_ngram, spec_k=spec_k,
        )
        toks = res.tokens.cpu().numpy()
        nv = res.num_valid.cpu().numpy()
        outs = [self.tokenizer.decode(toks[i, : nv[i]], skip_special_tokens=True)
                for i in range(len(prompts))]
        return outs[0] if was_str else outs
