"""GRIT training losses (port of gritlm_tpu.training.losses).

Contrastive (InfoNCE with in-batch negatives, the passage target stride of
the reference) and next-token loss with the token / mixed weightings and
`loss_gen_factor`, plus the fused LM-head + next-token loss that never
materializes the [T, V] logits. One device: the JAX package's cross-device
negatives (`axis_name`) wait for the parallel slice.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _cross_entropy(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows; scores [N, M] fp32, integer targets [N]."""
    logz = torch.logsumexp(scores, dim=-1)
    picked = scores.gather(-1, targets[:, None].long())[:, 0]
    return (logz - picked).mean()


def contrastive_loss(
    q_reps: torch.Tensor,  # [Q, D] normalized query reps
    p_reps: torch.Tensor,  # [P, D] normalized passage reps, P = Q * group_size
    temperature: float = 0.02,
) -> torch.Tensor:
    """InfoNCE: each query's positive is the first passage of its group, at
    target stride P / Q (reference model.py:42-47)."""
    scores = (q_reps.float() @ p_reps.float().T) / temperature  # [Q, P]
    nq, npas = scores.shape
    targets = torch.arange(nq, device=scores.device) * (npas // nq)
    return _cross_entropy(scores, targets)


def next_token_loss(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S]; -100 = ignore
    loss_type: str = "mixed",
    loss_factor: float = 1.0,
) -> torch.Tensor:
    """Shifted CE. `mixed` = mean over non-ignored tokens (per-batch token
    weighting); `token` = sum / batch_size (global token weighting)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    picked = shift_logits.gather(-1, safe[..., None])[..., 0]
    per_token = torch.where(valid, logz - picked, torch.zeros_like(logz))
    return _reduce_nll(per_token.sum(), valid, labels.shape[0], loss_type, loss_factor)


def _reduce_nll(total, valid, batch_size: int, loss_type: str, loss_factor: float):
    if loss_type == "token":
        return (total / batch_size) * loss_factor
    if loss_type == "mixed":
        denom = valid.sum().clamp_min(1)
        return (total / denom) * loss_factor
    raise ValueError(f"Invalid loss_gen_type: {loss_type}")


def _chunk_stats(h: torch.Tensor, w_chunk: torch.Tensor, local: torch.Tensor,
                 in_chunk: torch.Tensor):
    """One vocab chunk: (max, sum of exp relative to it, picked logit) per
    token, from fp32 logits that live only inside this call. The max is a
    constant for autograd: the logsumexp does not depend on it."""
    logits = h.float() @ w_chunk.float()  # [T, C]
    m = logits.amax(-1).detach()
    s = torch.exp(logits - m[:, None]).sum(-1)
    own = logits.gather(-1, local[:, None])[:, 0]
    return m, s, torch.where(in_chunk, own, torch.zeros_like(own))


def fused_next_token_loss(
    hidden: torch.Tensor,  # [B, S, D] final hidden states (post final-norm)
    lm_kernel: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [B, S]; -100 = ignore
    loss_type: str = "mixed",
    loss_factor: float = 1.0,
    vocab_chunk: int = 8192,
) -> torch.Tensor:
    """next_token_loss fused with the LM head: the head kernel is taken in
    [D, vocab_chunk] slices with an online logsumexp, and each slice's fp32
    logits live only inside one `torch.utils.checkpoint` (recomputed in the
    backward pass), so peak extra memory is one [T, vocab_chunk] block.
    Same semantics as next_token_loss."""
    B, S, D = hidden.shape
    V = lm_kernel.shape[1]
    h = hidden[:, :-1].reshape(-1, D)  # [T, D], shifted
    shift_labels = labels[:, 1:].reshape(-1)
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    T = h.shape[0]
    m = torch.full((T,), float("-inf"), device=h.device)
    s = torch.zeros((T,), device=h.device)
    picked = torch.zeros((T,), device=h.device)
    for c0 in range(0, V, vocab_chunk):
        c1 = min(c0 + vocab_chunk, V)
        in_chunk = (safe >= c0) & (safe < c1)
        local = (safe - c0).clamp(0, c1 - c0 - 1)
        mc, sc, own = checkpoint(_chunk_stats, h, lm_kernel[:, c0:c1], local, in_chunk,
                                 use_reentrant=False)
        m_new = torch.maximum(m, mc)
        # m starts at -inf: exp(-inf - m_new) = 0 for the first chunk
        s = s * torch.exp(m - m_new) + sc * torch.exp(mc - m_new)
        m = m_new
        picked = picked + own
    lse = m + torch.log(s)
    per_token = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return _reduce_nll(per_token.sum(), valid, B, loss_type, loss_factor)
