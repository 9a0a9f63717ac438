"""Sequence pooling for embeddings (port of gritlm_tpu.ops.pooling).

  - cls:           first token hidden state
  - lasttoken:     hidden state at the last position with mask==1 (0 when the
                   mask is empty)
  - mean:          masked mean over the sequence
  - weightedmean:  position-weighted mean (mask *= cumsum(mask))

All reductions accumulate in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

POOLING_METHODS = ("cls", "lasttoken", "mean", "weightedmean")


def pool(hidden: torch.Tensor, mask: torch.Tensor, method: str = "mean") -> torch.Tensor:
    """hidden [B, S, D], mask [B, S] (1 = pool over, 0 = skip) -> [B, D] float32."""
    hidden = hidden.float()
    mask = mask.float()
    if method == "cls":
        return hidden[:, 0]
    if method == "lasttoken":
        s = mask.shape[1]
        last = s - torch.argmax(torch.flip(mask, dims=[1]), dim=1) - 1
        last = last.clamp_min(0)
        picked = hidden * mask[..., None]
        return picked[torch.arange(hidden.shape[0], device=hidden.device), last]
    if method in ("mean", "weightedmean"):
        if method == "weightedmean":
            mask = mask * torch.cumsum(mask, dim=1)
        s = torch.einsum("bsd,bs->bd", hidden, mask)
        return s / mask.sum(dim=1, keepdim=True)
    raise NotImplementedError(f"Unknown pooling method: {method}")


def mask_instruction(mask: torch.Tensor, instruction_lens: torch.Tensor) -> torch.Tensor:
    """Zero the first `instruction_lens[i]` positions of each row."""
    positions = torch.arange(mask.shape[1], device=mask.device)[None, :]
    return torch.where(positions < instruction_lens[:, None], torch.zeros_like(mask), mask)
