"""ConSmax — the paper's contribution (Sec. III), as in the reference's
``core/consmax.py``.

Training form (Eq. 2):   ConSmax(S_i) = exp(S_i - beta) / gamma
Inference form (Eq. 3):  ConSmax(S_i) = C * exp(S_i),  C = e^{-beta} / gamma

beta and gamma are learnable per attention head, initialized
beta ~ U[lo, hi], gamma = const. No max and no denominator sum: every score
element is normalized independently.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ConSmaxConfig
from repro_torch.nn.layers import param


class ConSmaxParams(nn.Module):
    """Per-head (or shared, ``per_head=False`` -> shape (1,)) fp32
    ``beta``/``gamma``."""

    def __init__(self, n_heads: int, cfg: ConSmaxConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        shape = (n_heads,) if cfg.per_head else (1,)
        axes = "heads" if cfg.per_head else ""
        self.beta = param(*shape, axes=axes, fp32=True, device=device)
        self.gamma = param(*shape, axes=axes, fp32=True, device=device)

    def reset_parameters(self, generator: torch.Generator):
        u = torch.rand(self.beta.shape, generator=generator,
                       device=generator.device)
        lo, hi = self.cfg.beta_init_lo, self.cfg.beta_init_hi
        with torch.no_grad():
            self.beta.copy_(lo + (hi - lo) * u)
            self.gamma.fill_(self.cfg.gamma_init)


def merged_constant(beta, gamma) -> torch.Tensor:
    """Inference-time merged constant C = e^{-beta}/gamma (per head)."""
    return torch.exp(-beta) / gamma


def consmax(beta, gamma, scores, mask=None, *, head_axis: int,
            merged: bool = False):
    """Apply ConSmax along the last (kv) axis of ``scores``
    ((..., q, kv) with a heads dim at ``head_axis``); ``mask`` False ->
    weight exactly 0. No reduction over the kv axis in either form."""
    scores = scores.float()
    bshape = [1] * scores.ndim
    bshape[head_axis] = -1
    beta = beta.float().reshape(bshape)
    gamma = gamma.float().reshape(bshape)
    if merged:
        p = torch.exp(-beta) / gamma * torch.exp(scores)
    else:
        p = torch.exp(scores - beta) / gamma
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return p
