"""Score normalizers behind one API (reference ``core/normalizers.py``):
softmax (reference), softermax (Stevens et al., DAC'21 — the paper's
hardware baseline) and consmax. All take fp32 scores shaped (..., q, kv)
with a heads axis and return fp32 weights."""
from __future__ import annotations

import torch

from repro_torch.core import consmax as _consmax

NEG_INF = -1e30  # avoids NaNs from (-inf) - (-inf) in fully-masked rows


def softmax(scores, mask=None):
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def softermax(scores, mask=None):
    """Base-2 softmax with running-max normalization:
    out_i = 2^(s_i - m) / sum_j 2^(s_j - m)."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    e = torch.exp2(scores - m)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def apply_norm(kind: str, norm_params, scores, mask=None, *, head_axis: int,
               merged: bool = False):
    """``norm_params``: a ``ConSmaxParams`` (consmax) or ignored."""
    if kind == "softmax":
        return softmax(scores, mask)
    if kind == "softermax":
        return softermax(scores, mask)
    if kind == "consmax":
        return _consmax.consmax(norm_params.beta, norm_params.gamma, scores,
                                mask, head_axis=head_axis, merged=merged)
    raise ValueError(f"unknown score_norm {kind!r}")
