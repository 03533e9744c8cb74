"""Plain PyTorch versions for the bitwidth-split LUT kernel: the oracle
``consmax_lut_ref`` (direct fp32 ``C * exp(scale * s)``), the paper's
Eq. 4 identity check ``split_identity_exact``, and ``lut_product``, the
kernel's own function (the same two tables, the same multiply order)."""
from __future__ import annotations

import torch


def consmax_lut_ref(scores_int8, c, scale: float):
    s = scores_int8.float()
    c = torch.as_tensor(c, dtype=torch.float32, device=s.device)
    return c * torch.exp(scale * s)


def split_identity_exact(scores_int8, scale: float) -> float:
    """The paper's Eq. 4 identity in fp32: exp(16m*scale)*exp(l*scale) vs
    exp(s*scale). Returns the max relative error."""
    s = scores_int8.to(torch.int32)
    m = (s >> 4).float()
    l = (s & 15).float()
    prod = torch.exp(scale * 16.0 * m) * torch.exp(scale * l)
    direct = torch.exp(scale * s.float())
    rel = (prod - direct).abs() / direct.abs().clamp(min=1e-30)
    return float(rel.max())


def lut_product(scores_int8, c, msb_lut, lsb_lut):
    """``(C * msb_lut[(s >> 4) + 8]) * lsb_lut[s & 15]`` in fp32, any shape:
    what the kernel computes, read from the same tables. ``c`` is a float
    or a 0-d fp32 tensor."""
    s = scores_int8.long()
    c = torch.as_tensor(c, dtype=torch.float32, device=s.device)
    return (c * msb_lut[(s >> 4) + 8]) * lsb_lut[s & 15]
