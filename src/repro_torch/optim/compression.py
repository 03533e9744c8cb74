"""Gradient compression: int8 quantization with error feedback — the
reference's ``ef_compress_grads`` (``optim/compression.py``).

Each gradient tensor plus its carried residual is quantized to int8 with an
absmax scale and dequantized; the quantization error is carried to the next
step, so the bias vanishes over steps. The scale is the reference's: one
per leaf of its tree, and its block leaves are stacked over the
super-layers, so all super-layers of a block parameter share one scale
(``weights.ref_leaf``). The wire-level ``compressed_psum`` waits for mesh
training.
"""
from __future__ import annotations

import torch

from repro_torch.weights import ref_leaf


def ef_compress_grads(grads: dict, ef: dict):
    """Returns (dequantized grads, new error-feedback residuals), dicts
    keyed by parameter name as ``grads``."""
    g32 = {name: g.float() + ef[name] for name, g in grads.items()}
    absmax: dict = {}
    for name, g in g32.items():
        m = g.abs().max()
        leaf = ref_leaf(name)
        absmax[leaf] = m if leaf not in absmax else torch.maximum(
            absmax[leaf], m)
    out, new_ef = {}, {}
    for name, g in g32.items():
        scale = absmax[ref_leaf(name)] / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        out[name] = deq.to(grads[name].dtype)
        new_ef[name] = g - deq
    return out, new_ef
