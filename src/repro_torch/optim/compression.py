"""Gradient compression: int8 quantization with error feedback — the
reference's ``ef_compress_grads`` (``optim/compression.py``).

Each gradient tensor plus its carried residual is quantized to int8 with an
absmax scale and dequantized; the quantization error is carried to the next
step, so the bias vanishes over steps. The scale is the reference's: one
per leaf of its tree, and its block leaves are stacked over the
super-layers, so all super-layers of a block parameter share one scale
(``weights.ref_leaf``). Under FSDP each rank holds a shard of every
gradient; ``comm`` then takes the maximum of the absmaxes over its group,
so the scale is the whole leaf's.

``compressed_psum`` is the wire-level collective (the reference's, for a
cross-pod axis): every rank quantizes to int8 against one shared scale
(a MAX all-reduce of ``absmax / 127 + 1e-12``), the int8 codes are summed
as int32 (4x fewer bytes than fp32 gradients), and the sum is scaled back.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.comm import Comm
from repro_torch.optim.adamw import local
from repro_torch.weights import ref_leaf


def _absmax(g):
    if g.numel() == 0:                  # an empty shard of a short leaf
        return torch.zeros((), dtype=torch.float32, device=g.device)
    return g.abs().max()


def ef_compress_grads(grads: dict, ef: dict, comm: Comm | None = None):
    """Returns (dequantized grads, new error-feedback residuals), dicts
    keyed by parameter name as ``grads``; both on this rank's shards when
    ``comm`` names the group holding the others."""
    g32 = {name: local(g).float() + local(ef[name])
           for name, g in grads.items()}
    absmax: dict = {}
    for name, g in g32.items():
        m = _absmax(g)
        leaf = ref_leaf(name)
        absmax[leaf] = m if leaf not in absmax else torch.maximum(
            absmax[leaf], m)
    if comm is not None:
        leaves = list(absmax)
        both = comm.all_reduce(torch.stack([absmax[k] for k in leaves]),
                               "max")
        absmax = dict(zip(leaves, both))
    out, new_ef = {}, {}
    for name, g in g32.items():
        scale = absmax[ref_leaf(name)] / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        out[name] = deq.to(grads[name].dtype)
        new_ef[name] = g - deq
    return out, new_ef


def compressed_psum(tree: dict, comm: Comm) -> dict:
    """int8-compressed sum of ``tree`` ({name: tensor}, the same names and
    shapes on every rank) over ``comm``'s group: per tensor, a shared
    scale, int8 codes summed as int32, scaled back to its dtype."""
    out = {}
    for name, g in tree.items():
        g32 = g.float()
        scale = comm.all_reduce((_absmax(g32) / 127.0 + 1e-12).reshape(1),
                                "max")[0]
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        total = comm.all_reduce(q.to(torch.int32))
        out[name] = (total.float() * scale).to(g.dtype)
    return out
