"""Plain PyTorch version of the online-softmax attention kernel: the
reference's ``softmax_attention_ref`` in the kernel layout
``(b, nh, s, d)``, one exact softmax over the materialized score rows,
fp32 math."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cache_layout as CL

NEG_INF = -1e30


def softmax_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale=None):
    """q: (b, nh, sq, d); k, v: (b, nkv, skv, d). Returns (b, nh, sq, d)
    in q.dtype."""
    b, nh, sq, d = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    g = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, nkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    # positions count from 0 for queries and keys: top-left causal
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = CL.kv_mask(qpos, kpos, skv, window, causal=causal)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, nh, sq, d).to(q.dtype)
