"""Plain PyTorch version of the full-sequence ConSmax attention kernel: the
reference's ``consmax_attention_ref`` in the kernel layout
``(b, nh, s, d)``, the whole score matrix materialized, fp32 math."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cache_layout as CL


def consmax_attention_ref(q, k, v, beta, gamma, *, causal=True, window=0,
                          softcap=0.0, merged=False, scale=None):
    """q: (b, nh, sq, d); k, v: (b, nkv, skv, d); beta/gamma: (nh,).
    Returns (b, nh, sq, d) in q.dtype."""
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
    p = CL.consmax_weights(s, beta.float().reshape(nkv, g, 1, 1),
                           gamma.float().reshape(nkv, g, 1, 1), merged)
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, nh, sq, d).to(q.dtype)
