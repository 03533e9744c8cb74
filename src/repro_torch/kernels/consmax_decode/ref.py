"""Plain PyTorch versions of the split-KV ConSmax decode kernels: the whole
score row materialized, fp32 math (the reference's ``consmax_decode_ref``,
but reading the cache in its stored ``(b, L, hkv, d)`` layout), and the
paged twin, which gathers each slot's pages (and scale pages) first.

A quantized (int8 / fp8_e4m3) cache is dequantized with
``cache_layout.dequant_block`` to ``q.dtype``, as the kernel and the
reference's CPU path do, before the fp32 math."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cache_layout as CL


def consmax_decode_ref(q, k, v, lengths, beta, gamma, *, window=0,
                       softcap=0.0, merged=True, scale=None, k_scale=None,
                       v_scale=None):
    """q: (b, nh, d); k, v: (b, L, nkv, d); lengths: (b,) valid rows (the
    decode row sits at ``lengths - 1``); beta/gamma: (nh,); k_scale,
    v_scale: (b, L, nkv) fp32 row scales of a quantized cache. Returns
    (b, nh, d) in q.dtype."""
    if k_scale is not None:
        k = CL.dequant_block(k, k_scale, q.dtype)
        v = CL.dequant_block(v, v_scale, q.dtype)
    b, nh, d = q.shape
    L, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, nkv, g, d)
    s = torch.einsum("bhgd,bchd->bhgc", qf, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(L, device=q.device)[None, :]           # (1, L)
    n = lengths.to(torch.int32)[:, None]                        # (b, 1)
    mask = CL.kv_mask(n - 1, kpos, n, window)                   # (b, L)
    p = CL.consmax_weights(s, beta.float().reshape(nkv, g, 1),
                           gamma.float().reshape(nkv, g, 1), merged)
    p = torch.where(mask[:, None, None, :], p, 0.0)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    return o.reshape(b, nh, d).to(q.dtype)


def consmax_decode_paged_ref(q, kp, vp, page_table, lengths, beta, gamma, *,
                             window=0, softcap=0.0, merged=True, scale=None,
                             k_scale=None, v_scale=None):
    """q: (b, nh, d); kp, vp: (P, ps, nkv, d) page pools; page_table:
    (b, npg) int32 (-1 = unmapped); lengths: (b,) valid logical rows;
    k_scale, v_scale: (P, ps, nkv) fp32 scale pools of a quantized pool.
    Gathers each slot's pages (and scale pages) into (b, npg * ps, nkv, d),
    zeros for -1 entries (a zero K and V row adds exactly 0), then runs
    ``consmax_decode_ref``. Returns (b, nh, d) in q.dtype."""
    ks = vs = None
    if k_scale is not None:
        ks = CL.gather_pages(k_scale, page_table)
        vs = CL.gather_pages(v_scale, page_table)
    return consmax_decode_ref(q, CL.gather_pages(kp, page_table),
                              CL.gather_pages(vp, page_table), lengths, beta,
                              gamma, window=window, softcap=softcap,
                              merged=merged, scale=scale, k_scale=ks,
                              v_scale=vs)
