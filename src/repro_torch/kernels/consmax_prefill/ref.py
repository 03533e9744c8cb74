"""Plain PyTorch versions of the ConSmax append-prefill kernels: the whole
(c, L) score matrix per head materialized, fp32 math (the reference's
``consmax_prefill_ref``), and the paged twin, which gathers each slot's
pages (and scale pages) first.

A quantized (int8 / fp8_e4m3) cache is dequantized with
``cache_layout.dequant_block`` to ``q.dtype``, as the kernel and the
reference's CPU path do, before the fp32 math."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cache_layout as CL


def consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, *,
                        window: int = 0, softcap: float = 0.0,
                        merged: bool = True, scale: float | None = None,
                        k_scale=None, v_scale=None, slot=None):
    """q: (b, c, H, dk) chunk at per-slot positions index + [0, c);
    k, v: (b, L, hkv, dk) caches after the chunk's K/V were written;
    index, lengths: (b,); k_scale, v_scale: (b, L, hkv) fp32 row scales of
    a quantized cache. ``slot`` (b,) int: the caches are a (B, L, ...) slot
    pool and row i reads slot ``slot[i]`` (gathered first). Returns
    (b, c, H, dk) fp32; rows >= lengths are pad rows the caller
    discards."""
    if slot is not None:
        sel = slot.long()
        k, v = k.index_select(0, sel), v.index_select(0, sel)
        if k_scale is not None:
            k_scale = k_scale.index_select(0, sel)
            v_scale = v_scale.index_select(0, sel)
    if k_scale is not None:
        k = CL.dequant_block(k, k_scale, q.dtype)
        v = CL.dequant_block(v, v_scale, q.dtype)
    b, c, H, dk = q.shape
    L, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    qg = q.float().reshape(b, c, hkv, g, dk)
    s = torch.einsum("bqhgd,bchd->bhgqc", qg, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = index[:, None] + torch.arange(c, device=q.device)   # (b, c)
    kpos = torch.arange(L, device=q.device)
    mask = CL.kv_mask(qpos[:, :, None], kpos[None, None, :],
                      (index + lengths)[:, None, None], window)  # (b, c, L)
    p = CL.consmax_weights(s, beta.float().reshape(1, hkv, g, 1, 1),
                           gamma.float().reshape(1, hkv, g, 1, 1), merged)
    p = torch.where(mask[:, None, None], p, 0.0)
    out = torch.einsum("bhgqc,bchd->bqhgd", p, v.float())
    return out.reshape(b, c, H, dk)


def consmax_prefill_paged_ref(q, kp, vp, page_table, index, lengths, beta,
                              gamma, *, window: int = 0, softcap: float = 0.0,
                              merged: bool = True,
                              scale: float | None = None, k_scale=None,
                              v_scale=None):
    """q: (b, c, H, dk); kp, vp: (P, ps, hkv, dk) page pools after the
    chunk's K/V were written; page_table: (b, npg) int32 (-1 = unmapped);
    index, lengths: (b,); k_scale, v_scale: (P, ps, hkv) fp32 scale pools
    of a quantized pool. Gathers each slot's pages (and scale pages) into
    (b, npg * ps, hkv, dk), zeros for -1 entries, then runs
    ``consmax_prefill_ref``. Returns (b, c, H, dk) fp32."""
    ks = vs = None
    if k_scale is not None:
        ks = CL.gather_pages(k_scale, page_table)
        vs = CL.gather_pages(v_scale, page_table)
    return consmax_prefill_ref(q, CL.gather_pages(kp, page_table),
                               CL.gather_pages(vp, page_table), index,
                               lengths, beta, gamma, window=window,
                               softcap=softcap, merged=merged, scale=scale,
                               k_scale=ks, v_scale=vs)
