"""Sync-free context-parallel decode (the paper's property, distributed) —
the reference's ``core/context_parallel.py`` over ``torch.distributed``.

With the KV sequence split over the ranks of a ``seq`` group (rank i holds
rows ``[i Lloc, (i+1) Lloc)``), each rank computes a *partial* attention
over its rows, and the combine differs in structure:

  ConSmax : o = sum_ranks(o_partial)                        — 1 collective
  Softmax : m = max_ranks(m_loc); l = sum_ranks(l_loc);
            o = sum_ranks(o_partial) / l                    — 3 collectives,
            and the rescale against the global max (the "partial softmax
            synchronization" the paper puts at ~20 % of attention latency)

Plain tensor functions, as the reference's are plain jnp (no Pallas):
``cp_decode_consmax`` / ``cp_decode_softmax`` take this rank's K/V slice,
and ``make_cp_decode`` binds a group and a normalizer. Their collectives
go through ``distributed/comm.py``, whose counts show the difference.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import consmax as CS
from repro_torch.distributed.comm import Comm

NEG_INF = -1e30


def _scores(q, k, softcap):
    b, _, H, dk = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, H // hkv, dk)
    s = torch.einsum("bhgd,bchd->bhgc", qg.float(), k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s                                       # (b, hkv, g, Lloc)


def _mask(comm: Comm, Lloc: int, index, window: int, device):
    kpos = comm.rank * Lloc + torch.arange(Lloc, device=device)
    msk = kpos[None, :] <= index[:, None]
    if window > 0:
        msk &= (index[:, None] - kpos[None, :]) < window
    return msk                                     # (b, Lloc)


def cp_decode_consmax(q, k, v, index, norm_params, *, comm: Comm,
                      merged=True, softcap=0.0, window=0):
    """q: (b, 1, H, dk) replicated; k, v: this rank's (b, Lloc, hkv, dk)
    rows; index: (b,) positions; norm_params: ConSmax ``beta`` / ``gamma``
    (``core.consmax.ConSmaxParams``). One all-reduce."""
    b, _, H, dk = q.shape
    Lloc, hkv = k.shape[1], k.shape[2]
    msk = _mask(comm, Lloc, index, window, q.device)
    s = _scores(q, k, softcap)
    p = CS.consmax(norm_params.beta, norm_params.gamma,
                   s.reshape(b, H, 1, Lloc), msk[:, None, None, :],
                   head_axis=1, merged=merged)
    p = p.reshape(b, hkv, H // hkv, Lloc).to(q.dtype)
    o_partial = torch.einsum("bhgc,bchd->bhgd", p.float(), v.float())
    o = comm.all_reduce(o_partial)                 # THE one collective
    return o.reshape(b, 1, H, dk).to(q.dtype)


def cp_decode_softmax(q, k, v, index, *, comm: Comm, softcap=0.0, window=0):
    """The baseline: local (m, l, o), then a global max and two sums."""
    b, _, H, dk = q.shape
    Lloc, hkv = k.shape[1], k.shape[2]
    msk = _mask(comm, Lloc, index, window, q.device)[:, None, None, :]
    s = torch.where(msk, _scores(q, k, softcap), NEG_INF)
    m = comm.all_reduce(s.amax(dim=-1), "max")                 # sync 1
    e = torch.where(msk, torch.exp(s - m[..., None]), 0.0)
    l = comm.all_reduce(e.sum(dim=-1))                         # sync 2
    o_partial = torch.einsum("bhgc,bchd->bhgd", e.to(q.dtype).float(),
                             v.float())
    o = comm.all_reduce(o_partial)                             # sync 3
    o = o / l.clamp(min=1e-30)[..., None]
    return o.reshape(b, 1, H, dk).to(q.dtype)


def make_cp_decode(comm: Comm, norm_kind: str, norm_params=None, *,
                   softcap=0.0, window=0, merged=True):
    """``fn(q, k, v, index)`` over the ``seq`` group of ``comm``, k / v this
    rank's rows of the KV cache, the output replicated on every rank."""
    if norm_kind == "consmax":
        return partial(cp_decode_consmax, norm_params=norm_params,
                       comm=comm, merged=merged, softcap=softcap,
                       window=window)
    if norm_kind != "softmax":
        raise ValueError(f"context-parallel decode: norm_kind "
                         f"{norm_kind!r} (consmax or softmax)")
    return partial(cp_decode_softmax, comm=comm, softcap=softcap,
                   window=window)
