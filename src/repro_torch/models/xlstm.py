"""xLSTM cells — the reference's ``models/xlstm.py``: the chunkwise-parallel
mLSTM (matrix memory, exponential gating) and the step-recurrent sLSTM
(scalar memory, hidden-to-hidden recurrence).

mLSTM's exponential gating carries a running-max stabilizer ``m_t``, the
analogue of softmax's max subtraction (``stabilizer="max"``, the published
cell). ``stabilizer="consmax"`` replaces ``m_t`` with a learned per-head
constant ``mu`` and the ``max(|q·n|, exp(-m))`` denominator with a learned
per-head ``gamma`` — ConSmax's idea applied to the recurrent family.

Whole sequences run through ``nn/scan.scan``, as the reference scans
them: the mLSTM one chunk (``cfg.xlstm.chunk`` steps) per scan step, each
recomputed in backward as the reference checkpoints it, and the sLSTM one
step at a time, recomputed in backward ``cfg.xlstm.chunk`` steps at a
time; a cache turns a multi-token call into a
whole-prompt prefill (its length a chunk multiple or below one chunk) that
returns the final state, and a one-token call into one decode step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.mamba import causal_conv, conv_tail
from repro_torch.nn import layers as L
from repro_torch.nn.scan import scan

NEG = -1e30


def inner_dim(cfg: ModelConfig) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def _check_prefill(s: int, chunk: int):
    if s % chunk and s > chunk:
        raise ValueError(f"xLSTM prefill length {s} must be a multiple of "
                         f"the chunk ({chunk}) or below it")


def _head_rms(hs, scale):
    """Per-head RMS norm in fp32 times ``out_scale`` (h, dh)."""
    hf = hs.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)
    return hf * torch.rsqrt(var + 1e-6) * scale


# ================================================================= mLSTM ====
class MLSTM(nn.Module):
    """The reference's ``mlstm_init`` tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, h, di = cfg.d_model, cfg.n_heads, inner_dim(cfg)
        dk, K = di // h, cfg.xlstm.d_conv
        self.up = L.param(d, 2 * di, axes="embed,mlp", device=device)
        self.conv_w = L.param(K, di, axes="conv,mlp", device=device)
        self.conv_b = L.param(di, axes="mlp", device=device)
        self.wq = L.param(di, h, dk, axes="mlp,heads,", device=device)
        self.wk = L.param(di, h, dk, axes="mlp,heads,", device=device)
        self.wv = L.param(di, h, dk, axes="mlp,heads,", device=device)
        self.w_ig = L.param(di, h, axes="mlp,heads", fp32=True, device=device)
        self.b_ig = L.param(h, axes="heads", fp32=True, device=device)
        self.w_fg = L.param(di, h, axes="mlp,heads", fp32=True, device=device)
        self.b_fg = L.param(h, axes="heads", fp32=True, device=device)
        self.out_scale = L.param(h, dk, axes="heads,", fp32=True,
                                 device=device)
        self.down = L.param(di, d, axes="mlp,embed", device=device)
        if cfg.xlstm.stabilizer == "consmax":
            self.mu = L.param(h, axes="heads", fp32=True, device=device)
            self.gamma = L.param(h, axes="heads", fp32=True, device=device)

    def reset_parameters(self, generator: torch.Generator):
        for w in (self.up, self.wq, self.wk, self.wv, self.w_ig, self.w_fg,
                  self.down):
            L.fan_in_normal_(w, generator)
        L.normal_(self.conv_w, 1.0 / math.sqrt(self.conv_w.shape[0]),
                  generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.b_ig.fill_(-10.0)
            self.b_fg.fill_(5.0)
            self.out_scale.fill_(1.0)
            if hasattr(self, "mu"):
                self.mu.fill_(1.0)
                self.gamma.fill_(1.0)


def _mlstm_chunk(C_prev, n_prev, m_prev, q, k, v, ig, logf, mu, gamma, *,
                 consmax: bool):
    """One chunk. Carry C (b,h,dk,dv), n (b,h,dk), m (b,h) fp32; q, k, v
    (b,Lc,h,*) fp32; ig, logf (b,Lc,h) fp32. Returns the carry at the
    chunk's end and the chunk's output (b, Lc, h, dv)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (b,h,L,*)
    ig, logf = ig.transpose(1, 2), logf.transpose(1, 2)     # (b,h,L)
    Lc = q.shape[2]

    A = torch.cumsum(logf, dim=-1)                           # inclusive
    W = A[..., :, None] - A[..., None, :] + ig[..., None, :]
    mask = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    W = torch.where(mask, W, NEG)

    m_inter = A + m_prev[..., None]                          # (b,h,L)
    if consmax:
        m_t = mu[None, :, None].expand_as(m_inter)
    else:
        m_t = torch.maximum(m_inter, W.amax(dim=-1))
    c_inter = torch.exp(m_inter - m_t)
    P = torch.where(mask, torch.exp(W - m_t[..., None]), 0.0)
    PS = P * torch.einsum("bhld,bhjd->bhlj", q, k)
    num = (c_inter[..., None] * torch.einsum("bhld,bhdv->bhlv", q, C_prev)
           + torch.einsum("bhlj,bhjv->bhlv", PS, v))
    if consmax:
        den = gamma[None, :, None]
    else:
        qn = (c_inter * torch.einsum("bhld,bhd->bhl", q, n_prev)
              + PS.sum(dim=-1))
        den = torch.maximum(qn.abs(), torch.exp(-m_t))
    h_out = num / den[..., None]                             # (b,h,L,dv)

    # state update to the chunk's end
    AL = A[..., -1]                                          # (b,h)
    upd_log = AL[..., None] - A + ig                         # (b,h,L)
    if consmax:
        m_next = mu[None, :] + torch.zeros_like(m_prev)
    else:
        m_next = torch.maximum(AL + m_prev, upd_log.amax(dim=-1))
    w_upd = torch.exp(upd_log - m_next[..., None])
    decay = torch.exp(AL + m_prev - m_next)
    C_next = (decay[..., None, None] * C_prev
              + torch.einsum("bhl,bhld,bhlv->bhdv", w_upd, k, v))
    n_next = decay[..., None] * n_prev + torch.einsum("bhl,bhld->bhd",
                                                      w_upd, k)
    return C_next, n_next, m_next, h_out.transpose(1, 2)


def mlstm_apply(p: MLSTM, x, cfg: ModelConfig, *, cache=None):
    """x: (b, s, d) -> (y, new_cache)."""
    xcfg = cfg.xlstm
    b, s, _ = x.shape
    h, di = cfg.n_heads, inner_dim(cfg)
    dk = di // h
    cdt = cfg.cdtype()
    consmax = xcfg.stabilizer == "consmax"
    mu, gamma = getattr(p, "mu", None), getattr(p, "gamma", None)

    xm, z = (x.to(cdt) @ L.cast(p.up, cdt)).chunk(2, dim=-1)
    conv_w, conv_b = L.cast(p.conv_w, cdt), L.cast(p.conv_b, cdt)

    def heads(t, w):                         # (..., di) @ (di, h, dk)
        return (t @ L.cast(w, cdt).reshape(di, h * dk)).unflatten(-1, (h, dk))

    prefill = cache is not None and s > 1
    if cache is None or prefill:
        if prefill:
            _check_prefill(s, xcfg.chunk)
        xcv = F.silu(causal_conv(xm, conv_w, conv_b))
        q = heads(xcv, p.wq)
        k = heads(xcv, p.wk) / math.sqrt(dk)
        v = heads(xm, p.wv)
        ig = xcv.float() @ p.w_ig + p.b_ig                   # (b, s, h)
        logf = F.logsigmoid(xcv.float() @ p.w_fg + p.b_fg)

        Lc = min(xcfg.chunk, s)
        n_chunks = -(-s // Lc)
        pad = n_chunks * Lc - s
        # under a mesh the walk's chunks stay whole along time
        seqs = [F.pad(shard(t.float(), axes), (0, 0) * (t.ndim - 2)
                      + (0, pad)).unflatten(1, (n_chunks, Lc))
                for t, axes in zip((q, k, v, ig, logf), 3 * (
                    "act_batch,act_seq,act_heads,",) + 2 * (
                    "act_batch,act_seq,act_heads",))]

        def step(carry, xt, *mg):
            *carry, o = _mlstm_chunk(*carry, *xt, *(mg or (mu, gamma)),
                                     consmax=consmax)
            return tuple(carry), o

        C = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, dk), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, h), dtype=torch.float32, device=x.device)
        # one scan step per chunk, each recomputed in backward
        (C, n, m), hout = scan(step, (C, n, m), seqs, chunk=1,
                               params=(mu, gamma) if consmax else ())
        hout = hout.flatten(1, 2)[:, :s]
        new_cache = None
        if prefill:
            new_cache = {"conv": conv_tail(xm, xcfg.d_conv), "C": C,
                         "n": n, "m": m}
    else:
        window = torch.cat([cache["conv"], xm], dim=1)       # (b, K, di)
        xc1 = F.silu(torch.einsum("bki,ki->bi", window.to(cdt), conv_w)
                     + conv_b)
        q = heads(xc1, p.wq).float()
        k = (heads(xc1, p.wk) / math.sqrt(dk)).float()
        v = heads(xm[:, 0], p.wv).float()
        ig = xc1.float() @ p.w_ig + p.b_ig                   # (b, h)
        logf = F.logsigmoid(xc1.float() @ p.w_fg + p.b_fg)
        C_prev, n_prev, m_prev = cache["C"], cache["n"], cache["m"]
        if consmax:
            m_new = mu[None, :] + torch.zeros_like(m_prev)
        else:
            m_new = torch.maximum(logf + m_prev, ig)
        fp = torch.exp(logf + m_prev - m_new)
        ip = torch.exp(ig - m_new)
        C = (fp[..., None, None] * C_prev
             + ip[..., None, None] * torch.einsum("bhd,bhv->bhdv", k, v))
        n = fp[..., None] * n_prev + ip[..., None] * k
        if consmax:
            den = gamma[None, :]
        else:
            qn = torch.einsum("bhd,bhd->bh", q, n)
            den = torch.maximum(qn.abs(), torch.exp(-m_new))
        hout = (torch.einsum("bhd,bhdv->bhv", q, C) / den[..., None])[:, None]
        new_cache = {"conv": window[:, 1:], "C": C, "n": n, "m": m_new}

    y = _head_rms(hout, p.out_scale).flatten(-2).to(cdt)
    y = (y * F.silu(z)) @ L.cast(p.down, cdt)
    return y, new_cache


def mlstm_cache_init(cfg: ModelConfig, batch: int, *, device=None):
    h, di = cfg.n_heads, inner_dim(cfg)
    dk = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.d_conv - 1, di),
                            dtype=cfg.cdtype(), device=device),
        "C": torch.zeros((batch, h, dk, dk), **f32),
        "n": torch.zeros((batch, h, dk), **f32),
        "m": torch.zeros((batch, h), **f32),
    }


# ================================================================= sLSTM ====
class SLSTM(nn.Module):
    """The reference's ``slstm_init`` tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        self.w = L.param(d, 4, d, axes="embed,,mlp", device=device)
        self.r = L.param(4, h, dh, dh, axes=",heads,,", device=device)
        self.b = L.param(4, d, axes=",mlp", fp32=True, device=device)
        self.out_scale = L.param(h, dh, axes="heads,", fp32=True,
                                 device=device)
        if cfg.xlstm.stabilizer == "consmax":
            self.mu = L.param(h, axes="heads", fp32=True, device=device)

    def reset_parameters(self, generator: torch.Generator):
        L.fan_in_normal_(self.w, generator)
        L.fan_in_normal_(self.r, generator, axis=2)
        with torch.no_grad():
            self.b.zero_()
            self.out_scale.fill_(1.0)
            if hasattr(self, "mu"):
                self.mu.fill_(1.0)


def _slstm_step(carry, gx, r, mu):
    """carry: (h, c, n, m) each (b, d) fp32; gx: (b, 4, d) fp32 gate inputs;
    r: (4, h, dh, dh) fp32. Returns the new carry (its h is the output)."""
    hst, c, n, m = carry
    b = hst.shape[0]
    nh, dh = r.shape[1], r.shape[2]
    gr = torch.einsum("bhk,ghkj->bghj", hst.reshape(b, nh, dh), r)
    g = gx + gr.reshape(b, 4, nh * dh)
    it, ft, zt, ot = g.unbind(1)
    if mu is not None:
        m_new = mu[None, :, None].expand(b, nh, dh).reshape(b, -1)
    else:
        m_new = torch.maximum(ft.reshape(b, nh, dh) + m.reshape(b, nh, dh),
                              it.reshape(b, nh, dh)).reshape(b, -1)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * torch.tanh(zt)
    n = fp * n + ip
    hst = torch.sigmoid(ot) * c / n.abs().clamp(min=1e-6)
    return hst, c, n, m_new


def slstm_apply(p: SLSTM, x, cfg: ModelConfig, *, cache=None):
    """x: (b, s, d) -> (y, new_cache). Runs the recurrence one step at a
    time through ``nn/scan.scan``, recomputed in backward chunk by chunk
    (``cfg.xlstm.chunk`` steps), as the reference scans it."""
    b, s, d = x.shape
    h = cfg.n_heads
    cdt = cfg.cdtype()
    r = p.r.float()
    mu = getattr(p, "mu", None) if cfg.xlstm.stabilizer == "consmax" else None
    w = L.cast(p.w, cdt)
    if isinstance(w, DTensor):
        # under a mesh, one product per gate: the (d, 4, d) weight's
        # merged view would split its sharded last dim, and the product's
        # gate dimension must stay whole for the step's unbind
        gx = torch.stack([x.to(cdt) @ w[:, i] for i in range(4)], dim=2)
    else:
        gx = (x.to(cdt) @ w.reshape(d, 4 * d)).unflatten(-1, (4, d))
    gx = gx.float() + p.b                                    # (b, s, 4, d)

    if cache is None or s > 1:
        if cache is not None:
            _check_prefill(s, cfg.xlstm.chunk)
        zero = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero, zero)
    else:
        carry = (cache["h"], cache["c"], cache["n"], cache["m"])

    def step(carry, xt, r, *mu):
        carry = _slstm_step(carry, xt[0], r, mu[0] if mu else None)
        return carry, carry[0]

    carry, hs = scan(step, carry, (gx,), chunk=cfg.xlstm.chunk,
                     params=(r,) if mu is None else (r, mu))  # (b, s, d)
    new_cache = None
    if cache is not None:
        new_cache = dict(zip(("h", "c", "n", "m"), carry))
    y = _head_rms(hs.unflatten(-1, (h, d // h)), p.out_scale)
    return y.flatten(-2).to(cdt), new_cache


def slstm_cache_init(cfg: ModelConfig, batch: int, *, device=None):
    return {key: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device) for key in ("h", "c", "n", "m")}
