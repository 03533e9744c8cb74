"""Mamba-1 selective SSM block (jamba's mamba layers) — the reference's
``models/mamba.py``.

Training and prefill scan in chunks of ``cfg.mamba.chunk`` steps: the
discretized ``(b, Lc, d_inner, N)`` tensors exist one chunk at a time (and
are recomputed in backward, as the reference checkpoints each chunk), and
the carry between chunks is the ``(b, d_inner, N)`` fp32 state. Within a
chunk the recurrence ``h_t = dA_t · h_{t-1} + dBx_t`` runs as a log-depth
(Hillis-Steele) scan of the pairs ``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 +
b2)`` in fp32; XLA's ``associative_scan`` uses another tree, so the two
agree to rounding, not to the bit. Decode is the exact one-step recurrence
with a rolling ``(b, K - 1, d_inner)`` conv state.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import layers as L


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """The reference's ``mamba_init`` tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        mc = cfg.mamba
        d, di = cfg.d_model, mc.expand * cfg.d_model
        N, K, R = mc.d_state, mc.d_conv, dt_rank(cfg)
        self.in_proj = L.param(d, 2 * di, axes="embed,mlp", device=device)
        self.conv_w = L.param(K, di, axes="conv,mlp", device=device)
        self.conv_b = L.param(di, axes="mlp", device=device)
        self.x_proj = L.param(di, R + 2 * N, axes="mlp,", device=device)
        self.dt_proj = L.param(R, di, axes=",mlp", device=device)
        self.dt_bias = L.param(di, axes="mlp", fp32=True, device=device)
        self.A_log = L.param(di, N, axes="mlp,state", fp32=True,
                             device=device)
        self.D = L.param(di, axes="mlp", fp32=True, device=device)
        self.out_proj = L.param(di, d, axes="mlp,embed", device=device)

    def reset_parameters(self, generator: torch.Generator):
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            L.fan_in_normal_(w, generator)
        L.normal_(self.conv_w, 1.0 / math.sqrt(self.conv_w.shape[0]),
                  generator)
        N = self.A_log.shape[1]
        with torch.no_grad():
            self.conv_b.zero_()
            self.dt_bias.fill_(-4.6)                 # softplus ~ 0.01
            self.A_log.copy_(torch.log(torch.arange(
                1, N + 1, dtype=torch.float32)).expand_as(self.A_log))
            self.D.fill_(1.0)


def causal_conv(xm, w, b):
    """Depthwise causal conv as K shifted adds, in the reference's order.
    xm: (b, s, di); w: (K, di)."""
    K, s = w.shape[0], xm.shape[1]
    pad = F.pad(xm, (0, 0, K - 1, 0))
    y = pad[:, 0:s] * w[0]
    for j in range(1, K):
        y = y + pad[:, j:j + s] * w[j]
    return y + b


def linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t · h_{t-1} + b_t`` from h = 0 along
    axis 1, in log2(L) doubling steps. Returns (prod a, h) per step."""
    n = a.shape[1]
    shift = 1
    while shift < n:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return a, b


def _ssm_chunk(h0, xc, delta, B, C, A):
    """One chunk. h0: (b, di, N) fp32; xc, delta: (b, Lc, di); B, C:
    (b, Lc, N). Returns (h at the chunk's end, y (b, Lc, di))."""
    dA = torch.exp(delta[..., None] * A)                     # (b,Lc,di,N)
    dBx = (delta * xc)[..., None] * B[:, :, None, :]
    Acum, Bcum = linear_scan(dA, dBx)
    h = Acum * h0[:, None] + Bcum
    y = torch.einsum("blin,bln->bli", h, C)
    return h[:, -1], y


def conv_tail(xm, K: int):
    """The last K - 1 rows of xm (front-padded with zeros): the decode conv
    state after a prefill."""
    tail = xm[:, max(0, xm.shape[1] - (K - 1)):]
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def mamba_apply(p: Mamba, x, cfg: ModelConfig, *, cache=None):
    """x: (b, s, d) -> (y, new_cache). ``cache`` None: the whole-sequence
    scan; with a cache and s > 1: a whole-prompt prefill (s a chunk
    multiple, or below one chunk) that returns the conv tail and the final
    state; with s == 1: one decode step."""
    mc = cfg.mamba
    b, s, _ = x.shape
    N, K, R = mc.d_state, mc.d_conv, dt_rank(cfg)
    cdt = cfg.cdtype()

    xm, z = (x.to(cdt) @ L.cast(p.in_proj, cdt)).chunk(2, dim=-1)
    A = -torch.exp(p.A_log.float())                          # (di, N)
    conv_w, conv_b = L.cast(p.conv_w, cdt), L.cast(p.conv_b, cdt)

    prefill = cache is not None and s > 1
    if cache is None or prefill:
        if prefill and s % mc.chunk and s > mc.chunk:
            raise ValueError(f"mamba prefill length {s} must be a multiple "
                             f"of the chunk ({mc.chunk}) or below it")
        xc = F.silu(causal_conv(xm, conv_w, conv_b))
        dr, B, C = (xc @ L.cast(p.x_proj, cdt)).split([R, N, N], dim=-1)
        delta = F.softplus((dr @ L.cast(p.dt_proj, cdt)).float()
                           + p.dt_bias)                      # (b,s,di) fp32
        xc32, B32, C32 = xc.float(), B.float(), C.float()

        Lc = min(mc.chunk, s)
        n_chunks = -(-s // Lc)
        pad = n_chunks * Lc - s
        seqs = [F.pad(t, (0, 0, 0, pad)) for t in (xc32, delta, B32, C32)]
        step = (functools.partial(ckpt.checkpoint, _ssm_chunk,
                                  use_reentrant=False)
                if torch.is_grad_enabled() else _ssm_chunk)
        h = torch.zeros((b, xm.shape[-1], N), dtype=torch.float32,
                        device=x.device)
        ys = []
        for i in range(n_chunks):
            h, y = step(h, *(t[:, i * Lc:(i + 1) * Lc] for t in seqs), A)
            ys.append(y)
        y = torch.cat(ys, dim=1)[:, :s] + p.D * xc32
        new_cache = {"conv": conv_tail(xm, K), "h": h} if prefill else None
    else:
        window = torch.cat([cache["conv"], xm], dim=1)       # (b, K, di)
        xc1 = F.silu(torch.einsum("bki,ki->bi", window.to(cdt), conv_w)
                     + conv_b)
        dr, B, C = (xc1 @ L.cast(p.x_proj, cdt)).split([R, N, N], dim=-1)
        delta = F.softplus((dr @ L.cast(p.dt_proj, cdt)).float()
                           + p.dt_bias)
        dA = torch.exp(delta[..., None] * A)
        dBx = (delta * xc1.float())[..., None] * B.float()[:, None, :]
        h = dA * cache["h"] + dBx
        y1 = torch.einsum("bin,bn->bi", h, C.float()) + p.D * xc1.float()
        y = y1[:, None]
        new_cache = {"conv": window[:, 1:], "h": h}

    y = (y.to(cdt) * F.silu(z)) @ L.cast(p.out_proj, cdt)
    return y, new_cache


def mamba_cache_init(cfg: ModelConfig, batch: int, *, device=None):
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=cfg.cdtype(),
                            device=device),
        "h": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                         device=device),
    }
