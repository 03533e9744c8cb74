"""Plain fp32 reference of the dense decoder family, with ConSmax attention.

The published description of a pre-norm decoder (Qwen2 / Phi-3): token
embedding; per layer RMSNorm, q/k/v projections (optional biases), rotary
embeddings (half-split pairs, base ``rope_theta``), causal attention, the
output projection and a residual; RMSNorm, a SiLU-gated MLP and a residual;
a final RMSNorm and the LM head (the tied embedding table). Two departures
from those models, both the served configuration's: attention weights are
ConSmax, ``exp(s - beta_h) / gamma_h`` with no max and no denominator (the
paper's Eq. 2), in place of softmax; RMSNorm gains are stored zero-centred
(gain ``1 + scale``).

Everything is float32 with TF32 off, one layer's weights at a time (drawn
again from the seed by ``perfbench.weights``), every sequence whole: no
cache, no kernel, no batching. Nothing of the port is imported."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights as W

Q_BLOCK = 256        # query rows per attention block
LOGIT_ROWS = 1024    # positions per block of the LM head
FP8_MAX = 448.0      # largest float8_e4m3fn


def _fp8(t, dim):
    """``t`` rounded to float8_e4m3fn with one absmax scale per slice along
    ``dim`` (the contraction dimension), back in float32."""
    scale = FP8_MAX / t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(a, b, fp8):
    """a (..., k) @ b (k, n); with ``fp8`` both operands rounded to fp8
    first (per row of a, per column of b), the products summed in fp32."""
    if fp8:
        a, b = _fp8(a, -1), _fp8(b, 0)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def _rope(x, theta):
    """x (n, heads, dk) at positions 0 .. n-1; angles in float64."""
    n, _, dk = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dk, 2, dtype=torch.float64,
                                       device=x.device) / dk)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :dk // 2], x[..., dk // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, beta, gamma, fp8=False):
    """Causal ConSmax attention; q (n, H, dk), k / v (n, hkv, dk)."""
    n, H, dk = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    if fp8:
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, 0)
    out = torch.empty_like(q)
    b, c = beta[:, None, None], gamma[:, None, None]
    for i0 in range(0, n, Q_BLOCK):
        i1 = min(n, i0 + Q_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[i0:i1], k[:i1]) / math.sqrt(dk)
        keep = (torch.arange(i1, device=q.device)[None, :]
                <= torch.arange(i0, i1, device=q.device)[:, None])
        p = torch.where(keep, torch.exp(s - b) / c, 0.0)
        if fp8:
            p = _fp8(p, -1)
        out[i0:i1] = torch.einsum("hqk,khd->qhd", p, v[:i1])
    return out


def _layer(h, w, p, m, fp8=False):
    n = h.shape[0]
    a = _rms(h, w[p + "attn_norm.scale"], m["eps"])

    def proj(name, heads):
        y = _mm(a, w[p + f"attn.{name}.w"].reshape(m["d"], heads * m["dk"]),
                fp8)
        y = y.view(n, heads, m["dk"])
        bias = w.get(p + f"attn.{name}.b")
        return y if bias is None else y + bias

    q = _rope(proj("q", m["H"]), m["theta"])
    k = _rope(proj("k", m["hkv"]), m["theta"])
    v = proj("v", m["hkv"])
    o = _attention(q, k, v, w[p + "attn.score_norm.beta"],
                   w[p + "attn.score_norm.gamma"], fp8)
    h = h + _mm(o.reshape(n, -1), w[p + "attn.o.w"].reshape(-1, m["d"]), fp8)
    a = _rms(h, w[p + "mlp_norm.scale"], m["eps"])
    g = F.silu(_mm(a, w[p + "mlp.gate.w"], fp8)) * _mm(a, w[p + "mlp.up.w"],
                                                       fp8)
    return h + _mm(g, w[p + "mlp.down.w"], fp8)


def _widened(group: dict) -> dict:
    return {k: t.float() for k, t in group.items()}


class _NoTF32:
    """float32 products stay float32: TF32 off while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _final_states(cfg, seed, toks, device, fp8=False):
    """(LM-head table, normed final hidden states of each sequence)."""
    m = W.dims(cfg)
    table = _widened(W.make(cfg, seed, "embed", device))["embed.table"]
    hs = [table[t] for t in toks]
    for i in range(m["layers"]):
        w = _widened(W.make(cfg, seed, f"layer{i}", device))
        hs = [_layer(h, w, f"blocks.{i}.b0.", m, fp8) for h in hs]
        del w
    final = _widened(W.make(cfg, seed, "final", device))["final_norm.scale"]
    return table, [_rms(h, final, m["eps"]) for h in hs]


@torch.no_grad()
def logits(cfg: dict, seed: int, tokens, device) -> torch.Tensor:
    """(n, vocab) float32 logits of one sequence at every position."""
    with _NoTF32():
        t = torch.tensor(tokens, dtype=torch.long, device=device)
        table, (x,) = _final_states(cfg, seed, [t], device)
        return x @ table.T


@torch.no_grad()
def logit_gaps(cfg: dict, seed: int, seqs, device, *,
               chooser: str | None = None) -> list[np.ndarray]:
    """For each ``(tokens, n_prompt)`` in ``seqs``: at every served position
    (the tokens after the prompt) the gap by which the served token's logit
    lies below the best logit, in the reference's float32 logits.

    ``chooser="fp8"``: the output check's control. At each of those
    positions the token is the one this reference puts first when every
    product runs on fp8 operands (weights, activations, scores and
    attention weights rounded to float8_e4m3fn, one scale per row or
    column), in the program's place; its gap is read as above."""
    with _NoTF32():
        toks = [torch.tensor(t, dtype=torch.long, device=device)
                for t, _ in seqs]
        ins = [t[:-1] for t in toks]
        table, xs = _final_states(cfg, seed, ins, device)
        xs8 = (_final_states(cfg, seed, ins, device, fp8=True)[1]
               if chooser == "fp8" else [None] * len(xs))
        if chooser not in (None, "fp8"):
            raise ValueError(f"unknown chooser {chooser!r}")
        gaps = []
        for x, x8, t, (_, n_prompt) in zip(xs, xs8, toks, seqs):
            rows = torch.arange(n_prompt - 1, len(t) - 1, device=device)
            out = []
            for r0 in range(0, len(rows), LOGIT_ROWS):
                r = rows[r0:r0 + LOGIT_ROWS]
                z = x[r] @ table.T
                pick = (t[r + 1] if x8 is None
                        else _mm(x8[r], table.T, True).argmax(-1))
                chosen = z.gather(1, pick[:, None])[:, 0]
                out.append(z.max(-1).values - chosen)
            gaps.append(torch.cat(out).cpu().numpy())
        return gaps
