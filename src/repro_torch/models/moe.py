"""Top-k MoE with sort-based capacity dispatch — the reference's
``models/moe.py``.

Every token passes through exactly its top-k experts (up to each expert's
capacity ``C``): a stable sort of the ``s·k`` (token, expert) slots of each
sequence row by expert, the rank of each slot within its expert from a
cumulative one-hot, a scatter into ``(E, C, d)`` buffers (slots ranked at or
past ``C`` go to one drop row past the ``E·C`` rows, the reference's
``mode="drop"``), the batched expert GLU, and a gather back through the
inverse permutation. The reference vmaps the dispatch over the batch; here
all rows go at once, each row's buffers at its own offset, with no shape
that depends on the data (no ``nonzero``, no host read), so the serving
steps keep one signature.

Router normalizer: ``"softmax"`` (the top-k weights renormalized to sum 1)
or ``"consmax"`` (``exp(logits - beta) / gamma``, learnable scalars; the
top-k selection is unchanged by the monotone map and the weights are kept
as they are). The Switch load-balance aux loss is always taken on the
normalized probabilities, with the one-hot of each token's top-1 expert.

The expert products are ``torch.bmm`` over all rows (the reference computes
them as plain einsums outside any Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.nn import layers as L


class MoE(nn.Module):
    """fp32 router ``(d, E)``, experts ``gate`` / ``up`` ``(E, d, ff)`` and
    ``down`` ``(E, ff, d)``, and scalar ``beta`` / ``gamma`` for a consmax
    router — the reference's ``moe_init`` tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        m = cfg.moe
        d, ff, E = cfg.d_model, m.d_ff_expert or cfg.d_ff, m.n_experts
        self.router = L.param(d, E, axes="embed,experts", fp32=True,
                              device=device)
        self.gate = L.param(E, d, ff, axes="experts,embed,mlp", device=device)
        self.up = L.param(E, d, ff, axes="experts,embed,mlp", device=device)
        self.down = L.param(E, ff, d, axes="experts,mlp,embed", device=device)
        if m.router_norm == "consmax":
            self.beta = L.param(axes="", fp32=True, device=device)
            self.gamma = L.param(axes="", fp32=True, device=device)

    def reset_parameters(self, generator: torch.Generator):
        L.fan_in_normal_(self.router, generator)
        for w in (self.gate, self.up, self.down):
            L.fan_in_normal_(w, generator, axis=1)
        if hasattr(self, "beta"):
            with torch.no_grad():
                self.beta.zero_()
                self.gamma.fill_(float(self.router.shape[1]))


def capacity(s: int, k: int, E: int, cf: float) -> int:
    """Slots per expert for an ``s``-token row: ``s·k·cf / E`` rounded up
    to a multiple of 8, at least 8 and at most ``s·k`` (the reference's
    ``_capacity``)."""
    c = int(s * k * cf / E)
    c = max(8, -(-c // 8) * 8)
    return min(c, s * k)


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, x, cfg: ModelConfig):
    """Router logits (fp32) -> (top-k weights, top-k experts, aux loss) for
    x: (b, s, d)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    logits = x.float() @ p.router                            # (b, s, E)
    if m.router_norm == "consmax":
        probs = torch.exp(logits - p.beta) / p.gamma
        w, idx = top_k(probs, k)                # non-unit weights kept
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = top_k(probs, k)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    probs_n = probs / probs.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs_n.mean(dim=(0, 1))                            # (E,)
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = m.aux_loss_weight * E * (me * ce).sum()
    return w, idx, aux


def dispatch(p: MoE, x, idx, w, cfg: ModelConfig, C: int):
    """x: (b, s, d); idx, w: (b, s, k). The reference's ``_dispatch_row``
    for every row at once."""
    b, s, d = x.shape
    k = idx.shape[-1]
    E = cfg.moe.n_experts
    cdt = cfg.cdtype()
    act = (F.silu if cfg.mlp == "silu_glu"
           else lambda t: F.gelu(t, approximate="tanh"))
    rows = torch.arange(b, device=x.device)[:, None]

    slot_e = idx.reshape(b, s * k)                           # expert of slot
    order = torch.argsort(slot_e, dim=1, stable=True)
    se = slot_e.gather(1, order)
    tok = order // k                                         # slot -> token
    oh = F.one_hot(se, E).to(torch.int32)                    # (b, s*k, E)
    pos = (oh.cumsum(dim=1) - 1).gather(2, se[..., None])[..., 0]
    keep = pos < C                                           # rank in expert
    bidx = torch.where(keep, se * C + pos, E * C)            # E*C: drop row

    buf = torch.zeros((b, E * C + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((rows, bidx), x.to(cdt)[rows, tok])
    # under a mesh the rows' slots stay split along batch only, so the
    # (b, E, C, d) and (E, b*C, d) views split no other sharded dimension
    buf = shard(buf, "act_batch,,act_embed")
    buf = buf[:, :E * C].reshape(b, E, C, d).transpose(0, 1)
    buf = buf.reshape(E, b * C, d)                           # every row's
    h = act(torch.bmm(buf, L.cast(p.gate, cdt))) * torch.bmm(
        buf, L.cast(p.up, cdt))
    out = torch.bmm(h, L.cast(p.down, cdt))                  # (E, b*C, d)
    out = shard(out, "act_experts,act_batch,act_embed")
    out = out.reshape(E, b, C, d).transpose(0, 1).reshape(b, E * C, d)

    ys = out[rows, bidx.clamp(max=E * C - 1)] * keep[..., None].to(cdt)
    y_slots = ys[rows, torch.argsort(order, dim=1)]          # inverse perm
    return (y_slots.reshape(b, s, k, d) * w.to(cdt)[..., None]).sum(dim=2)


def moe_apply(p: MoE, x, cfg: ModelConfig):
    """x: (b, s, d) -> (y (b, s, d) in the compute dtype, aux 0-d fp32).
    The capacity follows the call's ``s`` (a 512-token chunk, a one-token
    decode step), as in the reference."""
    m = cfg.moe
    w, idx, aux = route(p, x, cfg)
    C = capacity(x.shape[1], m.top_k, m.n_experts, m.capacity_factor)
    return dispatch(p, x, idx, w, cfg, C), aux
