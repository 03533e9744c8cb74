"""MLP variants and the dense residual block (pre-norm, optional gemma2
sandwich post-norms) — the reference's ``models/blocks.py`` for the block
kinds ``attn`` / ``global`` / ``local``. MoE, Mamba and xLSTM blocks are not
ported yet and raise."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as ATT
from repro_torch.nn import layers as L

ATTN_KINDS = ("attn", "global", "local")


class MLP(nn.Module):
    """``silu_glu`` / ``gelu_glu`` (gate, up, down) or ``gelu`` (up, down)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.mlp not in ("silu_glu", "gelu_glu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        d, ff = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp
        if cfg.mlp != "gelu":
            self.gate = L.Linear(d, ff, device=device)
        self.up = L.Linear(d, ff, device=device)
        self.down = L.Linear(ff, d, device=device)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x, dtype):
        if self.kind == "gelu":
            h = F.gelu(self.up(x, dtype), approximate="tanh")
        else:
            act = (F.silu if self.kind == "silu_glu"
                   else lambda t: F.gelu(t, approximate="tanh"))
            h = act(self.gate(x, dtype)) * self.up(x, dtype)
        return self.down(h, dtype)


class Block(nn.Module):
    """attention + dense MLP, pre-norm residuals."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (dense attention "
                f"blocks {ATTN_KINDS} only)")
        if cfg.cross_attn:
            raise NotImplementedError("cross-attention is not ported yet")
        d = cfg.d_model
        self.kind = kind
        self.attn_norm = L.Norm(d, kind=cfg.norm, device=device)
        self.attn = ATT.Attention(cfg, device=device)
        if cfg.post_block_norm:
            self.attn_post_norm = L.Norm(d, kind=cfg.norm, device=device)
        self.mlp_norm = L.Norm(d, kind=cfg.norm, device=device)
        self.mlp = MLP(cfg, device=device)
        if cfg.post_block_norm:
            self.mlp_post_norm = L.Norm(d, kind=cfg.norm, device=device)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.reset_parameters(generator)


def block_apply(p: Block, x, cfg: ModelConfig, *, positions=None,
                cache=None, merged=False, q_chunk=2048, kv_chunk=1024,
                decode_kernel=False, decode_kv_block=256,
                prefill_kernel=False, fill_bound=True, prefill_append=None,
                decode_active=None, page_table=None):
    """Returns (x, new_cache); new_cache is None without a cache (the
    whole-sequence forward). ``page_table``: (b, npg) int32 for paged
    caches (see ``core.attention.attention_apply``)."""
    akind = p.kind if p.kind in ("local", "global") else "global"
    cdt = cfg.cdtype()
    h = p.attn_norm(x)
    h, attn_cache = ATT.attention_apply(
        p.attn, h, cfg, kind=akind, positions=positions,
        cache=cache["attn"] if cache is not None else None, merged=merged,
        q_chunk=q_chunk, kv_chunk=kv_chunk, decode_kernel=decode_kernel,
        decode_kv_block=decode_kv_block, prefill_kernel=prefill_kernel,
        fill_bound=fill_bound, prefill_append=prefill_append,
        decode_active=decode_active, page_table=page_table)
    if cfg.post_block_norm:
        h = p.attn_post_norm(h)
    x = x + h
    h = p.mlp(p.mlp_norm(x), cdt)
    if cfg.post_block_norm:
        h = p.mlp_post_norm(h)
    x = x + h
    return x, (None if cache is None else dict(cache, attn=attn_cache))
