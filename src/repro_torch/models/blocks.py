"""MLP variants and residual block assembly (pre-norm, optional gemma2
sandwich post-norms) — the reference's ``models/blocks.py``. Block kinds:

* ``attn`` / ``global`` / ``local``: attention + dense MLP;
* ``attn_moe``: attention + MoE (``models/moe.py``);
* ``mamba`` / ``mamba_moe``: the Mamba SSM (+ MoE instead of the implicit
  MLP; ``models/mamba.py``);
* ``mlstm`` / ``slstm``: xLSTM cells (``models/xlstm.py``); an sLSTM block
  carries a 4/3-factor GLU FFN after the cell;
* any attention kind with ``cfg.cross_attn``: a cross-attention sub-block
  over the conditioning stream (musicgen).

The MoE FFN runs ``moe_apply``, or the expert-parallel all-to-all
``moe_apply_ep`` where an expert-parallel context asks for it and its
group size divides the expert count (``_moe_apply``, as the reference's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as ATT
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import moe_ep as MOE_EP
from repro_torch.models import xlstm as XL
from repro_torch.nn import layers as L

ATTN_KINDS = ("attn", "attn_moe", "global", "local")


def _moe_apply(p, h, cfg: ModelConfig):
    """The expert-parallel all-to-all MoE when the expert-parallel context
    asks for it and its group size divides the expert count; else
    ``moe_apply``."""
    comm = SH.ep_info()
    if comm is not None and cfg.moe.n_experts % comm.size == 0:
        return MOE_EP.moe_apply_ep(p, h, cfg, comm)
    return MOE.moe_apply(p, h, cfg)


class MLP(nn.Module):
    """``silu_glu`` / ``gelu_glu`` (gate, up, down) or ``gelu`` (up, down);
    hidden width ``d_ff`` (default ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, *,
                 device=None):
        super().__init__()
        if cfg.mlp not in ("silu_glu", "gelu_glu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.kind = cfg.mlp
        if cfg.mlp != "gelu":
            self.gate = L.Linear(d, ff, axes=("embed", "mlp"), device=device)
        self.up = L.Linear(d, ff, axes=("embed", "mlp"), device=device)
        self.down = L.Linear(ff, d, axes=("mlp", "embed"), device=device)

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
        h = SH.shard(h, "act_batch,act_seq,act_mlp")
        return self.down(h, dtype)


class Block(nn.Module):
    """One block of kind ``kind``, its sub-modules named as the reference's
    ``block_init`` tree."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind

        def norm():
            return L.Norm(d, kind=cfg.norm, device=device)

        if kind in ATTN_KINDS:
            self.attn_norm = norm()
            self.attn = ATT.Attention(cfg, device=device)
            if cfg.post_block_norm:
                self.attn_post_norm = norm()
            if cfg.cross_attn:
                self.xattn_norm = norm()
                self.xattn = ATT.Attention(cfg, device=device)
            self.mlp_norm = norm()
            if kind == "attn_moe":
                self.moe = MOE.MoE(cfg, device=device)
            else:
                self.mlp = MLP(cfg, device=device)
            if cfg.post_block_norm:
                self.mlp_post_norm = norm()
        elif kind in ("mamba", "mamba_moe"):
            self.mamba_norm = norm()
            self.mamba = MB.Mamba(cfg, device=device)
            if kind == "mamba_moe":
                self.moe_norm = norm()
                self.moe = MOE.MoE(cfg, device=device)
        elif kind == "mlstm":
            self.norm = norm()
            self.mlstm = XL.MLSTM(cfg, device=device)
        elif kind == "slstm":
            self.norm = norm()
            self.slstm = XL.SLSTM(cfg, device=device)
            self.mlp_norm = norm()
            self.mlp = MLP(cfg, d_ff=-(-(4 * d) // (3 * 64)) * 64,
                           device=device)
        else:
            raise ValueError(f"unknown block kind {kind!r}")

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x, cfg: ModelConfig, **kw):
        """``block_apply`` on this block. The whole-sequence forward calls
        blocks through here, so hooks on the module (FSDP2's unshard and
        reshard) run around it."""
        return block_apply(self, x, cfg, **kw)


def block_apply(p: Block, x, cfg: ModelConfig, *, positions=None,
                cache=None, cond=None, merged=False, q_chunk=2048,
                kv_chunk=1024, decode_kernel=False, decode_kv_block=256,
                prefill_kernel=False, prefill_kv_block=512, fill_bound=True,
                prefill_append=None, decode_active=None, page_table=None,
                attn_mesh=None, slot=None):
    """Returns (x, new_cache, aux): new_cache is None without a cache (the
    whole-sequence forward); aux is the MoE load-balance loss (0-d fp32),
    None for a block without experts (no device op for a zero). ``cond``
    (b, n_cond, d): the conditioning stream of a cross-attention config.
    ``page_table``: (b, npg) int32 for paged caches, ``slot`` the static
    prefill step's device slot and ``attn_mesh`` the serving mesh's
    attention handle (see ``core.attention``); the MoE FFN
    stays replicated under it, as in the reference. Under an
    expert-parallel context (``distributed/sharding.ep_info``) whose group
    size divides ``n_experts``, the MoE FFN runs through ``models/moe_ep``.
    """
    aux = None
    cdt = cfg.cdtype()
    kind = p.kind
    new_cache = None

    if kind in ATTN_KINDS:
        akind = kind if kind in ("local", "global") else "global"
        h, attn_cache = ATT.attention_apply(
            p.attn, p.attn_norm(x), cfg, kind=akind, positions=positions,
            cache=cache["attn"] if cache is not None else None,
            merged=merged, q_chunk=q_chunk, kv_chunk=kv_chunk,
            decode_kernel=decode_kernel, decode_kv_block=decode_kv_block,
            prefill_kernel=prefill_kernel, prefill_kv_block=prefill_kv_block,
            fill_bound=fill_bound, prefill_append=prefill_append,
            decode_active=decode_active,
            page_table=page_table, attn_mesh=attn_mesh, slot=slot)
        if cfg.post_block_norm:
            h = p.attn_post_norm(h)
        x = x + h
        if cfg.cross_attn and cond is not None:
            # one-token decode hands cross-attention a dummy cache, as the
            # reference does: it only tells decode from the whole sequence
            xc = ({"index": cache["attn"]["index"] - 1}
                  if cache is not None else None)
            h, _ = ATT.attention_apply(p.xattn, p.xattn_norm(x), cfg,
                                       cond=cond, cache=xc, merged=merged)
            x = x + h
        h = p.mlp_norm(x)
        if kind == "attn_moe":
            h, aux = _moe_apply(p.moe, h, cfg)
        else:
            h = p.mlp(h, cdt)
        if cfg.post_block_norm:
            h = p.mlp_post_norm(h)
        x = x + h
        if cache is not None:
            new_cache = dict(cache, attn=attn_cache)
    elif kind in ("mamba", "mamba_moe"):
        h, mc = MB.mamba_apply(p.mamba, p.mamba_norm(x), cfg,
                               cache=cache["mamba"] if cache is not None
                               else None)
        x = x + h
        if kind == "mamba_moe":
            h, aux = _moe_apply(p.moe, p.moe_norm(x), cfg)
            x = x + h
        if cache is not None:
            new_cache = dict(cache, mamba=mc)
    elif kind == "mlstm":
        h, mc = XL.mlstm_apply(p.mlstm, p.norm(x), cfg,
                               cache=cache["mlstm"] if cache is not None
                               else None)
        x = x + h
        if cache is not None:
            new_cache = dict(cache, mlstm=mc)
    else:                                                    # slstm
        h, sc = XL.slstm_apply(p.slstm, p.norm(x), cfg,
                               cache=cache["slstm"] if cache is not None
                               else None)
        x = x + h
        x = x + p.mlp(p.mlp_norm(x), cdt)
        if cache is not None:
            new_cache = dict(cache, slstm=sc)
    x = SH.shard(x, "act_batch,act_seq,act_embed")
    return x, new_cache, aux
