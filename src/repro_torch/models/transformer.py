"""Decoder LM assembled from the block zoo — the reference's
``models/transformer.py``.

``LM`` holds the parameters under the reference's tree names
(``embed``, ``blocks[i][f"b{j}"]``, ``final_norm``; ``blocks[i]`` is super-
layer ``i``, the reference's leading ``n_super`` axis). ``lm_apply`` is the
forward pass with the serving and training options of the reference's
``lm_apply``, and returns its summed MoE aux loss; a Python loop over
super-layers replaces ``lax.scan``, and ``torch.utils.checkpoint`` around
each super-layer replaces its ``jax.checkpoint`` (``remat``).

Caches are a list over super-layers of ``{f"b{j}": {kind: leaves}}``. An
attention block's ``{"attn": {k, v, index}}`` holds per-slot ``(b, max_seq,
hkv, dk)`` rows (``init_caches``) or, for paged serving, shared
``(num_pages + 1, page_size, hkv, dk)`` page pools (``init_paged_caches``).
An int8 / fp8_e4m3 cache adds fp32 ``k_scale``/``v_scale`` leaves of the
same shape without dk, one scale per row and KV head; a bf16 cache has
none. Recurrent blocks hold their state: ``{"mamba": {conv, h}}``,
``{"mlstm": {conv, C, n, m}}``, ``{"slstm": {h, c, n, m}}``. Forward
passes update K/V (and scales) in place, rebind ``index`` and return the
recurrent state anew; the slot utilities below update in place
(``store_index`` writes a pass's advanced ``index`` back into the caches'
own leaves, ``store_state`` every leaf a pass returns anew, so a step that
ends in one leaves every leaf where it was; ``reset_caches`` puts a tree
back to its initial state).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.kernels import cache_layout as CL
from repro_torch.models import blocks as B
from repro_torch.models import frontends as FE
from repro_torch.models import mamba as MB
from repro_torch.models import xlstm as XL
from repro_torch.nn import layers as L


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"b{j}": B.Block(cfg, kind, device=device)
                           for j, kind in enumerate(cfg.block_pattern)})
            for _ in range(cfg.n_super_layers))
        self.final_norm = L.Norm(cfg.d_model, kind=cfg.norm, device=device)

    def reset_parameters(self, generator: torch.Generator):
        self.embed.reset_parameters(generator)
        for sup in self.blocks:
            for blk in sup.values():
                blk.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, cfg: ModelConfig, **kw):
        """``lm_apply`` on this model; the trainer calls the model through
        here, so hooks on the module (FSDP2's) run around it."""
        return lm_apply(self, cfg, **kw)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of plain 2-D matmuls (the
    projections and the MLP), recompute the rest — batched products such as
    the attention scores included. The counterpart of the reference's
    ``dots_with_no_batch_dims_saveable``."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` recomputed in backward per ``remat`` (``"none"``, ``"full"``
    or ``"dots"``); remat changes no value."""
    if remat == "none":
        return fn
    if remat == "full":
        context_fn = ckpt.noop_context_fn
    elif remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    else:
        raise ValueError(f"unknown remat {remat!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def _sum(terms):
    """The blocks' aux terms of one super-layer summed in order (the
    reference's loop), None where no block has experts."""
    terms = [t for t in terms if t is not None]
    return sum(terms[1:], terms[0]) if terms else None


def lm_apply(p: LM, cfg: ModelConfig, *, tokens=None, embeds=None,
             cond=None, caches=None, positions=None, merged=False,
             remat="none", q_chunk=2048, kv_chunk=1024, logits_index=None,
             decode_kernel=False, decode_kv_block=256, prefill_kernel=False,
             prefill_kv_block=512, fill_bound=True, prefill_append=None,
             decode_active=None, page_table=None, logits_epilogue=None,
             attn_mesh=None, slot=None):
    """Forward pass over a (b, s) token batch (``tokens``) or, for the stub
    vlm / audio frontends, (b, s, d) precomputed ``embeds``; ``cond`` (b,
    n_cond, d) is the conditioning stream of a cross-attention config.
    Against per-slot caches or (``caches=None``) without any: the
    whole-sequence forward.

    With caches and neither ``prefill_append`` nor a one-token batch, the
    input is a whole prompt that fills cache rows [0, s) and the recurrent
    state (the reference's whole-prompt prefill; the caller passes
    ``positions``).

    prefill_append: (b,) int32 real chunk lengths — ``tokens`` is a
    fixed-size chunk written into each attention cache at its per-slot
    ``index`` (which then advances by the real length); positions default
    to ``index + arange(s)``. Otherwise a one-token decode step: the caller
    passes ``positions`` (= cache index; None for an attention-free arch)
    and optionally ``decode_active`` (b,) bool — slots where False keep
    their cache rows and index.
    page_table: (b, npg) int32 — paged caches (``init_paged_caches``): each
    slot's logical rows live on the pool pages its table row maps; all
    layers fill in lockstep, so one table serves the whole stack.
    slot: (b,) int32 on the device, with ``prefill_append`` — ``caches``
    are the whole slot pool and batch row i appends to slot ``slot[i]``
    (``core.attention.attention_apply``); the returned caches' ``index`` is
    those slots' advanced index, for ``store_index``.
    attn_mesh: the serving mesh's ``distributed.comm.AttentionMesh``,
    threaded to every attention block (the reference's ``psum_axes``):
    ``p`` is then a rank's head slice (``distributed/serve_mesh``).
    logits_index: int or (b,) — unembed only that row (per batch row).
    logits_epilogue: ``(logits, new_caches) -> out`` returned in place of
    the logits (the serving sampling hook; it reads the post-step index).
    remat: ``"none"`` | ``"full"`` | ``"dots"`` — how each super-layer of
    the whole-sequence forward (``caches=None``) is recomputed in backward
    while autograd records (``_remat``); ignored otherwise. The trainer
    passes ``TrainConfig.remat``.
    Returns (logits | epilogue out, new_caches, aux): aux is the sum of the
    blocks' MoE load-balance losses (0-d fp32; 0 without experts).
    """
    src = tokens if tokens is not None else embeds
    s, dev = src.shape[1], src.device
    if positions is None and caches is None:
        positions = torch.arange(s, device=dev)[None, :]
    elif positions is None and prefill_append is not None:
        idx = cache_index(caches)                      # per-slot fill level
        if slot is not None:
            idx = idx.index_select(0, slot)
        positions = idx[:, None] + torch.arange(s, device=dev)
    x = FE.frontend_apply(p.embed, cfg, tokens=tokens, embeds=embeds,
                          positions=positions)
    x = shard(x, "act_batch,act_seq,act_embed")
    auxes = []                  # per super-layer MoE aux (experts only)

    if caches is None:
        def super_step(x, sup):
            a = []
            for name in sup:
                x, _, ab = sup[name](
                    x, cfg, positions=positions, cond=cond,
                    merged=merged, q_chunk=q_chunk, kv_chunk=kv_chunk)
                a.append(ab)
            return x, _sum(a)

        if torch.is_grad_enabled():
            super_step = _remat(super_step, remat)
        for sup in p.blocks:
            x, a = super_step(x, sup)
            auxes.append(a)
        new_caches = None
    else:
        new_caches = []
        for sup, cache_in in zip(p.blocks, caches):
            co, a = {}, []
            for name in sup:
                x, co[name], ab = B.block_apply(
                    sup[name], x, cfg, positions=positions,
                    cache=cache_in[name], cond=cond, merged=merged,
                    q_chunk=q_chunk, kv_chunk=kv_chunk,
                    decode_kernel=decode_kernel,
                    decode_kv_block=decode_kv_block,
                    prefill_kernel=prefill_kernel,
                    prefill_kv_block=prefill_kv_block, fill_bound=fill_bound,
                    prefill_append=prefill_append,
                    decode_active=decode_active, page_table=page_table,
                    attn_mesh=attn_mesh, slot=slot)
                a.append(ab)
            new_caches.append(co)
            auxes.append(_sum(a))
    auxes = [a for a in auxes if a is not None]
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=dev))

    x = p.final_norm(x)
    if logits_index is not None:
        if isinstance(logits_index, int):
            x = x[:, logits_index:logits_index + 1]
        else:                                  # (b,) per-batch row gather
            li = logits_index.to(torch.int64)
            x = torch.take_along_dim(x, li[:, None, None], dim=1)
    logits = L.unembed(p.embed.table, x, dtype=cfg.cdtype())
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits.float()
                                                / cfg.final_softcap)
    logits = shard(logits, "act_batch,act_seq,act_vocab")
    if logits_epilogue is not None:
        return logits_epilogue(logits, new_caches), new_caches, aux
    return logits, new_caches, aux


# --------------------------------------------------------------- caches ----
def _kv_leaves(rows: tuple, hkv: int, dk: int, dtype, device) -> dict:
    """Zero ``k``/``v`` (*rows, hkv, dk) and, for a quantized dtype, fp32
    ``k_scale``/``v_scale`` (*rows, hkv) initialised to ones (the
    reference's init; a zero row with scale 1.0 reads back as zeros)."""
    leaves = {name: torch.zeros(rows + (hkv, dk), dtype=dtype, device=device)
              for name in ("k", "v")}
    if CL.kv_quantized(dtype):
        leaves.update({name: torch.ones(rows + (hkv,), dtype=torch.float32,
                                        device=device)
                       for name in ("k_scale", "v_scale")})
    return leaves


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                kv_dtype="bfloat16", *, device=None):
    """Per-super-layer caches: for every attention block zero ``k``/``v``
    (batch, max_seq, hkv, dk) in ``kv_dtype`` (bfloat16, int8 or fp8_e4m3,
    ``cache_layout.kv_cache_dtype``), for a quantized dtype fp32
    ``k_scale``/``v_scale`` (batch, max_seq, hkv) of ones, and a zero
    ``index`` (batch,) int32; for every recurrent block its zero state
    (``mamba_cache_init``, ``mlstm_cache_init``, ``slstm_cache_init``). On
    ``device`` (default cuda)."""
    dtype = CL.kv_cache_dtype(kv_dtype)
    device = resolve_device(device)
    hkv, dk = cfg.n_kv_heads, cfg.head_dim_

    def one_super():
        c = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind in B.ATTN_KINDS:
                c[f"b{j}"] = {"attn": {
                    **_kv_leaves((batch, max_seq), hkv, dk, dtype, device),
                    "index": torch.zeros((batch,), dtype=torch.int32,
                                         device=device),
                }}
            elif kind in ("mamba", "mamba_moe"):
                c[f"b{j}"] = {"mamba": MB.mamba_cache_init(
                    cfg, batch, device=device)}
            elif kind == "mlstm":
                c[f"b{j}"] = {"mlstm": XL.mlstm_cache_init(
                    cfg, batch, device=device)}
            elif kind == "slstm":
                c[f"b{j}"] = {"slstm": XL.slstm_cache_init(
                    cfg, batch, device=device)}
            else:
                raise ValueError(f"unknown block kind {kind!r}")
        return c

    return [one_super() for _ in range(cfg.n_super_layers)]


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, kv_dtype="bfloat16", *, device=None):
    """Paged caches: for every attention block ONE shared zero K/V pool
    (num_pages + 1, page_size, hkv, dk) instead of per-slot rows, and a
    zero per-slot ``index`` (batch,) int32 that keeps its contiguous
    meaning (fill level in logical rows). Which pages back which slot is
    the host-side ``PagePool``'s table, passed to ``lm_apply`` as
    ``page_table``. Pages [0, num_pages) are the reference's pool; the one
    past them is a spare that takes the writes the reference's scatter
    drops (``core.attention._paged_cache_write``) and that no table maps.
    A quantized ``kv_dtype`` (see ``init_caches``) adds fp32 scale pools
    (num_pages + 1, page_size, hkv) of ones, spare page included, so a
    page's scales move with its rows. On ``device`` (default cuda)."""
    dtype = CL.kv_cache_dtype(kv_dtype)
    device = resolve_device(device)
    hkv, dk = cfg.n_kv_heads, cfg.head_dim_

    def one_super():
        c = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind not in B.ATTN_KINDS:
                raise NotImplementedError(
                    f"paged KV caches cover attention blocks only (got "
                    f"{kind!r} in {cfg.block_pattern})")
            c[f"b{j}"] = {"attn": {
                **_kv_leaves((num_pages + 1, page_size), hkv, dk, dtype,
                             device),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=device),
            }}
        return c

    return [one_super() for _ in range(cfg.n_super_layers)]


def _attn_caches(caches):
    for sup in caches:
        for blk in sup.values():
            if "attn" in blk:
                yield blk["attn"]


def cache_index(caches):
    """Per-slot decode positions (b,) int32 from the first attention cache
    (all layers agree); None for an attention-free arch."""
    return next(_attn_caches(caches), {}).get("index")


def store_index(caches, new_caches, slot=None):
    """Write the advanced ``index`` of a pass's returned caches into the
    ``index`` leaves of ``caches``, in place, layer by layer (K/V were
    written in place already): whole, or at the device ``slot`` (b,) of a
    slot-addressed prefill pass (``index_copy_``: the reference's
    ``dynamic_update_slice`` of the slot's index)."""
    for pool, new in zip(_attn_caches(caches), _attn_caches(new_caches)):
        if slot is None:
            pool["index"].copy_(new["index"])
        else:
            pool["index"].index_copy_(0, slot.long(), new["index"])


def store_state(caches, new_caches):
    """Write every leaf of a pass's returned caches that is not already
    the leaf of ``caches`` into that leaf, in place: the advanced ``index``
    and the recurrent state (Mamba ``conv`` / ``h``, mLSTM ``conv`` / ``C``
    / ``n`` / ``m``, sLSTM ``h`` / ``c`` / ``n`` / ``m``). K/V and their
    scales, which the pass wrote in place, are the leaves themselves and
    are left alone."""
    for sup, new_sup in zip(caches, new_caches):
        for name, blk in sup.items():
            for kind, leaves in blk.items():
                new = new_sup[name][kind]
                for key, t in leaves.items():
                    if new[key] is not t:
                        t.copy_(new[key])


def reset_caches(caches):
    """Put a cache tree back to the state ``init_caches`` makes, in place:
    K/V, ``index`` and recurrent state zero, a quantized cache's scales
    one."""
    for sup in caches:
        for blk in sup.values():
            for c in blk.values():
                for key, t in c.items():
                    if key in ("k_scale", "v_scale"):
                        t.fill_(1.0)
                    else:
                        t.zero_()


def write_slot(caches, slot_caches, slot: int, length: int):
    """Scatter a batch-1 prefilled cache into slot ``slot`` of a batched
    cache, in place; ``index`` becomes ``length``, the real prompt length
    and not the padded prefill length, so decode masking ignores pad rows.

    The K/V (and scale) leaves of ``slot_caches`` may hold fewer rows than
    the slot (a prefill-bucket cache): only that prefix is written, and its
    rows ``>= length`` are zeroed on the way in, since a padded prefill
    computes pad-token K/V there and copying it would leave keys in the
    slot that an append-at-index chunk could later read. Recurrent state
    is copied whole."""
    for sup, one_sup in zip(caches, slot_caches):
        for name, blk in sup.items():
            for kind, pool in blk.items():
                one = one_sup[name][kind]
                for key, t in pool.items():
                    if key == "index":
                        t[slot] = length
                    elif kind != "attn":
                        t[slot] = one[key][0].to(t.dtype)
                    else:
                        n = one[key].shape[1]
                        t[slot, :n] = one[key][0].to(t.dtype)
                        t[slot, length:n].zero_()


def reset_slot(caches, slot: int):
    """Zero slot ``slot`` in place (index back to 0, K/V rows, a quantized
    cache's scale rows and recurrent state cleared, as the reference does)
    so a recycled slot cannot leak a previous request's context."""
    for sup in caches:
        for blk in sup.values():
            for c in blk.values():
                for t in c.values():
                    t[slot].zero_()


def reset_slot_paged(caches, slot: int):
    """Paged recycle: only ``index`` is slot-addressed. The slot's pages go
    back to the host-side ``PagePool``, and stale rows a later owner
    inherits sit at or past its fill, where every read masks them
    (``reset_slot`` would zero pool page ``slot``, which belongs to whoever
    the allocator gave it to)."""
    set_slot_index(caches, slot, 0)


def set_slot_index(caches, slot: int, value: int):
    """Set slot ``slot``'s fill index to ``value`` in every layer, in place.
    Warm prefix-cache admission needs it: the slot's table row already maps
    cached pages holding ``value`` rows, so the first prefill chunk must
    append past them."""
    for attn in _attn_caches(caches):
        attn["index"][slot] = value


def copy_kv_page(caches, src: int, dst: int):
    """Copy pool page ``src`` onto page ``dst`` in every layer of a paged
    cache, in place — K/V rows and a quantized pool's scale rows; ``index``
    untouched. The device half of copy-on-write: the ``PagePool`` picks the
    pages, the engine runs this before a slot writes into a page it no
    longer shares."""
    for attn in _attn_caches(caches):
        for key, t in attn.items():
            if key != "index":
                t[dst] = t[src]


# ----------------------------------------------------------- logical axes ----
def lm_axes(cfg: ModelConfig) -> dict:
    """{parameter name: logical axes} of ``LM(cfg)``: the axes each
    parameter declares where it is made (``nn.layers.param``), the
    reference's ``lm_axes`` leaf strings without the leading ``layers`` of
    its stacked blocks."""
    return {name: t.logical_axes
            for name, t in LM(cfg, device="meta").named_parameters()}


def cast_param_dtype(model: LM, cfg: ModelConfig) -> LM:
    """Store ``model``'s parameters in ``cfg.param_dtype``, in place, except
    the leaves the reference keeps in fp32 (``keeps_fp32``: the ConSmax
    beta / gamma, the MoE router, the recurrent gates). Returns ``model``."""
    pdt = cfg.pdtype()
    with torch.no_grad():
        for t in model.parameters():
            if not t.keeps_fp32 and t.dtype != pdt:
                t.data = t.data.to(pdt)
    return model


def lm_abstract(cfg: ModelConfig, *, device="meta") -> LM:
    """``LM(cfg)`` with no storage (the ``meta`` device), each parameter in
    the reference's dtype for ``cfg``: the counterpart of its
    ``lm_abstract``."""
    return cast_param_dtype(LM(cfg, device=device), cfg)


def cache_axes(cfg: ModelConfig, *, quantized: bool = False,
               paged: bool = False) -> list:
    """Logical axes of every leaf of ``init_caches`` (with ``paged``,
    ``init_paged_caches``), in the same structure: the reference's
    ``cache_axes`` without the leading ``layers``. ``quantized`` adds the
    ``k_scale``/``v_scale`` leaves, named as their rows minus dk; paged
    pools name their page axis ``act_kv_pages``."""
    def one_super():
        c = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind in B.ATTN_KINDS:
                rows = ("act_kv_pages,," if paged
                        else "act_batch,act_kv_seq,")
                attn = {"k": rows + "act_kv_heads,",
                        "v": rows + "act_kv_heads,",
                        "index": "act_batch"}
                if quantized:
                    attn["k_scale"] = rows + "act_kv_heads"
                    attn["v_scale"] = rows + "act_kv_heads"
                c[f"b{j}"] = {"attn": attn}
            elif kind in ("mamba", "mamba_moe"):
                c[f"b{j}"] = {"mamba": {"conv": "act_batch,,act_mlp",
                                        "h": "act_batch,act_mlp,"}}
            elif kind == "mlstm":
                c[f"b{j}"] = {"mlstm": {"conv": "act_batch,,act_mlp",
                                        "C": "act_batch,act_heads,,",
                                        "n": "act_batch,act_heads,",
                                        "m": "act_batch,act_heads"}}
            elif kind == "slstm":
                c[f"b{j}"] = {"slstm": {k: "act_batch,act_mlp"
                                        for k in ("h", "c", "n", "m")}}
        return c
    return [one_super() for _ in range(cfg.n_super_layers)]
