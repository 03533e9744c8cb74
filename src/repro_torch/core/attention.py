"""Attention with a pluggable score normalizer — the reference's
``core/attention.py``: its whole-sequence walk and its serving branches.

* ``blockwise_attention`` — whole-sequence attention (training /
  whole-prompt prefill): query chunks against the KV chunks their causal /
  window reach allows. For consmax the KV loop's carry is the fp32 output
  accumulator alone; softmax and softermax (base 2) carry the online
  (m, l, acc) state. Plain PyTorch, not routed through a kernel, as the
  reference does not route it through one (``kernels/consmax_attn`` and
  ``kernels/softmax_attn`` are the tiled kernels of this loop, forward
  only). Training differentiates it with autograd, as the reference
  differentiates its jnp walk. The accumulator is added out of place (the
  same bits as ``acc +=``), so the walk also runs on DTensors, whose
  in-place add would need the fresh accumulator's placements.
* ``append_attention`` — chunked append-at-index prefill: a fixed-size
  chunk at per-slot cache position ``index`` attends ``cache[0:index]`` plus
  itself. For consmax each KV block's ``p @ v`` partial is final (no
  running max, no denominator), so the walk's carry is the fp32 output
  accumulator alone; softmax and softermax carry the online (m, l) state.
  The KV loop runs only up to the highest filled chunk, so cost tracks the
  fill level, not the cache capacity: inside a CUDA graph capture each
  block is an IF node on ``j < hi``, ``hi`` computed on the device as the
  reference computes it (``kernels/graph_cond``); eager, the walk sweeps
  every block, each masked past the fill, with the same bits. Neither
  reads the fill on the host.
* ``decode_attention`` — one-token decode against the cache, the score row
  materialized.
* ``paged_attention`` — the same append walk over a shared page pool: block
  j is one page per slot, gathered through the page table; unmapped (-1)
  pages are masked whole (``block_valid``).
* ``attention_apply`` — the module API: q/k/v projection, RoPE, the
  in-place cache write, the plain walks above or the ConSmax kernels
  (``kernels/consmax_prefill``, ``kernels/consmax_decode``, contiguous or
  paged), and the output projection; and the whole-sequence branch
  (training, whole-prompt prefill) through ``blockwise_attention``, which
  fills rows [0, s) of the cache when one is given.

Layouts as in the reference: q ``(b, s, H, dk)``, caches ``(b, L, hkv, dk)``
or page pools ``(P + 1, ps, hkv, dk)`` (see ``_paged_cache_write`` for the
spare page), per-slot ``index`` ``(b,)`` int32. The port writes K/V into the
cache tensors in place (the reference donates the cache buffer to the same
effect).

Quantized KV: a cache dict that carries ``k_scale``/``v_scale`` leaves
(int8 / fp8_e4m3 caches, ``models.transformer.init_caches``) stores K/V as
codes with one fp32 scale per row and KV head. Every write site quantizes
its fresh rows (``cache_layout.quantize_kv``) and writes the scales beside
them through the same row addressing; every read dequantizes block by
block (``cache_layout.dequant_block``), in the plain walks as in the
kernels, which take the scales as operands.

Cross-attention (``cond``, musicgen) attends the conditioning stream's
K/V without RoPE and writes no cache (``_cross_attention``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.core import normalizers
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.distributed.sharding import attention_on_shards, shard
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.cache_layout import kv_mask
from repro_torch.kernels.graph_cond.ops import if_node
from repro_torch.nn import layers as L
from repro_torch.nn import rope as R


class Attention(nn.Module):
    """q/k/v/o projections and the score normalizer's parameters, named as
    the reference's ``attention_init`` tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, H, hkv, dk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.q = L.HeadsProj(d, H, dk, bias=cfg.qkv_bias, device=device)
        self.k = L.HeadsProj(d, hkv, dk, head_axis="kv_heads",
                             bias=cfg.qkv_bias, device=device)
        self.v = L.HeadsProj(d, hkv, dk, head_axis="kv_heads",
                             bias=cfg.qkv_bias, device=device)
        self.o = L.HeadsOut(H, dk, d, device=device)
        self.score_norm = (ConSmaxParams(H, cfg.consmax, device=device)
                           if cfg.score_norm == "consmax" else nn.Module())

    def reset_parameters(self, generator: torch.Generator):
        for m in (self.q, self.k, self.v, self.o):
            m.reset_parameters(generator)
        if isinstance(self.score_norm, ConSmaxParams):
            self.score_norm.reset_parameters(generator)


# ------------------------------------------------- blockwise attention ----
def blockwise_attention(q, k, v, *, norm_kind: str, norm_params,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, merged: bool = False,
                        q_chunk: int = 2048, kv_chunk: int = 1024,
                        q_offset: int = 0):
    """q: (b, sq, H, dk); k, v: (b, skv, hkv, dk). Returns (b, sq, H, dk)
    in q.dtype.

    Query chunk i (positions ``q_offset + i0 .. q_offset + i1 - 1``) walks
    the KV chunks [lo, hi) its reach allows (the reference's static bounds:
    causal ``hi``, window ``lo``, at least one chunk). Chunk scores are fp32
    products of the compute-dtype operands, weights are cast to the compute
    dtype before ``p @ v``, and the accumulator is fp32. The last KV chunk
    may be short: the reference pads it and masks the pad keys, which adds
    exact zeros (consmax) or nothing to m and l (softmax / softermax)."""
    b, sq, H, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    n_kv = -(-skv // kc)
    cdt = q.dtype
    qg = q.reshape(b, sq, hkv, g, dk).float()
    kf, vf = k.float(), v.float()
    consmax = norm_kind == "consmax"
    if not consmax and norm_kind not in ("softmax", "softermax"):
        raise ValueError(f"unknown score_norm {norm_kind!r}")
    expf = torch.exp2 if norm_kind == "softermax" else torch.exp

    outs = []
    for i0 in range(0, sq, qc):
        i1 = min(i0 + qc, sq)
        hi = n_kv if not causal else min(n_kv, -(-(q_offset + i1) // kc))
        lo = max(0, (q_offset + i0 - window) // kc) if window > 0 else 0
        q_blk = qg[:, i0:i1]
        n_q = i1 - i0
        acc = torch.zeros((b, hkv, g, n_q, dk), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, g, n_q), normalizers.NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        for j in range(lo, max(hi, lo + 1)):
            k_blk = kf[:, j * kc:(j + 1) * kc]
            v_blk = vf[:, j * kc:(j + 1) * kc]
            n = k_blk.shape[1]
            s = torch.einsum("bqhgd,bchd->bhgqc", q_blk, k_blk)
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            qpos = q_offset + i0 + torch.arange(n_q, device=q.device)
            kpos = j * kc + torch.arange(n, device=q.device)
            msk = kv_mask(qpos[:, None], kpos[None, :], skv, window,
                          causal=causal)
            if consmax:
                p = normalizers.apply_norm(
                    "consmax", norm_params, s.reshape(b, H, n_q, n), msk,
                    head_axis=1, merged=merged).reshape(b, hkv, g, n_q, n)
                acc = acc + torch.einsum("bhgqc,bchd->bhgqd",
                                         p.to(cdt).float(), v_blk)
                continue
            s = torch.where(msk, s, normalizers.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = expf(m - m_new)
            e = torch.where(msk, expf(s - m_new[..., None]), 0.0)
            l = l * alpha + e.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqc,bchd->bhgqd", e.to(cdt).float(), v_blk)
            m = m_new
        if not consmax:
            acc = acc / l.clamp(min=1e-30)[..., None]
        outs.append(acc.permute(0, 3, 1, 2, 4).to(cdt))   # b q h g d
    return torch.cat(outs, dim=1).reshape(b, sq, H, dk)


# ---------------------------------------------------- cache writes ----
def _as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor is replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sharded_write(write, cache, new, index, *rest):
    """A cache-write site ``write(cache, new, index, *rest)`` on a DTensor
    cache (the dry run's, ``launch/specs.py``), shard by shard: the batch
    axis shards the slots, so each device writes its own slots' rows in
    its local cache, as the reference's partitioned update does. ``new``,
    ``index`` and a mask in ``rest`` are first brought to the cache's
    batch and head placements (a collective where they differ). A cache
    sharded along its rows (sequence-sharded KV) takes the one-token
    decode write only: the device that holds row ``index`` writes it, the
    others keep theirs."""
    mesh, pl = cache.device_mesh, cache.placements
    rows_sharded = [i for i, q in enumerate(pl)
                    if isinstance(q, Shard) and q.dim == 1]
    new_pl = tuple(Replicate() if i in rows_sharded else q
                   for i, q in enumerate(pl))
    slot_pl = tuple(Shard(0) if isinstance(q, Shard) and q.dim == 0
                    else Replicate() for q in pl)

    def slots(t):
        return (None if t is None else
                _as_dtensor(t, mesh).redistribute(mesh, slot_pl).to_local())

    local = cache.to_local()
    new = _as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    index = slots(index)
    if not rows_sharded:
        write(local, new, index, *[slots(t) for t in rest])
        return
    if write is not _decode_cache_write:
        raise NotImplementedError(
            "a sequence-sharded DTensor cache takes one-token decode "
            "writes only")
    n_rows = local.shape[1]
    coord = mesh.get_coordinate()
    shard = 0
    for i in rows_sharded:                               # major to minor
        shard = shard * mesh.size(i) + coord[i]
    rows = index - shard * n_rows
    own = (rows >= 0) & (rows < n_rows)
    active = slots(rest[0]) if rest and rest[0] is not None else None
    write(local, new, rows.clamp(0, n_rows - 1),
          own if active is None else own & active)


def _append_cache_write(cache, new, index, slot=None):
    """Write ``new``: (b, c, ...) into ``cache``: (b, L, ...) at per-slot
    row ``index``: (b,), in place — K/V rows (..., hkv, dk) or their
    (..., hkv) scales. ``slot`` (b,) int: ``cache`` is a (B, L, ...) slot
    pool and row i of ``new`` lands in slot ``slot[i]`` (the reference's
    ``dynamic_update_slice`` at the slot).

    As the reference's read-modify-write: the c-row window starts at
    ``clamp(index, 0, L - c)`` and the chunk's rows land at their true
    positions ``index + i``; rows that would fall past ``L`` (a ragged final
    chunk near the cache end) are dropped, and window rows below ``index``
    keep their content. Window rows are distinct, so the scatter is
    deterministic, and nothing is read back to the host."""
    if isinstance(cache, DTensor):
        return _sharded_write(_append_cache_write, cache, new, index)
    b, c = new.shape[:2]
    L_ = cache.shape[1]
    ar = torch.arange(c, device=cache.device)
    start = index.clamp(0, max(L_ - c, 0))
    off = index - start
    rows = start[:, None] + ar                               # (b, c)
    keep = (ar >= off[:, None]).reshape((b, c) + (1,) * (new.ndim - 2))
    src = (ar - off[:, None]).clamp(min=0)
    bi = torch.arange(b, device=cache.device)[:, None]
    ci = bi if slot is None else slot.long()[:, None]        # cache rows
    win = cache[ci, rows]
    cache[ci, rows] = torch.where(keep, new.to(cache.dtype)[bi, src], win)


def _paged_cache_write(pool, new, index, lengths, page_table):
    """Scatter ``new``: (b, c, ...) into the page ``pool``: (P + 1, ps, ...)
    at per-slot logical rows [index, index + lengths), in place: logical row
    t of slot b lands in page ``page_table[b, t // ps]``, row ``t % ps``.
    K/V rows (..., hkv, dk) and their (..., hkv) scales take the same
    rows; dropped ones reach the spare page alike.

    Pad rows (>= lengths), rows past the table and rows whose page is
    unmapped (-1) must reach no page. The reference drops them with an
    out-of-bounds scatter (``mode="drop"``), which torch lacks; sending them
    onto a real row instead would race with another slot's write of that
    row in the same scatter. So the pool carries one spare page past the
    ``PagePool``'s range (``init_paged_caches``), the last one, and every
    dropped row lands there: deterministic for every real row, no host
    sync, and nothing ever reads the spare page (no table maps it). Slots
    own disjoint pages (the ``PagePool`` invariant), so the real rows never
    collide."""
    spare, ps = pool.shape[0] - 1, pool.shape[1]
    b, c = new.shape[:2]
    npg = page_table.shape[1]
    ar = torch.arange(c, device=pool.device)
    pos = index[:, None] + ar                                 # (b, c) logical
    logical_page = pos // ps
    pid = torch.gather(page_table, 1, logical_page.clamp(0, npg - 1).long())
    drop = ((ar[None, :] >= lengths[:, None]) | (logical_page >= npg)
            | (pid < 0))
    pid = torch.where(drop, spare, pid)
    pool[pid.reshape(-1).long(), (pos % ps).reshape(-1).long()] = (
        new.reshape((b * c,) + new.shape[2:]).to(pool.dtype))


def _decode_cache_write(cache, new, index, active):
    """Write the one-token rows ``new``: (b, 1, ...) at ``index`` (clamped
    into the cache, as ``dynamic_update_slice`` does), in place — K/V rows
    (b, 1, hkv, dk) or their (b, 1, hkv) scales; slots where ``active`` is
    False keep their row."""
    if isinstance(cache, DTensor):
        return _sharded_write(_decode_cache_write, cache, new, index, active)
    b = new.shape[0]
    rows = index.clamp(0, cache.shape[1] - 1)
    bi = torch.arange(b, device=cache.device)
    new = new[:, 0].to(cache.dtype)
    if active is not None:
        keep = active.reshape((b,) + (1,) * (new.ndim - 1))
        new = torch.where(keep, new, cache[bi, rows])
    cache[bi, rows] = new


def _quantized_write(write, cache, k, v, *args):
    """Run ``write(leaf, new, *args)`` for K and V and, for a quantized
    cache, quantize the fresh rows first and write their scales through
    the same ``write`` (the reference's write sites)."""
    if "k_scale" in cache:
        k, ksc = CL.quantize_kv(k, cache["k"].dtype)
        v, vsc = CL.quantize_kv(v, cache["v"].dtype)
        write(cache["k_scale"], ksc, *args)
        write(cache["v_scale"], vsc, *args)
    write(cache["k"], k, *args)
    write(cache["v"], v, *args)


# ------------------------------------------------------------ plain walks ----
def _live_blocks(kv_len, kc, n_blocks):
    """(n_blocks,) bool on ``kv_len``'s device: block j is below the walk's
    bound ``hi``, the reference's ``max(-(-kv_len // kc))`` over the batch
    (inactive slots included), capped at ``n_blocks``."""
    hi = (-(-kv_len // kc)).amax().clamp(max=n_blocks)
    return torch.arange(n_blocks, device=kv_len.device) < hi


def _walk_blocks(body, n_blocks, live, device):
    """Run the walk's ``body(j)`` for j < ``n_blocks``. Inside a CUDA graph
    capture on ``device`` each block's body is captured into an IF node on
    ``live()[j]`` (``kernels/graph_cond``), so a replay runs blocks j < hi
    only, with no read of the fill on the host: the reference's
    ``fori_loop(0, hi)``. Everywhere else (the CPU, an eager CUDA run, the
    warm-up run before a capture, DTensors) every block runs: the sweep,
    whose blocks past the fill change nothing."""
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        for j in range(n_blocks):
            body(j)
        return
    live = live()
    for j in range(n_blocks):
        with if_node(live[j]):
            body(j)


def _kv_walk(q, index, lengths, gather, kc, n_blocks, hkv, *, norm_kind,
             norm_params, window=0, softcap=0.0, merged=True,
             block_valid=None):
    """A (b, c) chunk at per-slot positions index + [0, c) attends the
    cache's ``n_blocks`` blocks of ``kc`` rows, each masked by ``kv_mask``
    (``_walk_blocks``): under a CUDA graph capture blocks j < hi run, hi
    the batch's highest filled block computed on the device
    (``_live_blocks``), as the reference's ``fori_loop(0, hi)``; eager,
    every block runs. A block past a slot's fill changes nothing, bit for
    bit, as long as its rows are finite: its ConSmax weights are exact
    zeros, and for softmax / softermax its scores are the finite
    ``NEG_INF``, so ``m`` stays, ``alpha`` is exactly 1 and its weights are
    0. So the bounded walk and the sweep give the same bits. ``gather(j) ->
    (k_blk, v_blk)`` yields the (b, <= kc, hkv, dk) block of logical rows
    [j*kc, (j+1)*kc) — a slice of a contiguous cache, or one page per slot
    gathered through a page table. ``block_valid`` (b, n_blocks) bool
    (optional) masks a slot's whole block (a -1 page: the gather clamped it
    onto page 0). The masks of all blocks are made once, before the walk
    (each block's is a slice: the same elementwise compares, one pass).
    Products in fp32 of the compute-dtype operands, weights cast to the
    compute dtype before ``p @ v``, fp32 accumulator: the reference's
    ``preferred_element_type=float32`` einsums.

    For consmax the carry is the accumulator alone (each block's partial is
    final); softmax and softermax (base 2) carry the online (m, l, acc)
    state across blocks and divide by ``max(l, 1e-30)`` at the end. Each
    block updates the carry, allocated before the walk, in place: a block
    a replay skips leaves it as it was."""
    if norm_kind not in ("consmax", "softmax", "softermax"):
        raise ValueError(f"unknown score_norm {norm_kind!r}")
    b, c, H, dk = q.shape
    g = H // hkv
    cdt = q.dtype
    qg = q.reshape(b, c, hkv, g, dk).float()
    qpos = index[:, None] + torch.arange(c, device=q.device)    # (b, c)
    kv_len = index + lengths
    kpos = torch.arange(n_blocks * kc, device=q.device)
    masks = kv_mask(qpos[:, :, None], kpos[None, None, :],
                    kv_len[:, None, None], window)     # (b, c, n_blocks kc)
    if block_valid is not None:
        masks = (masks.view(b, c, n_blocks, kc)
                 & block_valid[:, None, :, None]).view(b, c, n_blocks * kc)
    consmax = norm_kind == "consmax"
    expf = torch.exp2 if norm_kind == "softermax" else torch.exp
    acc = torch.zeros((b, c, hkv, g, dk) if consmax else (b, hkv, g, c, dk),
                      dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, c), normalizers.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)

    def body(j):
        k_blk, v_blk = gather(j)
        k_blk, v_blk = k_blk.to(cdt).float(), v_blk.to(cdt).float()
        n = k_blk.shape[1]
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, k_blk)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        msk = masks[:, :, j * kc:j * kc + n]                  # (b, c, n)
        if consmax:
            p = normalizers.apply_norm(
                "consmax", norm_params, s.reshape(b, H, c, n), msk[:, None],
                head_axis=1, merged=merged).reshape(b, hkv, g, c, n)
            acc.add_(torch.einsum("bhgqc,bchd->bqhgd", p.to(cdt).float(),
                                  v_blk))
            return
        msk = msk[:, None, None]                              # (b,1,1,c,n)
        s = torch.where(msk, s, normalizers.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = expf(m - m_new)
        e = torch.where(msk, expf(s - m_new[..., None]), 0.0)
        l.mul_(alpha).add_(e.sum(dim=-1))
        acc.mul_(alpha[..., None]).add_(torch.einsum(
            "bhgqc,bchd->bhgqd", e.to(cdt).float(), v_blk))
        m.copy_(m_new)

    _walk_blocks(body, n_blocks, lambda: _live_blocks(kv_len, kc, n_blocks),
                 q.device)
    if not consmax:
        acc = (acc / l.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return acc.reshape(b, c, H, dk).to(cdt)


def append_attention(q, k, v, index, lengths, *, norm_kind, norm_params,
                     window=0, softcap=0.0, merged=True, kv_chunk=1024,
                     k_scale=None, v_scale=None, slot=None):
    """q: (b, c, H, dk) chunk queries at per-slot positions index + [0, c);
    k, v: (b, L, hkv, dk) caches *after* the chunk's K/V were written at
    ``index``; lengths: (b,) real (non-pad) tokens in the chunk. Each query
    row attends causally to cache rows < index + lengths; rows >= lengths
    are pad queries whose output the caller ignores. ``k_scale``/``v_scale``
    (b, L, hkv): the row scales of a quantized cache, applied to each
    gathered block (``dequant_block``). ``slot`` (b,) int: the caches are a
    (B, L, ...) slot pool and row i reads slot ``slot[i]``, block by
    block."""
    kc = min(kv_chunk, k.shape[1])
    rows = slice(None) if slot is None else slot.long()

    def gather(j):
        sl = slice(j * kc, (j + 1) * kc)
        if k_scale is None:
            return k[rows, sl], v[rows, sl]
        return (CL.dequant_block(k[rows, sl], k_scale[rows, sl], q.dtype),
                CL.dequant_block(v[rows, sl], v_scale[rows, sl], q.dtype))

    return _kv_walk(q, index, lengths, gather, kc, -(-k.shape[1] // kc),
                    k.shape[2], norm_kind=norm_kind, norm_params=norm_params,
                    window=window, softcap=softcap, merged=merged)


def paged_attention(q, kp, vp, page_table, index, lengths, *, norm_kind,
                    norm_params, window=0, softcap=0.0, merged=True,
                    k_scale=None, v_scale=None):
    """Attention of a (b, c, H, dk) chunk against page-pool KV (consmax).

    kp, vp: (P, ps, hkv, dk) pools; page_table: (b, npg) int32 (-1 =
    unmapped); index: (b,) chunk start positions; lengths: (b,) real tokens
    in the chunk. Covers chunked append prefill (c > 1) and one-token
    decode (c == 1, lengths = the active mask: an inactive slot gets
    kv_len = index, a fully masked row whose output is discarded). Block j
    is page ``page_table[:, j]`` of every slot; an unmapped entry is clamped
    to page 0 by the gather and masked whole (``block_valid``), since
    under sequence sharding a -1 can sit inside the fill. ``k_scale``/
    ``v_scale`` (P, ps, hkv): the scale pools of a quantized pool, gathered
    with each page and applied to it (``dequant_block``)."""
    ps = kp.shape[1]
    pids = page_table.clamp(min=0).long()

    def gather(j):
        pid = pids[:, j]
        if k_scale is None:
            return kp[pid], vp[pid]
        return (CL.dequant_block(kp[pid], k_scale[pid], q.dtype),
                CL.dequant_block(vp[pid], v_scale[pid], q.dtype))

    return _kv_walk(q, index, lengths, gather, ps, page_table.shape[1],
                    kp.shape[2], norm_kind=norm_kind,
                    norm_params=norm_params, window=window, softcap=softcap,
                    merged=merged, block_valid=page_table >= 0)


def decode_attention(q, k, v, index, *, norm_kind, norm_params, window=0,
                     softcap=0.0, merged=True, k_scale=None, v_scale=None):
    """q: (b, 1, H, dk); k, v: (b, L, hkv, dk); index: (b,) current
    position (its K/V row already written). The score row is materialized,
    and with it a quantized cache's rows dequantized by their (b, L, hkv)
    ``k_scale``/``v_scale``, as the reference's plain decode does."""
    if k_scale is not None:
        k = CL.dequant_block(k, k_scale, q.dtype)
        v = CL.dequant_block(v, v_scale, q.dtype)
    b, _, H, dk = q.shape
    L_, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    cdt = q.dtype
    qg = q.reshape(b, hkv, g, dk).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.to(cdt).float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(L_, device=q.device)
    msk = kv_mask(index[:, None], kpos[None, :], index[:, None] + 1,
                  window)                                       # (b, L)
    p = normalizers.apply_norm(norm_kind, norm_params, s.reshape(b, H, 1, L_),
                               msk[:, None, None, :], head_axis=1,
                               merged=merged)
    p = p.reshape(b, hkv, g, L_).to(cdt).float()
    out = torch.einsum("bhgc,bchd->bhgd", p, v.to(cdt).float())
    return out.reshape(b, 1, H, dk).to(cdt)


# ----------------------------------------------------------- module api ----
def _cross_attention(p: Attention, x, cond, cfg: ModelConfig, *, cache,
                     merged, q_chunk, kv_chunk):
    """Cross-attention of x: (b, s, d) over the conditioning stream cond:
    (b, n_cond, d), no RoPE and no cache write (the reference's ``cond``
    branch). Without a cache, or with s > 1, every query attends every
    cond row through ``blockwise_attention`` (non-causal); a one-token
    decode step (``cache`` is the block's dummy ``{"index"}``) runs
    ``decode_attention`` over the full cond K/V at ``kv_index = n_cond -
    1``. Returns (out, cache)."""
    b, s, _ = x.shape
    dk, cdt = cfg.head_dim_, cfg.cdtype()
    q = p.q(x, cdt) * torch.tensor(1.0 / math.sqrt(dk), dtype=cdt)
    k = p.k(cond, cdt)
    v = p.v(cond, cdt)
    q = shard(q, "act_batch,act_seq,act_heads,")
    k = shard(k, "act_batch,act_seq,act_kv_heads,")
    v = shard(v, "act_batch,act_seq,act_kv_heads,")
    if cache is None or s > 1:
        out = attention_on_shards(
            blockwise_attention, q, k, v, norm_kind=cfg.score_norm,
            norm_params=p.score_norm, causal=False, softcap=cfg.attn_softcap,
            merged=merged, q_chunk=q_chunk, kv_chunk=kv_chunk)
        cache = None
    else:
        kv_index = torch.full((b,), k.shape[1] - 1, dtype=torch.int32,
                              device=x.device)
        out = attention_on_shards(
            decode_attention, q, k, v, kv_index, norm_kind=cfg.score_norm,
            norm_params=p.score_norm, softcap=cfg.attn_softcap,
            merged=merged)
    return shard(p.o(out, cdt), "act_batch,act_seq,act_embed"), cache


def attention_apply(p: Attention, x, cfg: ModelConfig, *,
                    kind: str = "global", positions=None, cache=None,
                    cond=None, merged=False, q_chunk: int = 2048,
                    kv_chunk: int = 1024, decode_kernel: bool = False,
                    decode_kv_block: int = 256, prefill_kernel: bool = False,
                    prefill_kv_block: int = 512,
                    fill_bound: bool = True, prefill_append=None,
                    decode_active=None, page_table=None, attn_mesh=None,
                    slot=None):
    """Self-attention over x: (b, s, d), with or without a per-slot KV
    cache.

    cache: None (training: whole-sequence causal attention through
    ``blockwise_attention``) or dict(k, v, index[, k_scale, v_scale]) —
    K/V (and a quantized cache's scales) are written in place; the returned
    cache dict holds the same tensors and the advanced index. With a cache
    and neither ``prefill_append`` nor a one-token x, x is a whole prompt:
    it attends through ``blockwise_attention`` on its own full-precision
    K/V, which then fill cache rows [0, s) (quantized when the cache is),
    and ``index`` becomes s. ``positions`` (b or 1, s) are the whole-
    sequence RoPE positions (default 0..s-1); the serving branches take
    theirs from the cache index.
    prefill_append: (b,) int32 real chunk lengths — x is a fixed-size chunk
    appended at the cache's per-slot ``index``. Pad rows' K/V are zeroed
    before the write and ``index`` advances by the real count.
    slot: (b,) int32 on the device, with ``prefill_append`` — the engine's
    static prefill step: ``cache`` is the whole slot pool and row i of x
    appends to slot ``slot[i]`` (RoPE positions from ``index[slot]``, the
    K/V written at ``(slot, rows)``, the prefill kernel and the plain walk
    reading that slot); a paged cache slot-addresses its ``index`` only
    (``page_table`` is then the slot's row). The returned ``index`` is the
    (b,) advanced index of those slots.
    decode_active: (b,) bool — one-token decode: slots where False keep
    their cache row and index; their output is garbage to be discarded.
    decode_kernel / prefill_kernel: route consmax decode / append prefill
    through the ConSmax kernels (``decode_kv_block`` / ``prefill_kv_block``
    size the decode / prefill kernels' KV shards; ``fill_bound`` skips work
    past each slot's fill).
    page_table: (b, npg) int32 — paged KV: the cache's k/v are shared
    (P + 1, ps, hkv, dk) pools and each slot's logical rows live on the
    pages its table row maps (-1 = unmapped). One branch covers chunked
    prefill and one-token decode, where the active mask doubles as the
    chunk length: an inactive slot writes nothing and reads a fully masked
    row whose output is discarded.
    cond: (b, n_cond, d) — cross-attention over this conditioning stream
    (``_cross_attention``); ``cache`` is then None or the block's dummy.
    attn_mesh: a serving mesh's ``distributed.comm.AttentionMesh`` — ``p``
    holds the whole q/k/v/o projections and this rank's per-head beta /
    gamma; the rank keeps its heads of q/k/v (``local_heads``), the cache
    its heads and, sequence-sharded, its pages; the per-rank output goes
    through ``attn_mesh.combine`` (an fp32 all-reduce over ``seq``, an
    all-gather of the heads over ``model``) before the full o-projection,
    as at the reference's ``psum_axes``.
    Returns (out, new_cache).
    """
    if cond is not None:
        return _cross_attention(p, x, cond, cfg, cache=cache, merged=merged,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, s, _ = x.shape
    H, dk = cfg.n_heads, cfg.head_dim_
    cdt = cfg.cdtype()
    window = cfg.window if kind == "local" else 0
    consmax_kernels = cfg.score_norm == "consmax"
    whole = cache is None or (prefill_append is None and s > 1)
    if whole and page_table is not None:
        raise NotImplementedError(
            "paged KV caches serve chunked prefill (prefill_append) and "
            "one-token decode only: whole-prompt prefill writes contiguous "
            "rows")

    q = p.q(x, cdt) * torch.tensor(1.0 / math.sqrt(dk), dtype=cdt)
    k = p.k(x, cdt)
    v = p.v(x, cdt)
    q = shard(q, "act_batch,act_seq,act_heads,")
    k = shard(k, "act_batch,act_seq,act_kv_heads,")
    v = shard(v, "act_batch,act_seq,act_kv_heads,")
    if attn_mesh is not None:
        # the rank's heads of the whole projections (serve_mesh: the full
        # GEMM's bits); elementwise work after this commutes with the slice
        q, k, v = attn_mesh.local_heads(q, k, v)

    rope_on = cfg.rope_style != "none"
    interleaved = cfg.rope_style == "interleaved"
    rot = int(dk * cfg.rope_fraction)
    if rot % 2:
        rot -= 1
    if whole:
        pos = (torch.arange(s, device=x.device)[None, :] if positions is None
               else positions)
    else:
        idx = cache["index"]                                 # (b,) int32
        if slot is not None:
            if prefill_append is None:
                raise ValueError("slot addresses append-prefill chunks")
            idx = idx.index_select(0, slot)
        pos = idx[:, None] + torch.arange(s, device=x.device)[None, :]
    if rope_on:
        q = R.apply_rope(q, pos, rotary_dim=rot, theta=cfg.rope_theta,
                         interleaved=interleaved)
        k = R.apply_rope(k, pos, rotary_dim=rot, theta=cfg.rope_theta,
                         interleaved=interleaved)

    if whole:
        # training, or whole-prompt prefill: attention on the full-precision
        # K/V; only the cache write pays the quantization round trip
        out = attention_on_shards(
            blockwise_attention, q, k, v, norm_kind=cfg.score_norm,
            norm_params=p.score_norm, causal=True, window=window,
            softcap=cfg.attn_softcap, merged=merged, q_chunk=q_chunk,
            kv_chunk=kv_chunk)
        new_cache = None
        if cache is not None:
            def fill(leaf, new):
                leaf[:, :s] = new.to(leaf.dtype)
            _quantized_write(fill, cache, k, v)
            new_cache = dict(cache, index=torch.full(
                (b,), s, dtype=torch.int32, device=x.device))
        if attn_mesh is not None:
            out = attn_mesh.combine(out, cdt)
        return shard(p.o(out, cdt), "act_batch,act_seq,act_embed"), new_cache

    k_cache, v_cache = cache["k"], cache["v"]
    scales = {}
    if "k_scale" in cache:
        scales = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    if consmax_kernels:
        beta = p.score_norm.beta.float().expand(H).contiguous()
        gamma = p.score_norm.gamma.float().expand(H).contiguous()

    if page_table is not None:
        if prefill_append is not None:
            lengths = prefill_append.to(torch.int32)
        elif decode_active is None:
            lengths = torch.ones_like(idx)
        else:
            lengths = decode_active.to(torch.int32)
        # pad rows / inactive slots land on the spare page, never a real one
        _quantized_write(_paged_cache_write, cache, k, v, idx, lengths,
                         page_table)
        kw = dict(window=window, softcap=cfg.attn_softcap, merged=merged,
                  **scales)
        if prefill_append is not None and prefill_kernel and consmax_kernels:
            from repro_torch.kernels.consmax_prefill.ops import (
                consmax_prefill_paged_op)
            out = consmax_prefill_paged_op(
                q, k_cache, v_cache, page_table, idx, lengths, beta, gamma,
                scale=1.0, bk=prefill_kv_block, fill_bound=fill_bound, **kw)
        elif prefill_append is None and decode_kernel and consmax_kernels:
            from repro_torch.kernels.consmax_decode.ops import (
                consmax_decode_paged_op)
            out = consmax_decode_paged_op(
                q, k_cache, v_cache, page_table, idx + lengths, beta, gamma,
                scale=1.0, bk=decode_kv_block, fill_bound=fill_bound, **kw)
        else:
            out = paged_attention(q, k_cache, v_cache, page_table, idx,
                                  lengths, norm_kind=cfg.score_norm,
                                  norm_params=p.score_norm, **kw)
        new_index = idx + lengths
    elif prefill_append is not None:
        lengths = prefill_append.to(torch.int32)
        # zero pad rows (>= lengths) so they never enter the cache; a zero
        # row quantizes to (0, scale 1.0) and reads back as zeros
        keep = (torch.arange(s, device=x.device)[None, :]
                < lengths[:, None])[..., None, None]
        _quantized_write(_append_cache_write, cache, torch.where(keep, k, 0),
                         torch.where(keep, v, 0), idx, slot)
        k_cache = shard(k_cache, "act_batch,act_kv_seq,act_kv_heads,")
        v_cache = shard(v_cache, "act_batch,act_kv_seq,act_kv_heads,")
        if prefill_kernel and consmax_kernels:
            from repro_torch.kernels.consmax_prefill.ops import (
                consmax_prefill_op)
            out = consmax_prefill_op(
                q, k_cache, v_cache, idx, lengths, beta, gamma,
                window=window, softcap=cfg.attn_softcap, merged=merged,
                scale=1.0, bk=prefill_kv_block, fill_bound=fill_bound,
                slot=slot, **scales)
        else:
            if slot is not None:
                scales["slot"] = slot
            out = attention_on_shards(
                append_attention, q, k_cache, v_cache, idx, lengths,
                norm_kind=cfg.score_norm, norm_params=p.score_norm,
                window=window, softcap=cfg.attn_softcap, merged=merged,
                kv_chunk=kv_chunk, **scales)
        new_index = idx + lengths
    else:
        _quantized_write(_decode_cache_write, cache, k, v, idx,
                         decode_active)
        k_cache = shard(k_cache, "act_batch,act_kv_seq,act_kv_heads,")
        v_cache = shard(v_cache, "act_batch,act_kv_seq,act_kv_heads,")
        if decode_kernel and consmax_kernels:
            from repro_torch.kernels.consmax_decode.ops import (
                consmax_decode_op)
            out = consmax_decode_op(
                q, k_cache, v_cache, idx, beta, gamma, window=window,
                softcap=cfg.attn_softcap, merged=merged, scale=1.0,
                bk=decode_kv_block, fill_bound=fill_bound, **scales)
        else:
            out = attention_on_shards(
                decode_attention, q, k_cache, v_cache, idx,
                norm_kind=cfg.score_norm, norm_params=p.score_norm,
                window=window, softcap=cfg.attn_softcap, merged=merged,
                **scales)
        step = 1 if decode_active is None else decode_active.to(idx.dtype)
        new_index = idx + step
    if attn_mesh is not None:
        out = attn_mesh.combine(out, cdt)
    out = shard(p.o(out, cdt), "act_batch,act_seq,act_embed")
    return out, dict(cache, index=new_index)
