"""Shared layout / masking helpers for the ConSmax kernels —
the torch twin of the reference's ``kernels/cache_layout.py``.

Everything the ConSmax kernels (decode, prefill and the full-sequence
attention kernels), their plain versions and the plain KV walks
(``core.attention``) agree on lives here: the one mask formula
(``kv_mask``, causal or not), the ConSmax weights (``consmax_weights``),
the GQA folding (``fold_gqa`` / ``unfold_gqa`` / ``tile_head_params``),
the fill bounding (``live_blocks`` / ``shard_live`` / ``fill_bounded_sum``),
the prefill kernels' KV-shard geometry (``prefill_shards``)
and the page gather of the paged kernels' plain versions
(``gather_pages``), and the quantized KV cache contract
(``quantize_kv`` / ``dequantize_kv`` / ``dequant_block``), and the page
ownership of a sequence-sharded pool (``page_shard`` /
``position_shard`` / ``localize_page_table``). The CUDA sources
under ``kernels/*/csrc`` restate ``kv_mask``, ``shard_live`` (for the
decode step, as a run of live shards), ``consmax_weights`` and
``dequant_block`` in device code; the tests hold the
kernels against the plain versions built from these helpers.

KV caches are stored as bfloat16, int8 or fp8_e4m3
(``ServeConfig.kv_cache_dtype``). A quantized cache carries one fp32 scale
per cache row per KV head (``k_scale`` / ``v_scale`` leaves shaped like the
cache without its dk axis), written by ``quantize_kv`` at every cache write
and applied by ``dequant_block`` one block at a time at every read — in the
CUDA kernels and in their plain versions alike.
"""
from __future__ import annotations

import torch


def divisor_block(n: int, bk: int) -> int:
    """Largest block size <= ``bk`` that divides ``n`` exactly."""
    bk = max(1, min(bk, n))
    while n % bk:
        bk -= 1
    return bk


def fold_gqa(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(b, c, H, dk) queries -> (b, hkv, c*g, dk), position-major rows:
    row ``r`` of KV head ``h`` holds query head ``h*g + r % g`` at chunk
    position ``r // g``."""
    b, c, H, dk = q.shape
    g = H // hkv
    return q.reshape(b, c, hkv, g, dk).transpose(1, 2).reshape(
        b, hkv, c * g, dk)


def unfold_gqa(out: torch.Tensor, b: int, c: int, H: int) -> torch.Tensor:
    """(b, hkv, c*g, dk) -> (b, c, H, dk)."""
    hkv, dk = out.shape[1], out.shape[-1]
    g = H // hkv
    return out.reshape(b, hkv, c, g, dk).transpose(1, 2).reshape(b, c, H, dk)


def tile_head_params(beta: torch.Tensor, gamma: torch.Tensor, hkv: int,
                     c: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(H,) per-head beta/gamma -> (hkv, c*g) rows matching ``fold_gqa``."""
    g = beta.shape[0] // hkv

    def tile(p):
        p = p.reshape(hkv, 1, g).float()
        return p.expand(hkv, c, g).reshape(hkv, c * g)

    return tile(beta), tile(gamma)


def kv_mask(qpos, kpos, kv_len, window: int, *, causal: bool = True):
    """The one attention mask shared by the kernels and the plain walks: a
    query at absolute position ``qpos`` sees key row ``kpos`` iff
    ``kpos < kv_len``, (causal) ``qpos >= kpos`` and (local layers)
    ``qpos - kpos < window``. The serving paths are always causal; the
    full-sequence attention kernels count positions from 0 for queries and
    keys alike, so their causal mask is top-left aligned also when there
    are more keys than queries."""
    mask = kpos < kv_len
    if causal:
        mask = mask & (qpos >= kpos)
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    return mask


# The most KV shards of the prefill kernels' grid (the reference's
# consmax_prefill MAX_KV_SHARDS): each live shard owns a chunk-output-sized
# fp32 partial, so ns stays O(10), not O(L / bk).
MAX_KV_SHARDS = 64


def prefill_shards(L: int, bk: int, tile: int = 64) -> tuple[int, int]:
    """``(shard_rows, ns)`` of the prefill kernels' KV-shard grid over a
    cache of ``L`` logical rows at the requested shard size ``bk``
    (``ServeConfig.prefill_kv_block``): ``shard_rows`` is
    ``max(bk, ceil(L / MAX_KV_SHARDS))`` rounded up to a multiple of the
    mainloop's ``tile``-row KV tile, and ``ns = ceil(L / shard_rows)``, so
    ``ns <= MAX_KV_SHARDS`` and the shards cover L (the last may be short).

    The reference snaps the shard to a divisor of L
    (``block_cache_rows``), because a TPU block must tile the array; the
    CUDA kernel needs only whole tiles, so it rounds to the tile instead.
    For L a multiple of 64 and bk a power of two >= 64 the two agree; a bk
    below the tile (the reference tests' 8 and 16) becomes one 64-row
    shard. The plain versions compute the whole product and need no split.
    """
    if bk <= 0:
        raise ValueError(f"prefill_kv_block must be positive, got {bk}")
    rows = max(bk, -(-L // MAX_KV_SHARDS))
    rows = -(-rows // tile) * tile
    return rows, max(1, -(-L // rows))


def live_blocks(max_kv_len, block: int, n_cap: int):
    """Count of ``block``-row KV shards holding any valid row, clamped to
    [1, n_cap]."""
    return torch.clamp((max_kv_len + block - 1) // block, 1, n_cap)


def shard_live(start, size: int, kv_len, *, qpos_hi=None, qpos_lo=None,
               window: int = 0):
    """True iff cache rows [start, start + size) can contribute a non-zero
    weight for any query in [qpos_lo, qpos_hi]: the shard holds a filled
    row, one of its rows is causally visible, and its last row is not
    entirely behind the sliding window of the earliest query. A shard that
    fails contributes exact zeros, so a kernel may skip it."""
    live = start < kv_len
    if qpos_hi is not None:
        live = live & (start <= qpos_hi)
    if window > 0 and qpos_lo is not None:
        live = live & ((start + size) > (qpos_lo - window + 1))
    return live


def fill_bounded_sum(partials, n_live, axis: int = 2):
    """Sum ``partials`` along ``axis`` treating slots >= ``n_live`` as exact
    zeros (selected, not multiplied: never-written slots may hold garbage)."""
    shape = [1] * partials.ndim
    shape[axis] = partials.shape[axis]
    idx = torch.arange(partials.shape[axis], device=partials.device)
    live = idx.reshape(shape) < n_live
    return torch.where(live, partials, 0.0).sum(dim=axis)


def gather_pages(pool, page_table):
    """The contiguous rows a page table maps: ``pool`` (P, ps, ...) — a
    (P, ps, hkv, dk) K/V pool or a (P, ps, hkv) scale pool —, ``page_table``
    (b, npg) int32 -> (b, npg * ps, ...), logical row r of slot b from page
    ``page_table[b, r // ps]``, and zeros for -1 entries. Plain and whole:
    the paged kernels' plain versions and tests use it, never the card's
    path."""
    b, npg = page_table.shape
    rows = pool[page_table.clamp(min=0).long()]       # (b, npg, ps, ...)
    valid = (page_table >= 0).reshape((b, npg) + (1,) * (pool.ndim - 1))
    rows = torch.where(valid, rows,
                       torch.zeros((), dtype=pool.dtype, device=pool.device))
    return rows.reshape(b, npg * pool.shape[1], *pool.shape[2:])


def consmax_weights(s, beta, gamma, merged: bool):
    """ConSmax score weights: Eq. 2 ``exp(s - beta) / gamma`` or the merged
    inference constant of Eq. 3, ``C * exp(s)`` with ``C = e^{-beta}/gamma``.
    ``beta``/``gamma`` broadcast against the fp32 score tile ``s``."""
    if merged:
        return torch.exp(-beta) / gamma * torch.exp(s)
    return torch.exp(s - beta) / gamma


# ------------------------------------------------ sequence-sharded pages ----
# Under ServeConfig.seq_shards = ns > 1 the page pool is split into ns
# contiguous per-rank blocks: seq rank d owns physical pages
# [d * P/ns, (d+1) * P/ns). The host allocator (serve/scheduler.PagePool)
# backs slot page position j with a page of rank j // ceil(max_pages/ns),
# the engine keeps ONE global page table, and each rank localizes it in the
# step: its own entries become indices into its pool slice, every other
# entry becomes -1, the unmapped page the kernels read as zeros.


def page_shard(page: int, pages_per_shard: int) -> int:
    """Owning seq rank of physical page ``page`` (host-side allocator
    math)."""
    return page // pages_per_shard


def position_shard(pos: int, position_block: int, seq_shards: int) -> int:
    """Seq rank that must back slot page position ``pos``: the block map,
    ``position_block = ceil(max_pages_per_slot / seq_shards)`` positions
    per rank. A request within one block lives on one rank (every other
    rank adds exactly +0.0 to its attention output); a longer one spills
    block by block."""
    return min(pos // position_block, seq_shards - 1)


def localize_page_table(table, shard, pages_per_shard: int):
    """The global page table -> seq rank ``shard``'s view: owned entries
    become indices into its pool slice, foreign (and -1) entries become -1.
    The identity when one rank owns the pool. ``table``: an int32 tensor,
    on the device of the step that reads it."""
    owned = (table >= 0) & (table // pages_per_shard == shard)
    return torch.where(owned, table - shard * pages_per_shard,
                       -1).to(table.dtype)


KV_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
}
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def kv_cache_dtype(name) -> torch.dtype:
    """The torch dtype a ``ServeConfig.kv_cache_dtype`` name stores K/V in
    (a torch dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in KV_DTYPES:
        raise ValueError(f"unknown kv cache dtype {name!r}; expected one of "
                         f"{sorted(KV_DTYPES)}")
    return KV_DTYPES[name]


def kv_quantized(name) -> bool:
    """True iff this kv dtype needs scale leaves and write-time
    quantization (bf16 is stored as is, with no scale leaves)."""
    return kv_cache_dtype(name) in _QMAX


def kv_qmax(dtype) -> float:
    """Largest magnitude the quantizer scales a row onto: 127 for int8, 448
    for fp8_e4m3."""
    dtype = kv_cache_dtype(dtype)
    if dtype not in _QMAX:
        raise ValueError(f"kv_qmax: {dtype} is not a quantized kv dtype")
    return _QMAX[dtype]


def quantize_kv(x, dtype):
    """K/V rows ``x`` (..., hkv, dk) -> (codes (..., hkv, dk) in ``dtype``,
    scale (..., hkv) fp32), one absmax scale per row per head: the
    reference's arithmetic exactly (fp32 upcast, ``amax / qmax`` with 1.0
    for an all-zero row, true division, int8 rounded half to even and
    clamped). An all-zero row quantizes to exact zeros with scale 1.0, so
    it reads back as the zeros a bf16 cache holds."""
    dtype = kv_cache_dtype(dtype)
    qmax = kv_qmax(dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax,
                        torch.ones((), dtype=torch.float32,
                                   device=x.device))
    q = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale


def dequantize_kv(q, scale, out_dtype=torch.float32):
    """Inverse of ``quantize_kv``: codes (..., hkv, dk) times their
    (..., hkv) fp32 row scales, an fp32 multiply, then ``out_dtype``."""
    return dequant_block(q, scale, out_dtype)


def dequant_block(x, scale, out_dtype):
    """One block's dequant: ``x`` (..., rows, dk) codes, ``scale`` their
    (..., rows) fp32 scales; an fp32 multiply, then a cast to the compute
    dtype. The CUDA kernels do the same (``dequant`` in
    ``csrc/consmax_common.cuh``: the product rounded to bf16), so a kernel
    on a quantized cache gives its own bits on the dequantized cache."""
    return (x.float() * scale.float()[..., None]).to(out_dtype)
