"""Shared layout / masking helpers for the ConSmax kernels —
the torch twin of the reference's ``kernels/cache_layout.py``.

Everything the ConSmax kernels (decode, prefill and the full-sequence
attention kernels), their plain versions and the plain KV walks
(``core.attention``) agree on lives here: the one mask formula
(``kv_mask``, causal or not), the ConSmax weights (``consmax_weights``),
the GQA folding (``fold_gqa`` / ``unfold_gqa`` / ``tile_head_params``),
the fill bounding (``live_blocks`` / ``shard_live`` / ``fill_bounded_sum``)
and the page gather of the paged kernels' plain versions
(``gather_pages``). The CUDA sources under ``kernels/*/csrc`` restate ``kv_mask``, ``shard_live`` and
``consmax_weights`` in device code; the tests hold the kernels against the
plain versions built from these helpers.

Only bfloat16 KV caches are served by the port so far: the quantized
(int8 / fp8_e4m3) cache names raise ``NotImplementedError``.
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
    """The contiguous rows a page table maps: ``pool`` (P, ps, hkv, dk),
    ``page_table`` (b, npg) int32 -> (b, npg * ps, hkv, dk), logical row r
    of slot b from page ``page_table[b, r // ps]``, and zeros for -1
    entries. Plain and whole: the paged kernels' plain versions and tests
    use it, never the card's path."""
    b, npg = page_table.shape
    rows = pool[page_table.clamp(min=0).long()]       # (b, npg, ps, ...)
    rows = torch.where((page_table >= 0).reshape(b, npg, 1, 1, 1), rows,
                       torch.zeros((), dtype=pool.dtype, device=pool.device))
    return rows.reshape(b, npg * pool.shape[1], *pool.shape[2:])


def consmax_weights(s, beta, gamma, merged: bool):
    """ConSmax score weights: Eq. 2 ``exp(s - beta) / gamma`` or the merged
    inference constant of Eq. 3, ``C * exp(s)`` with ``C = e^{-beta}/gamma``.
    ``beta``/``gamma`` broadcast against the fp32 score tile ``s``."""
    if merged:
        return torch.exp(-beta) / gamma * torch.exp(s)
    return torch.exp(s - beta) / gamma


KV_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}
_QUANTIZED = ("int8", "fp8_e4m3")


def kv_cache_dtype(name: str) -> torch.dtype:
    """The torch dtype a ``ServeConfig.kv_cache_dtype`` name stores K/V in.
    The quantized caches of the reference are not ported yet."""
    if name in _QUANTIZED:
        raise NotImplementedError(
            f"kv cache dtype {name!r}: quantized KV caches are not ported "
            "yet (the port serves bfloat16 caches only)")
    if name not in KV_DTYPES:
        raise ValueError(
            f"unknown kv cache dtype {name!r}; expected one of "
            f"{sorted(KV_DTYPES) + list(_QUANTIZED)}")
    return KV_DTYPES[name]
