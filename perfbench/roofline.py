"""The yardstick: published peaks, least times, model FLOPs, device busy.

A frozen copy of ``chip_smoke.py``'s ``_bound_ms``, ``_visible_pairs``,
``_attn_bound``, peaks and device-busy union, with the work of a served step
reckoned from the lengths the benchmark observes (never from the program's
own counts)."""
from __future__ import annotations

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def bound_s(nbytes, flops, peak=PEAK_BF16_FLOPS):
    """(least seconds, "bytes" | "operations"): the larger of bytes over
    the peak bandwidth and operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def visible_pairs(sq, skv, *, causal, window=0):
    """(query, key) pairs the full-sequence mask lets through, per (batch
    row, head)."""
    i = np.arange(sq)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def attn_bound_s(b, sq, skv, H, hkv, dk, **mask):
    """q, k, v and out moved once in bf16; 4 * dk * H flops per visible
    pair."""
    nbytes = 2 * (2 * b * sq * H * dk + 2 * b * skv * hkv * dk)
    return bound_s(nbytes, 4 * dk * H * b * visible_pairs(sq, skv, **mask))


def chunk_pairs(start: int, n: int) -> int:
    """Visible (query, key) pairs of an append chunk of ``n`` rows written
    at fill ``start``: query i sees keys 0 .. start + i."""
    return n * start + n * (n + 1) // 2


def prefill_chunk_bound_s(start, n, H, hkv, dk, kv_bytes=2):
    """Least time of one layer's prefill attention for a chunk: 4 dk H flops
    per visible pair; q and out once (bf16), the K and V rows [0, start + n)
    once at ``kv_bytes`` per element."""
    nbytes = 2 * 2 * n * H * dk + 2 * (start + n) * hkv * dk * kv_bytes
    return bound_s(nbytes, 4 * dk * H * chunk_pairs(start, n))[0]


def decode_row_bound_s(keys, H, hkv, dk, kv_bytes=2):
    """Least time of one layer's decode attention for a row seeing ``keys``
    cache rows: each live K and V row once, q and out once."""
    nbytes = 2 * keys * hkv * dk * kv_bytes + 2 * 2 * H * dk
    return bound_s(nbytes, 4 * dk * H * keys)[0]


def dense_params(d, H, hkv, dk, ff, *, qkv_bias):
    """Non-embedding weights of one dense decoder layer (projections, their
    biases, the gated MLP)."""
    attn = d * H * dk * 2 + d * hkv * dk * 2
    bias = (H + 2 * hkv) * dk if qkv_bias else 0
    return attn + bias + 3 * d * ff


def model_flops(dims: dict, work: dict) -> float:
    """Model FLOPs of served work: 2 x non-embedding parameters per token,
    4 dk H per visible (query, key) pair per layer, 2 d V per sampled
    position. ``work``: tokens, pairs (summed over the tokens, one layer)
    and sampled positions."""
    L, d, V = dims["layers"], dims["d"], dims["vocab"]
    per_tok = 2 * L * dense_params(dims["d"], dims["H"], dims["hkv"],
                                   dims["dk"], dims["ff"],
                                   qkv_bias=dims["qkv_bias"])
    return (per_tok * work["tokens"]
            + 4 * dims["dk"] * dims["H"] * L * work["pairs"]
            + 2 * d * V * work["sampled"])


def busy_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def idle_gaps(intervals, t0, t1):
    """The gaps (start, end) in [t0, t1] that no interval covers."""
    gaps, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]
