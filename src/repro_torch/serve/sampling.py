"""Per-slot sampling: the serving epilogue (reference ``serve/sampling.py``).

* ``SamplingParams`` — the per-request knobs, validated as the reference
  validates them.
* Parameter banks — the SoA device mirror, one ``(n,)`` tensor per knob
  next to the KV caches: ``bank_init`` / ``bank_put`` (admission writes
  one row), ``bank_of`` (a broadcast ``SamplingParams`` gives row r the
  seed ``(seed + r) mod 2^32``), ``bank_take``.
* ``apply_logits_masks`` — the exact top-k / top-p / min-p support of the
  reference.
* ``sample_tokens`` — greedy rows take the first ``argmax`` of the fp32
  logits; sampled rows (``temperature > 0``) draw ``argmax(masked scores +
  Gumbel noise)`` with the reference's per-slot keys
  ``fold_in(fold_in(key(0), seed), position)``.

The draw is the reference's bit for bit: ``threefry2x32`` (20 rounds, the
Random123 rotations and key schedule) as integer ops on int64 tensors
holding uint32 lanes, so the CPU and the card run the same ops (torch's
uint32 lacks shift kernels on some devices); the counters, uniforms and
Gumbel transform of ``jax.random`` (partitionable threefry, Gumbel mode
"low"); and the logarithm XLA's CPU backend evaluates (``_xla_log``), so
the Gumbel noise equals the reference's on the CPU to the bit and is the
same on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature=0`` = greedy; ``top_k=0``,
    ``top_p=1``, ``min_p=0`` = the respective mask disabled."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"SamplingParams: temperature ({self.temperature}) must be "
                ">= 0 (0 = greedy)")
        if self.top_k < 0:
            raise ValueError(
                f"SamplingParams: top_k ({self.top_k}) must be >= 0 "
                "(0 = disabled)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"SamplingParams: top_p ({self.top_p}) must be in (0, 1] "
                "(1 = disabled)")
        if not 0.0 <= self.min_p < 1.0:
            raise ValueError(
                f"SamplingParams: min_p ({self.min_p}) must be in [0, 1) "
                "(0 = disabled)")
        if not 0 <= self.seed < 2**32:
            raise ValueError(
                f"SamplingParams: seed ({self.seed}) must fit in uint32")


GREEDY = SamplingParams()

# SoA bank layout: one (n,) tensor per knob. Seeds hold uint32 values in
# int64 (torch's uint32 lacks arithmetic on some devices).
_FIELDS = (("temperature", torch.float32), ("top_k", torch.int32),
           ("top_p", torch.float32), ("min_p", torch.float32),
           ("seed", torch.int64))


def bank_init(n: int, device=None) -> dict:
    """Greedy-initialized SoA parameter bank for ``n`` slots."""
    return {name: torch.full((n,), getattr(GREEDY, name), dtype=dt,
                             device=device)
            for name, dt in _FIELDS}


def bank_put(bank: dict, slot: int, sp: SamplingParams | None) -> dict:
    """Write one slot's row in place (admission time; ``None`` = greedy)."""
    sp = sp if sp is not None else GREEDY
    for name, _ in _FIELDS:
        bank[name][slot] = getattr(sp, name)
    return bank


def bank_of(sp, n: int, device=None) -> dict:
    """Bank from one ``SamplingParams`` broadcast to ``n`` rows (row r draws
    from ``(seed + r) mod 2^32``, so rows sample independent streams) or
    from a per-row sequence of them (seeds used as given: equal seeds share
    a stream)."""
    if sp is None:
        sp = GREEDY
    if isinstance(sp, SamplingParams):
        sps = [dataclasses.replace(sp, seed=(sp.seed + i) % 2**32)
               for i in range(n)]
    else:
        sps = list(sp)
        if len(sps) != n:
            raise ValueError(
                f"bank_of: {len(sps)} SamplingParams for {n} rows")
    return {name: torch.tensor([getattr(s, name) for s in sps], dtype=dt,
                               device=device)
            for name, dt in _FIELDS}


def bank_take(bank: dict, rows) -> dict:
    """Gather bank rows: ``rows`` a slice or list (host-path sampling over
    a slot subset), or a device tensor of slots (the engine's static
    prefill step, whose slot is a value: ``index_select``)."""
    if isinstance(rows, torch.Tensor):
        return {name: bank[name].index_select(0, rows)
                for name, _ in _FIELDS}
    return {name: bank[name][rows] for name, _ in _FIELDS}


# ------------------------------------------------------------ threefry ----
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11; Random123's
    rotations and key schedule, as ``jax.random``'s threefry2x32): keys
    ``(k0, k1)`` and counters ``(x0, x1)`` are int64 tensors holding
    uint32 values, broadcast together; returns the two output words
    alike."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in`` on threefry keys: ``key`` a pair of int64
    tensors holding uint32 words, ``data`` an int tensor taken mod 2^32;
    the new key is ``threefry2x32(key, (0, data))``."""
    data = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def slot_keys(seeds, positions):
    """(b,) per-slot draw keys ``fold_in(fold_in(key(0), seed), position)``
    as two (b,) int64 words; ``key(0)`` is the threefry key (0, 0)."""
    seeds = seeds.to(torch.int64) & _M32
    zero = torch.zeros_like(seeds)
    return fold_in(fold_in((zero, zero), seeds), positions)


def random_bits(keys, n: int):
    """(b, n) uint32 draws (in int64) of ``jax.random.bits(key, (n,))`` for
    each of the b keys: partitionable threefry counts (0, j) for j < n, and
    a 32-bit draw is the XOR of the two output words. Each row counts from
    0, as the reference's categorical vmapped over rows does."""
    k0, k1 = (k[:, None] for k in keys)
    j = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return b0 ^ b1


_TINY = float(torch.finfo(torch.float32).tiny)


def uniform(bits):
    """``jax.random.uniform(minval=tiny, maxval=1)`` from 32-bit draws: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled onto
    [tiny, 1) and floored at tiny, all in fp32 as the reference does."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    return torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)


def _f32(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_MIN_NORMAL = float(torch.finfo(torch.float32).smallest_normal)


def _fma(a, b, c):
    """fp32 ``a * b + c`` rounded once: the product of two fp32 values is
    exact in fp64, so only the sum rounds (to fp64, then to fp32)."""
    return (a.double() * b + c).float()


def _xla_log(x):
    """Natural log of positive normal fp32 ``x`` as XLA's CPU backend
    computes ``jnp.log`` (its vectorized Cephes polynomial, with the fused
    multiply-adds the compiler forms): the mantissa in [sqrt(1/2), sqrt(2)),
    a degree-8 polynomial, the exponent times ln 2 in two parts. It differs
    from a correctly rounded log by up to one ulp, so ``torch.log`` would
    move the Gumbel noise off the reference's bits; these fp32 / fp64 ops
    give the same bits on every device."""
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [.5, 1)
    low = m < 0.707106781186547524
    m = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    m = _fma(-x2, 0.5, m) + y
    return _fma(e, _LOG_Q2, m)


def gumbel(u):
    """Gumbel noise of mode "low": ``-log(-log(u))``."""
    return -_xla_log(-_xla_log(u))


# ------------------------------------------------------------- epilogue ----
def apply_logits_masks(scores, top_k, top_p, min_p):
    """Mask (b, v) temperature-scaled scores to the per-row sampling
    support; out-of-support entries become -inf. Disabled sentinels
    (top_k<=0, top_p>=1, min_p<=0) keep the full row; the row max always
    survives."""
    v = scores.shape[-1]
    sorted_desc = torch.sort(scores, dim=-1, descending=True).values
    # top-k: keep scores >= the k-th largest (ties included)
    k = top_k.clamp(1, v).to(torch.int64)
    kth = torch.take_along_dim(sorted_desc, (k - 1)[:, None], dim=-1)
    keep = (scores >= kth) | (top_k <= 0)[:, None]
    # top-p: minimal descending prefix whose exclusive cumulative mass
    # stays <= top_p, mapped back through the value cutoff
    probs = torch.softmax(sorted_desc, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    in_nucleus = excl <= top_p[:, None]
    cutoff = torch.where(in_nucleus, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    keep &= (scores >= cutoff) | (top_p >= 1.0)[:, None]
    # min-p: prob >= min_p * max prob  <=>  score >= max + log(min_p)
    mx = scores.amax(dim=-1, keepdim=True)
    keep &= scores >= mx + torch.log(min_p)[:, None]
    return torch.where(keep, scores, -torch.inf)


def sample_tokens(logits, bank, positions, *, any_sampled=None):
    """The logits -> token epilogue: (b, v) logits, the SoA ``bank`` and the
    (b,) cache positions -> (b,) int32 tokens. Rows with ``temperature <=
    0`` take the first argmax of the fp32 logits; the others draw
    ``argmax(masked + gumbel(uniform(bits)))`` over their temperature-
    scaled, top-k / top-p / min-p masked scores with the key
    ``fold_in(fold_in(key(0), seed), position)``. An all-greedy bank (the
    default) skips the sort and the draw, as the reference's ``lax.cond``
    does. ``any_sampled`` is the caller's host-side answer to "does a row
    whose token is used sample?" (the engine knows it from the requests it
    admitted): False skips the draw, True draws, both with no device read.
    Left None, the test reads the bank's temperatures on the host (a sync:
    the ``ServeSession`` and the logits paths, outside a fused step)."""
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    t = bank["temperature"]
    sampled = t > 0
    if any_sampled is None:
        any_sampled = bool(sampled.any())
    if not any_sampled:
        return greedy
    scaled = lf / torch.where(sampled, t, 1.0)[:, None]
    masked = apply_logits_masks(scaled, bank["top_k"], bank["top_p"],
                                bank["min_p"])
    keys = slot_keys(bank["seed"], positions)
    g = gumbel(uniform(random_bits(keys, lf.shape[-1])))
    drawn = torch.argmax(masked + g, dim=-1).to(torch.int32)
    return torch.where(sampled, drawn, greedy)
