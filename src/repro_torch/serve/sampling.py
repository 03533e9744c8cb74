"""Per-slot sampling: the serving epilogue (reference ``serve/sampling.py``).

* ``SamplingParams`` — the per-request knobs, validated as the reference
  validates them.
* Parameter banks — the SoA device mirror, one ``(max_slots,)`` tensor per
  knob next to the KV caches; admission writes one row.
* ``apply_logits_masks`` — the exact top-k / top-p / min-p support of the
  reference.
* ``sample_tokens`` — greedy: ``argmax`` of the fp32 logits, the first
  index on ties, as in the reference.

Sampled streams (``temperature > 0``) draw with the reference's threefry
``fold_in`` keys; that generator is not ported yet, so a temperature above 0
is refused where it enters a bank (``bank_put``) and at
``ContinuousBatchingEngine.submit``.
"""
from __future__ import annotations

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

# SoA bank layout: one (n,) tensor per knob (seeds as int64: torch has no
# uint32 arithmetic; every uint32 seed fits)
_FIELDS = (("temperature", torch.float32), ("top_k", torch.int32),
           ("top_p", torch.float32), ("min_p", torch.float32),
           ("seed", torch.int64))


def require_greedy(sp: SamplingParams | None):
    """Raise for a sampled (temperature > 0) request: the reference's
    threefry draws are not ported yet, and a different generator would
    silently give other streams."""
    if sp is not None and sp.temperature > 0:
        raise NotImplementedError(
            f"temperature {sp.temperature} > 0: sampled streams need the "
            "reference's threefry fold_in draws, which are not ported yet "
            "(greedy only)")


def bank_init(n: int, device=None) -> dict:
    """Greedy-initialized SoA parameter bank for ``n`` slots."""
    return {name: torch.full((n,), getattr(GREEDY, name), dtype=dt,
                             device=device)
            for name, dt in _FIELDS}


def bank_put(bank: dict, slot: int, sp: SamplingParams | None) -> dict:
    """Write one slot's row in place (admission time; ``None`` = greedy)."""
    require_greedy(sp)
    sp = sp if sp is not None else GREEDY
    for name, _ in _FIELDS:
        bank[name][slot] = getattr(sp, name)
    return bank


def bank_take(bank: dict, rows) -> dict:
    """Gather bank rows."""
    return {name: bank[name][rows] for name, _ in _FIELDS}


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


def sample_tokens(logits, bank, positions=None):
    """(b, v) logits -> (b,) int32 tokens: the greedy argmax of the fp32
    logits (first index on ties). Banks hold greedy rows only (see
    ``require_greedy``), so ``bank`` and ``positions`` — the sampled draw's
    inputs in the reference — are accepted for the same call shape and not
    read."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
