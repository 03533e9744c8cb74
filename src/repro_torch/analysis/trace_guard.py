"""Signature-count instrument for the serving step functions (the
counterpart of the reference's ``analysis/trace_guard.py``).

One step shape per engine lifetime is a serving-path contract: the
reference jits one prefill and one decode executable, and the port's
engines count the distinct (shape, dtype) signatures entering each step
(``prefill_cache_size`` / ``decode_cache_size``, and on paged engines the
warm-admission index pin and the copy-on-write page copy). A new signature
means a shape leaked into a step (a Python-int fill, a capacity-dependent
grid); under the reference it is a compile stall mid-serve, and it would
break a CUDA graph capture of the step.

``TraceGuard`` attaches to count functions (``track``) or to a live
``ContinuousBatchingEngine`` (``for_engine``); drive traffic, then
``assert_ok()`` / ``findings()``. Counts are deltas from attach time, so a
warm engine can be guarded too. ``SignatureCounter`` wraps any callable to
count its argument signatures the same way.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.op_lint import Finding
from repro_torch.serve.engine import _signature


class SignatureCounter:
    """Wrap ``fn``: every call records the (shape, dtype) signature of its
    arguments; ``cache_size()`` is the number of distinct ones, as the
    engines count theirs."""

    def __init__(self, fn):
        self.fn = fn
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        self._seen.add(_signature((args, kwargs)))
        return self.fn(*args, **kwargs)

    def cache_size(self) -> int:
        return len(self._seen)


@dataclass
class _Tracked:
    count: object
    baseline: int
    limit: int


@dataclass
class TraceGuard:
    """Watch step functions for new signatures.

    ``limit`` is the number of signatures a step is *allowed* after attach:
    1 for a cold engine (the first is the contract), 0 for a warm one."""
    _tracked: dict = field(default_factory=dict)

    def track(self, label: str, count, limit: int = 1) -> "TraceGuard":
        """Track ``count``, a zero-argument callable returning a step's
        signature count (``SignatureCounter.cache_size``, an engine's
        ``prefill_cache_size``)."""
        self._tracked[label] = _Tracked(count, int(count()), limit)
        return self

    @classmethod
    def for_engine(cls, engine, limit: int = 1) -> "TraceGuard":
        """Guard a ContinuousBatchingEngine's prefill and decode steps —
        plus, on paged engines, the prefix cache's warm-admission index pin
        and copy-on-write page copy, bound by the same one-shape
        contract."""
        guard = cls()
        guard.track("prefill_step", lambda: engine.prefill_cache_size, limit)
        guard.track("decode_step", lambda: engine.decode_cache_size, limit)
        if engine.paged:
            guard.track("set_index", lambda: engine.set_index_cache_size,
                        limit)
            guard.track("copy_page", lambda: engine.copy_page_cache_size,
                        limit)
        return guard

    def counts(self) -> dict[str, int]:
        """New signatures per tracked step since attach."""
        return {label: int(t.count()) - t.baseline
                for label, t in self._tracked.items()}

    def findings(self) -> list[Finding]:
        out = []
        for label, new in self.counts().items():
            limit = self._tracked[label].limit
            if new > limit:
                out.append(Finding(
                    "one-trace-per-step", label,
                    f"{label} saw {new} signatures (limit {limit}) — a "
                    "shape leaked into the step signature; fill and slot "
                    "occupancy must stay tensor values", (new, limit)))
        return out

    def assert_ok(self) -> None:
        bad = self.findings()
        assert not bad, "; ".join(f.message for f in bad)
