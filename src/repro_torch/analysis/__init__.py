"""Serving-path static analysis (op lint, launch contracts, trace guard,
collective contract) — the counterpart of the reference's
``analysis`` package.

The ConSmax serving design earns its speed from properties that are easy
to lose in a refactor: no serving step may copy a cache-sized tensor (the
kernels read the cache in its stored layout), the fused-sampling steps
return tokens and never vocab-sized logits, no step syncs the host (the
CUDA graphs the engine steps are headed for cannot hold a sync), every
block of a kernel grid writes its own output tile (ConSmax's pure-addition
combine is what makes the all-independent split-KV grid legal), and one
step shape serves the engine's whole lifetime. This package checks those
properties over the aten ops a step dispatches (``op_lint``), over the
kernels' launch plans without running them (``kernel_contracts``), over the
engines' step signatures (``trace_guard``) and over the collective log of a
sharded step (``collective_contract``); ``repro_torch.launch.analyze`` is
the gate that runs them all.
"""
from repro_torch.analysis.kernel_contracts import (KernelLaunch,
                                                   capture_launches,
                                                   check_launch,
                                                   serving_launches)
from repro_torch.analysis.op_lint import (Finding, StepTarget,
                                          cache_sized_ops, record_ops,
                                          run_rules, vocab_sized_outputs)
from repro_torch.analysis.trace_guard import TraceGuard

__all__ = [
    "Finding", "StepTarget", "cache_sized_ops", "record_ops", "run_rules",
    "vocab_sized_outputs", "KernelLaunch", "capture_launches",
    "check_launch", "serving_launches", "TraceGuard",
]
