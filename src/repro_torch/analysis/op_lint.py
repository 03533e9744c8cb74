"""Op recording + pluggable serving-step lint rules (the counterpart of the
reference's ``analysis/jaxpr_lint.py``).

The port's serving steps are eager Python, so there is no jaxpr to walk:
``record_ops`` runs a step under a ``TorchDispatchMode`` and records every
aten op it dispatches, with its tensor inputs' and outputs' shapes, dtypes
and devices (``OpRecord``). A kernel captured by ``kernels/launch_plan``
(``kernel_contracts.capture_launches``) shows as one opaque op
``launch.<kernel>``, and none of its plain version's ops: the lint judges
the step's device-memory traffic, as the reference's lint does not descend
into Pallas bodies. A ``StepTarget`` bundles what the rules need about one
step: its ops, the element count above which an operand counts as
*cache-sized*, the vocab size when fused sampling promises token-only
outputs, the step's non-cache outputs, and the cache leaves going in and
coming out. Rules are small objects with a ``name``, a one-line ``doc``
and ``check(target)`` returning ``Finding``s.

The rules (names shared with the reference where the meaning carries
over):

* ``no-cache-sized-layout-ops`` — no ``clone`` / ``copy_`` / ``_to_copy`` /
  ``constant_pad_nd`` of a cache-sized operand: a permute or transpose is a
  view in PyTorch, and the copy that materializes it is one of these. Each
  is a full-cache copy per token.
* ``no-vocab-sized-outputs`` — under fused sampling, a step returns ``(b,)``
  int32 tokens, not ``(b, vocab)`` logits.
* ``no-host-syncs`` — the counterpart of ``no-host-callbacks``: no
  ``_local_scalar_dense`` (``.item()``, ``bool(t)``, ``int(t)``), no
  ``nonzero`` or other op whose output shape depends on the data, and (on
  a card) no copy to the host, on a tensor of the step's device. Each
  stalls the host until the card drains, and none may sit in a step that
  a CUDA graph is to capture.
* ``cache-dtype-stability`` — every cache leaf leaves a step with the dtype
  it entered with.
* ``quant-scale-contract`` — a quantized cache's scale leaves stay fp32,
  and no cache-sized widening ``_to_copy`` (a dequantized full-cache copy)
  runs: dequantization belongs block by block inside the kernels.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import launch_plan as LP

# ops that copy their operand: at cache size, a full-cache copy per step
LAYOUT_OPS = ("clone", "copy_", "_to_copy", "constant_pad_nd")
# ops that read a device value on the host or size their output by data
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "equal", "is_nonzero",
})


@dataclass(frozen=True)
class Finding:
    """One rule violation: ``rule`` names the rule, ``target`` the step or
    kernel it fired on, ``detail`` is a small json-able tuple (op names,
    shapes, dtypes) locating the violation."""
    rule: str
    target: str
    message: str
    detail: tuple = ()

    def to_json(self) -> dict:
        return {"rule": self.rule, "target": self.target,
                "message": self.message, "detail": _jsonify(self.detail)}


def _jsonify(v):
    if isinstance(v, (tuple, list)):
        return [_jsonify(x) for x in v]
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


# ------------------------------------------------------------- recording ----
@dataclass(frozen=True)
class TensorMeta:
    shape: tuple
    dtype: str
    device: str

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def itemsize(self) -> int:
        return getattr(torch, self.dtype).itemsize


def meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), LP.dtype_name(t.dtype), t.device.type)


def metas(tree) -> tuple:
    """The ``TensorMeta`` of every tensor in a nested list / tuple / dict,
    in order."""
    if isinstance(tree, torch.Tensor):
        return (meta(tree),)
    if isinstance(tree, dict):
        return tuple(m for k in tree for m in metas(tree[k]))
    if isinstance(tree, (list, tuple)):
        return tuple(m for x in tree for m in metas(x))
    return ()


@dataclass(frozen=True)
class OpRecord:
    """One dispatched op: ``name`` (the aten overload packet, e.g.
    ``"clone"``, or ``"launch.<kernel>"`` for a captured kernel launch),
    its tensor inputs and outputs."""
    name: str
    inputs: tuple
    outputs: tuple


class _Recorder(TorchDispatchMode):
    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not LP.opaque():
            self.ops.append(OpRecord(func.overloadpacket.__name__,
                                     metas((args, kwargs or {})),
                                     metas(out)))
        return out


@contextlib.contextmanager
def record_ops():
    """Record every aten op dispatched inside the block; yields the list of
    ``OpRecord``s. Kernel launches captured by ``launch_plan.capture`` land
    in it as one ``launch.<name>`` record each."""
    ops: list = []

    def on_launch(plan, inputs, outputs):
        ops.append(OpRecord(f"launch.{plan.name}", metas(inputs),
                            metas(outputs)))

    with LP.listen(on_launch), _Recorder(ops):
        yield ops


def cache_sized_ops(ops, threshold: int,
                    names=LAYOUT_OPS) -> list[tuple[str, tuple]]:
    """All ``(op_name, operand_shape)`` pairs where an op in ``names`` takes
    a tensor of >= ``threshold`` elements (its largest input). Captured
    kernel launches are opaque and never match."""
    bad = []
    for op in ops:
        if op.name in names and op.inputs:
            big = max(op.inputs, key=lambda m: m.numel)
            if big.numel >= threshold:
                bad.append((op.name, big.shape))
    return bad


def vocab_sized_outputs(outputs, vocab_size: int) -> list[tuple]:
    """Shapes of the ``TensorMeta``s (or tensors) in ``outputs`` that carry
    ``vocab_size`` along any axis: the fused-sampling steps make none."""
    return [tuple(m.shape) for m in outputs
            if vocab_size in tuple(m.shape)]


def host_syncs(ops, device: str) -> list[tuple[str, tuple]]:
    """``(op_name, operand_shape)`` of every op that syncs the host with
    ``device``'s tensors: a ``SYNC_OPS`` op on one, or (off the CPU) a copy
    of one to the host."""
    bad = []
    for op in ops:
        on_dev = [m for m in op.inputs if m.device == device]
        if op.name in SYNC_OPS and on_dev:
            bad.append((op.name, on_dev[0].shape))
        elif device != "cpu" and _to_host(op, device):
            bad.append((op.name, on_dev[0].shape))
    return bad


def _to_host(op: OpRecord, device: str) -> bool:
    """A copy from ``device`` to the host: ``_to_copy`` of a device tensor
    to a CPU one, or ``copy_`` of a device tensor into a CPU one."""
    if op.name == "_to_copy":
        return (bool(op.inputs) and op.inputs[0].device == device
                and bool(op.outputs) and op.outputs[0].device == "cpu")
    if op.name == "copy_":
        return (len(op.inputs) >= 2 and op.inputs[0].device == "cpu"
                and op.inputs[1].device == device)
    return False


# --------------------------------------------------------------- target ----
@dataclass
class StepTarget:
    """One serving step under lint.

    ``ops`` — the step's ``OpRecord``s (``record_ops``). ``cache_cells`` —
    element count above which an operand counts as cache-sized (``None``
    disables the layout rule). ``vocab_size`` — set iff the step promises
    token-only outputs (fused sampling); ``outputs`` — the step's returned
    non-cache tensors' ``TensorMeta``s. ``cache_in`` / ``cache_out`` —
    flat, same-order cache leaves entering and leaving the step (anything
    with ``.shape`` / ``.dtype``); empty disables the dtype-stability rule.
    ``scale_leaves`` — indices into them of a quantized cache's scale
    leaves. ``device`` — the device type the step runs on (host syncs are
    judged against it)."""
    name: str
    ops: list = field(default_factory=list)
    cache_cells: int | None = None
    vocab_size: int | None = None
    outputs: tuple = ()
    cache_in: tuple = ()
    cache_out: tuple = ()
    scale_leaves: tuple = ()
    device: str = "cpu"


def _dtype(leaf) -> str:
    d = leaf.dtype
    return d if isinstance(d, str) else LP.dtype_name(d)


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


# ---------------------------------------------------------------- rules ----
@dataclass(frozen=True)
class NoCacheSizedLayoutOps:
    name = "no-cache-sized-layout-ops"
    doc = ("no clone/copy_/_to_copy/constant_pad_nd of a cache-sized operand "
           "in a serving step (each is a full-cache copy per token)")
    ops: tuple = LAYOUT_OPS

    def check(self, t: StepTarget) -> list[Finding]:
        if not t.cache_cells:
            return []
        return [Finding(self.name, t.name,
                        f"{op} of cache-sized operand {shape} "
                        f"(>= {t.cache_cells} elements)", (op, shape))
                for op, shape in cache_sized_ops(t.ops, t.cache_cells,
                                                 self.ops)]


@dataclass(frozen=True)
class NoVocabSizedOutputs:
    name = "no-vocab-sized-outputs"
    doc = ("fused-sampling steps return (b,) int32 tokens — a vocab-sized "
           "output is a per-token logits transfer reintroduced")

    def check(self, t: StepTarget) -> list[Finding]:
        if not t.vocab_size:
            return []
        return [Finding(self.name, t.name,
                        f"vocab-sized output {shape} from a fused-sampling "
                        f"step (vocab={t.vocab_size})", (shape,))
                for shape in vocab_sized_outputs(t.outputs, t.vocab_size)]


@dataclass(frozen=True)
class NoHostSyncs:
    name = "no-host-syncs"
    doc = ("no .item()/bool()/nonzero/data-dependent shape or device->host "
           "copy inside a serving step (a host round trip per step; no CUDA "
           "graph can hold it)")

    def check(self, t: StepTarget) -> list[Finding]:
        return [Finding(self.name, t.name,
                        f"host sync {op!r} on {shape} inside a serving step",
                        (op, shape))
                for op, shape in host_syncs(t.ops, t.device)]


@dataclass(frozen=True)
class CacheDtypeStability:
    name = "cache-dtype-stability"
    doc = ("every cache leaf leaves a step with the dtype it entered with "
           "(no silent KV upcast/requantize)")

    def check(self, t: StepTarget) -> list[Finding]:
        if not t.cache_in and not t.cache_out:
            return []
        if len(t.cache_in) != len(t.cache_out):
            return [Finding(self.name, t.name,
                            f"cache tree changed arity across the step: "
                            f"{len(t.cache_in)} leaves in, "
                            f"{len(t.cache_out)} out",
                            (len(t.cache_in), len(t.cache_out)))]
        return [Finding(self.name, t.name,
                        f"cache leaf {i} {tuple(a.shape)} went in "
                        f"{_dtype(a)} and came out {_dtype(b)}",
                        (i, _dtype(a), _dtype(b)))
                for i, (a, b) in enumerate(zip(t.cache_in, t.cache_out))
                if _dtype(a) != _dtype(b)]


@dataclass(frozen=True)
class QuantScaleContract:
    name = "quant-scale-contract"
    doc = ("quantized-KV scale leaves stay fp32 across a step and no "
           "cache-sized widening copy (a dequantized full-cache copy) "
           "materializes in device memory")

    def check(self, t: StepTarget) -> list[Finding]:
        found = []
        for i in t.scale_leaves:
            if i >= len(t.cache_in) or i >= len(t.cache_out):
                continue
            for side, leaf in (("in", t.cache_in[i]),
                               ("out", t.cache_out[i])):
                if _dtype(leaf) != "float32":
                    found.append(Finding(
                        self.name, t.name,
                        f"scale leaf {i} {tuple(leaf.shape)} is "
                        f"{_dtype(leaf)} on the way {side} (must stay "
                        "float32: scales set the dequant precision)",
                        (i, side, _dtype(leaf))))
        if t.cache_cells:
            for op in t.ops:
                if op.name != "_to_copy" or not op.inputs or not op.outputs:
                    continue
                src, dst = op.inputs[0], op.outputs[0]
                if (src.numel >= t.cache_cells
                        and dst.itemsize > src.itemsize):
                    found.append(Finding(
                        self.name, t.name,
                        f"cache-sized widening copy {src.shape} {src.dtype} "
                        f"-> {dst.dtype}: a dequantized full-cache copy in "
                        "device memory (dequant belongs per block inside "
                        "the kernels)", (src.shape, src.dtype, dst.dtype)))
        return found


DEFAULT_RULES = (NoCacheSizedLayoutOps(), NoVocabSizedOutputs(),
                 NoHostSyncs(), CacheDtypeStability(), QuantScaleContract())


def run_rules(target: StepTarget, rules=DEFAULT_RULES) -> list[Finding]:
    """Run every rule against one step target; returns all findings."""
    findings = []
    for rule in rules:
        findings.extend(rule.check(target))
    return findings


def rule_catalog(rules=DEFAULT_RULES) -> dict[str, str]:
    return {r.name: r.doc for r in rules}
