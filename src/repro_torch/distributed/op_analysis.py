"""Collective and memory accounting of one traced step — the counterpart of
the reference's ``distributed/hlo_analysis.py``.

The reference parses the partitioned HLO that XLA compiles for one device.
The port has no compiled program: its step runs eagerly, op by op, and on
a mesh as DTensors (``launch/specs.py``). So the accounting watches the
ops one device dispatches while the step runs, through a
``TorchDispatchMode`` (``LocalOps``): a DTensor op is let through to
DTensor, which then dispatches the device's local ops and collectives back
into the mode. The ops that DTensor runs on global-shape fake tensors to
infer an output's metadata are not the device's work and are not counted.

* ``record_collectives`` logs every ``c10d`` / ``_c10d_functional``
  collective the step dispatches as a record ``{kind, shape, dtype,
  group_size, bytes}`` (``shape``/``dtype`` of the result);
* ``collective_stats`` costs such records with the reference's byte
  convention and ring model on one link bandwidth:

    all-reduce          2 * B * (n-1)/n / bw
    all-gather          B_out * (n-1)/n / bw
    reduce-scatter      B_in  * (n-1)/n / bw    (B_in = B_out * n)
    all-to-all          B * (n-1)/n / bw
    collective-permute  B / bw

  n = the group's size. Eager torch has no while loops (the layers are a
  Python loop), so a record has multiplicity 1, except inside
  ``repeated(n)``: a recurrence's step traced once (``nn/scan.py``) stands
  for its ``n`` steps, and its records carry ``multiplicity`` n (its FLOPs
  and bytes count n times, ``op_cost.OpCounter``), the reference's
  while-loop trip count;
* ``track_memory`` follows the bytes the step allocates (each new storage
  from its first op to its release) and ``memory_summary`` reports them as
  the reference reports XLA's buffer assignment: argument, output, temp and
  alias bytes, where the in-place cache updates are the alias (an output
  that is an argument's storage) and the peak is argument + temp + output
  - alias.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2, "int32": 4,
    "uint32": 4, "int64": 8, "uint64": 8, "float16": 2, "bfloat16": 2,
    "float32": 4, "float64": 8, "complex64": 8, "complex128": 16,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def shape_bytes(shape, dtype, *, unknown: dict | None = None) -> int:
    """Bytes of a ``shape`` array of ``dtype`` (a torch dtype or its name).

    A dtype missing from ``_DTYPE_BYTES`` contributes zero bytes — it must
    degrade the estimate, not raise. Pass a dict as ``unknown`` to have
    its occurrences counted per name, so a caller can surface
    counted-but-uncosted collectives."""
    name = dtype_name(dtype)
    if name not in _DTYPE_BYTES:
        if unknown is not None:
            unknown[name] = unknown.get(name, 0) + 1
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[name]


def normalize_kind(kind: str) -> str:
    """The reference's spelling of a collective kind (``all_reduce`` and
    ``all-reduce`` are one kind)."""
    kind = kind.replace("_", "-")
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    return kind


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    count_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    seconds: float = 0.0
    # dtypes seen in collective records but missing from _DTYPE_BYTES:
    # counted but uncosted
    unknown_dtypes: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> dict:
        out = {
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
            "total_bytes": self.total_bytes,
            "seconds": self.seconds,
        }
        if self.unknown_dtypes:
            out["unknown_dtypes"] = dict(self.unknown_dtypes)
        return out


def payload_bytes(kind: str, out_bytes: int, n: int) -> int:
    """The bytes a ring moves for one collective whose result is
    ``out_bytes``: a reduce-scatter counts its input (n results)."""
    return out_bytes * n if normalize_kind(kind) == "reduce-scatter" \
        else out_bytes


def collective_stats(records, *, link_bw: float,
                     num_devices: int) -> CollectiveStats:
    """Cost ``records`` ({kind, shape, dtype, group_size[, multiplicity]},
    shape and dtype of the result; a missing group size is the whole
    mesh) with the ring model of the module docstring."""
    stats = CollectiveStats()
    for r in records:
        kind = normalize_kind(r["kind"])
        n = int(r.get("group_size") or num_devices)
        mult = int(r.get("multiplicity", 1))
        out_b = shape_bytes(r["shape"], r["dtype"],
                            unknown=stats.unknown_dtypes)
        frac = (n - 1) / n if n > 1 else 0.0
        b_eff = payload_bytes(kind, out_b, n)
        if kind == "all-reduce":
            t = 2 * b_eff * frac / link_bw
        elif kind == "collective-permute":
            t = b_eff / link_bw
        else:
            t = b_eff * frac / link_bw
        stats.bytes_by_kind[kind] += b_eff * mult
        stats.count_by_kind[kind] += max(mult, 1)
        stats.seconds += t * mult
    return stats


# ------------------------------------------------------ the device's ops ----
_PROPAGATING = [0]
_QUIET = {"users": 0, "patched": None}


@contextlib.contextmanager
def _quiet_propagation():
    """While DTensor infers an op's output metadata it runs the op on
    global-shape fake tensors; mark that span so the modes below skip it.
    DTensor's propagator is one object; its metadata method is wrapped
    while any mode of this module is active."""
    prop = DTensor._op_dispatcher.sharding_propagator
    if _QUIET["users"] == 0:
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(prop, n)), None)
        if name is None:
            raise RuntimeError("this torch's DTensor has no metadata "
                               "propagation method to mark")
        inner = getattr(prop, name)

        def marked(*args, **kwargs):
            _PROPAGATING[0] += 1
            try:
                return inner(*args, **kwargs)
            finally:
                _PROPAGATING[0] -= 1

        setattr(prop, name, marked)
        _QUIET["patched"] = name
    _QUIET["users"] += 1
    try:
        yield
    finally:
        _QUIET["users"] -= 1
        if _QUIET["users"] == 0:
            delattr(prop, _QUIET["patched"])


class LocalOps(TorchDispatchMode):
    """A mode that sees the local ops one device runs: DTensor ops are
    handed to DTensor (which dispatches its local ops and collectives back
    here), and DTensor's metadata inference is skipped. Subclasses
    implement ``on_op(func, args, kwargs, out)``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _PROPAGATING[0] and not isinstance(
                func, torch._ops.HigherOrderOperator):
            self.on_op(func, args, kwargs, out)
        return out

    def on_op(self, func, args, kwargs, out):
        raise NotImplementedError

    def __enter__(self):
        self._quiet = _quiet_propagation()
        self._quiet.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.__exit__(*exc)


_REPEAT = [1]


@contextlib.contextmanager
def repeated(n: int):
    """Inside, every op the counting modes see stands for ``n`` of it (times
    any enclosing repetition): one traced step of an ``n``-step loop.
    Memory is not multiplied: one step's temporaries are live at a time."""
    _REPEAT[0] *= n
    try:
        yield
    finally:
        _REPEAT[0] //= n


def repetition() -> int:
    """How many times each op seen now counts (``repeated``)."""
    return _REPEAT[0]


def _modes() -> list:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return _get_current_dispatch_mode_stack()


def counting() -> bool:
    """True while a mode of this module (or ``op_cost.OpCounter``) is
    watching the ops dispatched."""
    return any(isinstance(m, LocalOps) for m in _modes())


def memory_tracker():
    """The innermost active ``MemoryTracker``, or None."""
    return next((m for m in reversed(_modes())
                 if isinstance(m, MemoryTracker)), None)


# ------------------------------------------------------------ collectives ----
# op name -> kind; the legacy c10d ops are what torch.distributed's
# collectives dispatch, the functional ones what DTensor issues
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "all-gather", "broadcast_": "all-gather",
}


def _group_size(args, kwargs) -> int:
    """The size of the group a collective op names: a ProcessGroup object
    (c10d ops) or a group name (functional ops)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch._C._distributed_c10d.ProcessGroup):
            return a.size()
        if hasattr(a, "size") and type(a).__name__ == "ScriptObject":
            return a.size()
    name = args[-1] if args and isinstance(args[-1], str) else kwargs.get(
        "group_name")
    return _resolve_process_group(name).size()


def _result(func, args, out):
    """The tensor holding a collective's result: its output (functional
    ops), or the in-place buffer of a c10d op (all-gather: its output
    list concatenated)."""
    name = func._schema.name.split("::")[-1]
    if isinstance(out, torch.Tensor):
        return out.shape, out.dtype
    first = args[0]
    if name in ("allgather_",):                    # ([[outs]], [in], ...)
        outs = first[0]
        n = sum(o.shape[0] for o in outs)
        return (n,) + tuple(outs[0].shape[1:]), outs[0].dtype
    if isinstance(first, (list, tuple)):
        first = first[0]
    return first.shape, first.dtype


class CollectiveRecorder(LocalOps):
    """Logs every collective one device dispatches (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []

    def on_op(self, func, args, kwargs, out):
        ns = func.namespace
        if ns not in ("c10d", "_c10d_functional"):
            return
        kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
        if kind is None:
            return
        shape, dtype = _result(func, args, out)
        n = _group_size(args, kwargs)
        out_b = shape_bytes(shape, dtype)
        rec = {"kind": kind, "shape": list(shape),
               "dtype": dtype_name(dtype), "group_size": n,
               "bytes": payload_bytes(kind, out_b, n)}
        if repetition() != 1:
            rec["multiplicity"] = repetition()
        self.records.append(rec)


def record_collectives() -> CollectiveRecorder:
    """``with record_collectives() as rec: step()`` -> ``rec.records``."""
    return CollectiveRecorder()


# ----------------------------------------------------------------- memory ----
def _storages(tree) -> dict:
    """{storage id: (storage, nbytes)} of the distinct storages under
    ``tree`` (DTensors: their local shards)."""
    leaves, _ = tree_flatten(tree)
    out = {}
    for t in leaves:
        if isinstance(t, torch.nn.Module):
            out.update(_storages(list(t.parameters())))
            continue
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = (st, st.nbytes())
    return out


class MemoryTracker(LocalOps):
    """Follows the storages the step allocates: ``live`` bytes now and
    their ``peak``. The arguments' storages are known up front and are not
    counted as new."""

    def __init__(self, args):
        super().__init__()
        self.args = _storages(args)
        self.live = 0
        self.peak = 0
        self._seen: set = set(self.args)

    def _free(self, n):
        self.live -= n

    def on_op(self, func, args, kwargs, out):
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if id(st) in self._seen or getattr(st, "_step_new", False):
                continue
            n = st.nbytes()
            st._step_new = True
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)



def track_memory(args) -> MemoryTracker:
    """``with track_memory(args) as mem: out = step(*args)``, then
    ``memory_summary(mem, out)``."""
    return MemoryTracker(args)


def memory_summary(tracker: MemoryTracker, out) -> dict:
    """argument / output / temp / alias bytes of one traced step whose
    output is ``out``: an output on an argument's storage is the alias
    (an in-place cache update); temp is the step's peak of new bytes less
    its new outputs."""
    outs = _storages(out)
    arg_b = sum(n for _, n in tracker.args.values())
    out_b = sum(n for _, n in outs.values())
    alias_b = sum(n for k, (_, n) in outs.items() if k in tracker.args)
    return {"argument_bytes": int(arg_b), "output_bytes": int(out_b),
            "temp_bytes": int(max(tracker.peak - (out_b - alias_b), 0)),
            "alias_bytes": int(alias_b)}


def peak_bytes(mem: dict) -> int:
    """The step's peak live bytes: argument + temp + output - alias."""
    return (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)
            + mem.get("output_bytes", 0) - mem.get("alias_bytes", 0))
