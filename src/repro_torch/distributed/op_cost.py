"""FLOP, transcendental and byte counts of one eager step — the counterpart
of the reference's ``distributed/hlo_cost.py``.

The reference walks the compiled HLO of one device. The port counts the
local aten ops one device dispatches while the step runs
(``op_analysis.LocalOps``: under DTensor, the shard's ops):

* flops — matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  fused attention) by ``torch.utils.flop_counter``'s formulas (2·M·N·K for
  a product); every other arithmetic op 1 per output element: pointwise
  ops, dtype conversions and reductions (their output elements), as the
  reference counts elementwise, ``convert`` and ``reduce``;
* transcendentals — exp, exp2, expm1, tanh, log, rsqrt, sqrt, sigmoid,
  erf, sin, cos, silu, gelu, softplus, ... per output element, each also
  one FLOP, as in the reference;
* bytes — every op's inputs plus outputs (each tensor's own elements, not
  its storage's; a broadcast view at most its storage). Views (``_unsafe_view`` and ``as_strided`` too),
  allocations and bookkeeping move nothing. A gather
  (indexing, ``index_select``, ``gather``, ``embedding``) reads the rows
  it gathers, not its whole source: output twice plus the indices. An
  in-place update (``copy_`` into a slice, ``index_put_``) charges the
  slice it writes and its index, twice, not the whole buffer: the
  reference's dynamic-update-slice rule. An in-place op's output is its
  first input and is not counted twice.

Inside ``op_analysis.repeated(n)`` (one traced step of an ``n``-step
recurrence, ``nn/scan.py``) every count is multiplied by ``n``.

Eager PyTorch fuses nothing: every op reads its inputs from and writes its
outputs to device memory. So ``bytes`` is the traffic the port's eager
step issues, op by op, not the fused traffic the reference's XLA program
moves, and the same step's ``bytes`` is larger here than there.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.op_analysis import LocalOps, repetition

aten = torch.ops.aten

TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "exp2_", "expm1", "tanh", "tanh_", "log",
    "log_", "log1p", "log2", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sigmoid",
    "sigmoid_", "erf", "erf_", "sin", "cos", "silu", "silu_", "gelu",
    "softplus", "atan2", "pow", "logsumexp", "_softmax", "_log_softmax",
}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
              "all", "argmax", "argmin", "norm", "linalg_vector_norm",
              "cumsum", "var_mean", "var", "std", "logsumexp"}
GATHERS = {"index", "index_select", "gather", "embedding",
           "_unsafe_index"}
IN_PLACE_UPDATES = {"index_put_", "_index_put_impl_", "index_put",
                    "scatter_", "scatter", "index_copy_", "index_copy",
                    "masked_scatter_"}
NO_TRAFFIC = {"_unsafe_view", "_reshape_alias", "as_strided",
              "empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "lift_fresh", "lift_fresh_copy",
              "_local_scalar_dense", "device", "wait_tensor", "set_",
              "resize_", "detach", "detach_", "alias", "_to_copy_meta",
              "sym_size", "sym_stride", "sym_numel", "is_same_size",
              "_has_compatible_shallow_copy_type"}


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s elements, at most its storage's (a broadcast
    view reads each stored element once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    matmul_flops: float = 0.0

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals}


class OpCounter(LocalOps):
    """Counts the local ops of what runs inside it into ``cost`` (and
    ``matmul_by_op``: matmul FLOPs per op name)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.matmul_by_op: dict = {}

    def on_op(self, func, args, kwargs, out):
        name = func._schema.name.split("::")[-1]
        if (func.namespace not in ("aten", "prims") or func.is_view
                or name in NO_TRAFFIC):
            return
        c, k = self.cost, repetition()
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = k * float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            c.flops += f
            c.matmul_flops += f
            self.matmul_by_op[name] = self.matmul_by_op.get(name, 0.0) + f
        else:
            n_out = k * sum(t.numel() for t in outs)
            if name in TRANSCENDENTAL:
                c.transcendentals += n_out
                c.flops += n_out
            elif (torch.Tag.pointwise in func.tags or name in REDUCTIONS
                  or name in ("_to_copy", "to")
                  or (name == "copy_" and ins[0].dtype != ins[1].dtype)):
                c.flops += n_out
        if name in GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
            nb = 2 * sum(_nbytes(t) for t in outs) + idx
        elif name in IN_PLACE_UPDATES:
            nb = 2 * sum(_nbytes(t) for t in ins[1:])
        elif name == "copy_":
            nb = _nbytes(ins[0]) + _nbytes(ins[1])
        elif name.endswith("_") and ins:
            # in place: the output is the first input, read and written
            nb = sum(_nbytes(t) for t in ins) + _nbytes(ins[0])
        else:
            nb = (sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in outs))
        c.bytes += k * nb


def op_cost(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` and count the local ops it dispatches
    (see the module docstring)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost
