"""The collectives of the port's device mesh, each call counted by kind.

Every collective of the port goes through a ``Comm``: one process
group, its size and this process's rank in it. ``COUNTS`` holds, per kind
(``all_reduce``, ``all_gather``, ``all_to_all``), the calls and the bytes
of their results on this rank (an all-gather's result is the gathered
tensor, an all-reduce's and an all-to-all's are the size of their input),
so a caller reads what a step exchanged: the engine per serving step,
``core/context_parallel`` per decode, the trainer per training step.
``CALLS`` logs every call (kind, result shape, dtype, bytes), which
``analysis/collective_contract`` holds to the sharded-serving contract; it
keeps the last ``LOG_LIMIT`` calls, so a server that never resets cannot
grow it without bound. ``reset_counts`` zeroes the totals and clears the
log.

The tensors stay on their device: on the card, NCCL takes them, and so
does gloo (its ``all_reduce``, ``all_gather`` and ``all_to_all_single``
take CUDA tensors in the installed build, which ``chip_smoke.py`` phase 17
runs), so ranks that share one card need no host staging.

``AttentionMesh`` is the handle the model threads to every attention
block under a serving mesh: the ``seq`` and ``model`` groups (None where
the axis has one rank), the rank's heads of the whole q/k/v projections
(``local_heads``) and the combine that ends each attention block
(``combine``).
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "all_to_all")
COUNTS: dict = {kind: {"calls": 0, "bytes": 0} for kind in KINDS}
LOG_LIMIT = 1 << 16
CALLS: collections.deque = collections.deque(maxlen=LOG_LIMIT)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts():
    for c in COUNTS.values():
        c["calls"] = c["bytes"] = 0
    CALLS.clear()


def counts() -> dict:
    """A copy of ``COUNTS``: {kind: {"calls": n, "bytes": b}}."""
    return {kind: dict(c) for kind, c in COUNTS.items()}


def calls() -> list:
    """A copy of the per-call log since ``reset_counts`` (its last
    ``LOG_LIMIT`` calls): [{"kind", "shape", "dtype", "bytes"}], in call
    order."""
    return [dict(c) for c in CALLS]


def _count(kind: str, result: torch.Tensor):
    nbytes = result.numel() * result.element_size()
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += nbytes
    CALLS.append({"kind": kind, "shape": list(result.shape),
                  "dtype": str(result.dtype).replace("torch.", ""),
                  "bytes": nbytes})


class Comm:
    """Counted collectives over ``group`` (None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise ``op`` ("sum" or "max") of ``t`` over the group,
        in place on a contiguous ``t``; returns the result."""
        t = t.contiguous()
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        _count("all_reduce", t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts, dim=dim)
        _count("all_gather", out)
        return out

    def _all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        _count("all_to_all", out)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Equal splits of ``t``'s leading axis exchanged: rank r's split j
        goes to rank j, as split r. Differentiable: the gradient takes the
        same exchange back."""
        return _AllToAll.apply(t, self)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm._all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_to_all(g), None


@dataclasses.dataclass(frozen=True)
class AttentionMesh:
    """The serving mesh as attention sees it: ``seq`` shards the KV pages,
    ``model`` the heads (None where the axis has one rank); ``heads`` is the
    rank's (first q head, q heads, first KV head, KV heads)."""
    model: Comm | None
    seq: Comm | None
    heads: tuple | None = None

    def local_heads(self, q, k, v):
        """The rank's heads of the whole projections' outputs (b, s, heads,
        dk), contiguous: the columns the single-device GEMM computes, with
        its bits (``distributed/serve_mesh``)."""
        if self.heads is None:
            return q, k, v
        q0, nq, k0, nkv = self.heads
        return (q.narrow(-2, q0, nq).contiguous(),
                k.narrow(-2, k0, nkv).contiguous(),
                v.narrow(-2, k0, nkv).contiguous())

    def combine(self, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A rank's attention output (b, s, H_local, dk) -> the full-head
        (b, s, H, dk) output in ``dtype``, the same on every rank.

        KV (``seq``) shards hold ConSmax partials over disjoint pages; they
        combine by one fp32 sum, with no running max and no denominator.
        Head (``model``) shards hold disjoint heads, which are concatenated.
        The cast to ``dtype`` comes between the two: the reference gathers
        fp32 and casts in the o-projection, and the cast commutes with the
        concatenation, so the bits are the same and the gather moves half
        the bytes at bf16."""
        if self.seq is not None:
            out = self.seq.all_reduce(out.float())
        out = out.to(dtype)
        if self.model is not None:
            out = self.model.all_gather(out, dim=-2)
        return out
