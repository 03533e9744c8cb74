"""What training and serving read of the reference's
``distributed/sharding.py``, over ``torch.distributed``.

* ``dp_axes``: the data-parallel axes of a mesh (``pod``, ``data``);
* ``shards_params`` / ``shard_model``: the FSDP choice of the reference's
  ``make_rules`` (``fsdp=True`` / ``"full"``: parameters and optimizer
  state sharded over the data axes; ``False`` / ``"zero1"``: parameters
  replicated), turned into the modules FSDP2's ``fully_shard`` wraps: each
  block, then the root (embedding and final norm). The reference shards
  each leaf over ``data``; FSDP2 shards every parameter of a unit along
  its first axis, and a block is the unit whose parameters one forward
  step needs together;
* ``expert_parallel`` / ``ep_info``: the expert-parallel context. Inside
  ``expert_parallel(comm)``, ``ep_info()`` returns the group's ``Comm``
  and the MoE blocks take ``models/moe_ep``'s all-to-all dispatch where
  the group size divides the expert count (``models/blocks._moe_apply``);
  outside it, None. The reference reads the same from its rules'
  ``"experts"`` entry.

The rule resolver of ``launch/dryrun.py`` / ``launch/specs.py`` (logical
axes to ``PartitionSpec``s, activation constraints) waits for the slice
that ports those.
"""
from __future__ import annotations

import contextlib
import contextvars

from torch.distributed.fsdp import fully_shard

from repro_torch.distributed.comm import Comm

_EP: contextvars.ContextVar = contextvars.ContextVar("expert_parallel",
                                                     default=None)


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names of ``mesh`` (a DeviceMesh)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def shards_params(fsdp) -> bool:
    """The reference's ``make_rules`` reading of ``TrainConfig.fsdp``:
    True / "full" shard the parameters over the data axes; False /
    "zero1" keep them replicated."""
    if fsdp not in (True, False, "full", "zero1"):
        raise ValueError(f"fsdp must be True, False, 'full' or 'zero1', got "
                         f"{fsdp!r}")
    return fsdp in (True, "full")


def shard_model(model, mesh):
    """``fully_shard`` the units of ``model`` over the data axis of
    ``mesh``, in place, innermost first: every block of every super-layer,
    then the model itself (its embedding and final norm). Returns the
    model, its parameters now DTensors holding this rank's first-axis
    shard."""
    axes = dp_axes(mesh)
    if len(axes) != 1:
        raise ValueError(f"FSDP over one data axis; mesh has {axes}")
    data = mesh[axes[0]]
    for unit in [blk for sup in model.blocks for blk in sup.values()]:
        fully_shard(unit, mesh=data)
    fully_shard(model, mesh=data)
    return model


@contextlib.contextmanager
def expert_parallel(comm: Comm):
    """Run the MoE blocks expert-parallel over ``comm``'s group inside."""
    tok = _EP.set(comm)
    try:
        yield
    finally:
        _EP.reset(tok)


def ep_info():
    """The expert-parallel group's ``Comm`` inside ``expert_parallel``,
    else None."""
    return _EP.get()
