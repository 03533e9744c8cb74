"""AdamW with the reference's exact formula (``optim/adamw.py``): fp32
moments whatever the parameter dtype, global-norm gradient clipping,
decoupled weight decay, and the warmup-cosine schedule.

Not ``torch.optim.AdamW``, which places ``eps`` and the decay elsewhere:
here ``step = (m / bc1) / (sqrt(v / bc2) + 1e-8) + wd * p`` and
``p <- p - lr * step``.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``LM.named_parameters()``); the update writes parameters and
moments in place. Under FSDP (``train/step.py`` with a mesh) parameters
and moments are DTensors holding this rank's shard: the update runs on the
local shards, elementwise, and the one cross-rank quantity, the global
gradient norm, sums its squares over ``comm``'s group.

The decay mask follows the reference's *behaviour*, not its docstring. The
reference decays a leaf when its ``ndim >= 2``, and its block leaves are
stacked on a leading ``n_super`` axis, so every block leaf (norm scales,
biases, ConSmax beta/gamma included) is decayed and only the top-level 1-D
leaves (``final_norm``) are not. The port's ``LM`` keeps one module per
super-layer, so ``decayed`` adds that axis back before the test.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TrainConfig
from repro_torch.weights import ref_leaf


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (under ``no_grad``: the shard's own
    storage, so in-place writes reach the DTensor), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def warmup_cosine(tcfg: TrainConfig) -> Callable:
    """``lr(step)``: a 0-d fp32 tensor, the reference's fp32 ops in its
    order."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = tcfg.lr * step / max(tcfg.warmup_steps, 1)
        t = (step - tcfg.warmup_steps) / max(
            tcfg.total_steps - tcfg.warmup_steps, 1)
        t = t.clamp(0.0, 1.0)
        cos = 0.5 * tcfg.lr * (1 + torch.cos(math.pi * t))
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays this parameter: its leaf there has
    ``ndim >= 2``, counting the stacked ``n_super`` axis of a block leaf."""
    return p.ndim + (ref_leaf(name) != name) >= 2


def adam_init(params: dict) -> dict:
    """fp32 zero moments shaped (and, for DTensors, sharded) like each
    parameter."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32).detach()
    device = local(next(iter(params.values()))).device
    return {"m": {k: zeros32(p) for k, p in params.items()},
            "v": {k: zeros32(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads: dict, comm=None) -> torch.Tensor:
    """The L2 norm of all gradients; with ``comm``, of the shards every
    rank of its group holds."""
    if comm is None and any(isinstance(g, DTensor) for g in grads.values()):
        # DTensor gradients of no FSDP group (the dry run's): the global
        # sum as DTensor reduces it, returned whole on every device
        sq = sum(g.float().square().sum() for g in grads.values())
        return torch.sqrt(sq.full_tensor())
    sq = sum(local(g).float().square().sum() for g in grads.values())
    if comm is not None:
        sq = comm.all_reduce(sq.reshape(1))[0]
    return torch.sqrt(sq)


@torch.no_grad()
def adam_update(grads: dict, opt: dict, params: dict, *, lr,
                tcfg: TrainConfig, comm=None) -> dict:
    """One AdamW step in place on ``params`` and ``opt``; ``lr`` a 0-d
    fp32 tensor (``warmup_cosine``). ``comm``: the group whose ranks hold
    the other shards of sharded (FSDP) state. Returns ``{"grad_norm":
    gnorm}``."""
    gnorm = global_norm(grads, comm)
    scale = (torch.clamp(tcfg.grad_clip / gnorm.clamp(min=1e-9), max=1.0)
             if tcfg.grad_clip > 0 else torch.ones_like(gnorm))
    opt["count"] += 1
    count = opt["count"].float()
    b1, b2 = tcfg.b1, tcfg.b2
    bc1 = 1 - b1 ** count
    bc2 = 1 - b2 ** count
    for name, p in params.items():
        g = local(grads[name]).float() * scale
        p = local(p)
        m = local(opt["m"][name]).mul_(b1).add_((1 - b1) * g)
        v = local(opt["v"][name]).mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        if tcfg.weight_decay > 0 and decayed(name, p):
            step = step + tcfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return {"grad_norm": gnorm}
