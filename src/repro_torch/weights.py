"""Parameters of the port's ``LM``: the weight bridge from the reference's
parameter tree, and random weights with the reference's distributions.

The reference's ``lm_init`` returns nested dicts (``embed/table``,
``final_norm/scale``, ``blocks/b{j}/attn/q/w``, ...) whose ``blocks`` leaves
are stacked on a leading ``n_super`` axis (``nn/module.py`` ``vmap_init``).
``LM``'s parameter names are the same paths with the stack index spelled
out (``blocks.{i}.b{j}.attn.q.w``), so the bridge is a renaming plus a
split of the stacked leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LM


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def from_jax_params(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``T.lm_init`` pytree, converted to numpy (nested
    dicts of arrays), as the port's ``LM`` on ``device`` (default cuda).
    Every leaf must map onto exactly one parameter and vice versa."""
    device = resolve_device(device)
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)        # a writable copy
        if path.startswith("blocks."):
            if arr.shape[0] != cfg.n_super_layers:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} != "
                                 f"n_super {cfg.n_super_layers}")
            rest = path[len("blocks."):]
            for i in range(arr.shape[0]):
                state[f"blocks.{i}.{rest}"] = torch.from_numpy(arr[i])
        else:
            state[path] = torch.from_numpy(arr)
    model = LM(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights with the reference's distributions: fan-in normal
    projections, normal(d^-1/2) embedding, zero biases, norms at gain 1,
    beta ~ U[lo, hi], gamma = const. Drawn from ``generator`` (on its own
    device), stored on ``device`` (default cuda)."""
    device = resolve_device(device)
    model = LM(cfg, device=device)
    model.reset_parameters(generator)
    return model
