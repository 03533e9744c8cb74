"""Parameters of the port's ``LM``: the weight bridge from the reference's
parameter tree, and random weights with the reference's distributions.

The reference's ``lm_init`` returns nested dicts (``embed/table``,
``final_norm/scale``, ``blocks/b{j}/attn/q/w``, ...) whose ``blocks`` leaves
are stacked on a leading ``n_super`` axis (``nn/module.py`` ``vmap_init``).
``LM``'s parameter names are the same paths with the stack index spelled
out (``blocks.{i}.b{j}.attn.q.w``), so the bridge is a renaming plus a
split of the stacked leaves (``from_jax_params``), or a renaming plus a
restack (``to_jax_params``, for checkpoints the reference can read).
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


def ref_leaf(name: str) -> str:
    """The reference leaf that holds parameter ``name``: every
    ``blocks.{i}.rest`` is one slice of the stacked ``blocks.rest``."""
    if name.startswith("blocks."):
        return "blocks." + name[len("blocks."):].split(".", 1)[1]
    return name


def split_jax_tree(tree: dict, cfg: ModelConfig) -> dict:
    """A parameter-shaped reference tree (parameters, or an optimizer
    moment), nested dicts of arrays, as ``{LM parameter name: fp32 CPU
    tensor}``: the ``blocks`` leaves split along their ``n_super`` axis."""
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)        # a writable copy
        if path.startswith("blocks."):
            if arr.shape[0] != cfg.n_super_layers:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} != "
                                 f"n_super {cfg.n_super_layers}")
            rest = path[len("blocks."):]
            for i in range(arr.shape[0]):
                # a slice, not arr[i], which is a numpy scalar for the
                # stacked 0-d leaves (the MoE router's beta / gamma)
                one = arr[i:i + 1].reshape(arr.shape[1:])
                state[f"blocks.{i}.{rest}"] = torch.from_numpy(one)
        else:
            state[path] = torch.from_numpy(arr)
    return state


def from_jax_params(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``T.lm_init`` pytree, converted to numpy (nested
    dicts of arrays), as the port's ``LM`` on ``device`` (default cuda).
    Every leaf must map onto exactly one parameter and vice versa."""
    device = resolve_device(device)
    model = LM(cfg, device=device)
    model.load_state_dict(split_jax_tree(tree, cfg), strict=True)
    return model


def to_jax_params(named, cfg: ModelConfig) -> dict:
    """The inverse of ``split_jax_tree``: an ``LM`` (its parameters) or a
    ``{parameter name: tensor}`` dict of the same names (an optimizer
    moment) as the reference's nested tree of numpy arrays, the
    ``blocks.{i}.*`` leaves restacked on the leading ``n_super`` axis.
    Every array is a host copy."""
    if isinstance(named, LM):
        named = dict(named.named_parameters())
    flat, stacks = {}, {}
    for name, t in named.items():
        arr = t.detach().to("cpu", copy=True).numpy()
        if name.startswith("blocks."):
            i, rest = name[len("blocks."):].split(".", 1)
            stacks.setdefault(rest, {})[int(i)] = arr
        else:
            flat[name] = arr
    for rest, per_layer in stacks.items():
        if sorted(per_layer) != list(range(cfg.n_super_layers)):
            raise ValueError(f"blocks.*.{rest}: super-layers "
                             f"{sorted(per_layer)} of {cfg.n_super_layers}")
        flat[f"blocks.{rest}"] = np.stack(
            [per_layer[i] for i in range(cfg.n_super_layers)])
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


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
