"""PyTorch/CUDA port of the ConSmax serving stack (``src/repro`` is the JAX
reference it is held against).

Same layout as the reference — ``configs/``, ``nn/``, ``core/``,
``kernels/<name>/``, ``models/``, ``serve/``, ``launch/`` — in PyTorch idiom:
``nn.Module``s holding fp32 parameters, plain tensor functions, explicit
devices and explicit ``torch.Generator``s. Nothing here imports ``jax`` or
the reference package.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(the CPU tests do); with no card and no explicit CPU request they raise.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card)
    unless the caller asks for another one. Never falls back to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
