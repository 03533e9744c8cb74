"""Modality frontends — the reference's ``models/frontends.py``. The token
frontend embeds ids; the vlm (``"patches"``) and audio (``"frames"``)
frontends are stubs, as in the reference: the caller passes precomputed
patch / frame embeddings at ``d_model`` and the backbone consumes them.
Then ``embed_scale`` and, for archs without RoPE (gpt2-consmax,
musicgen), sinusoidal absolute positions."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import layers as L


def sinusoidal_pos(positions, d: int):
    """positions: (..., s) int -> (..., s, d) fp32 sinusoidal encoding."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def frontend_apply(embedding: L.Embedding, cfg: ModelConfig, *,
                   tokens=None, embeds=None, positions=None):
    """Returns the (b, s, d) input stream for the backbone: ``tokens``
    (b, s) ids for the token frontend, ``embeds`` (b, s, d) otherwise."""
    cdt = cfg.cdtype()
    if cfg.frontend == "tokens":
        x = L.embed(embedding.table, tokens, dtype=cdt)
    else:
        x = embeds.to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    if cfg.sinusoidal_pos and positions is not None:
        x = x + sinusoidal_pos(positions, cfg.d_model).to(cdt)
    return x
