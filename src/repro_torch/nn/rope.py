"""Rotary position embeddings: full, partial (rotary_dim < head_dim), and
chatglm-style "2d" interleaved-pair layout (reference ``nn/rope.py``)."""
from __future__ import annotations

import torch


def rope_freqs(rotary_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    if rotary_dim % 2:
        raise ValueError(f"rotary_dim must be even, got {rotary_dim}")
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return 1.0 / (theta ** exponent)  # (rotary_dim//2,)


def apply_rope(x, positions, *, rotary_dim=None, theta=10000.0,
               interleaved=False):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    rotary_dim: rotate only the first rotary_dim dims. interleaved=True
    pairs (0,1),(2,3)...; False pairs (i, i+rot/2) (half-split layout).
    """
    head_dim = x.shape[-1]
    rot = head_dim if rotary_dim is None else rotary_dim
    inv_freq = rope_freqs(rot, theta, device=x.device)
    ang = positions[..., None].float() * inv_freq        # (..., seq, rot//2)
    cos = torch.cos(ang)[..., None, :]                   # broadcast heads
    sin = torch.sin(ang)[..., None, :]

    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if interleaved:
        x1 = x_rot[..., 0::2]
        x2 = x_rot[..., 1::2]
    else:
        x1 = x_rot[..., : rot // 2]
        x2 = x_rot[..., rot // 2:]
    x1 = x1.float()
    x2 = x2.float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    if interleaved:
        out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    else:
        out = torch.cat([r1, r2], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < head_dim else out
