"""Core layers: linear, head projections, norms, embedding.

Plain tensor functions with the reference's numerics (``nn/layers.py``),
plus the ``nn.Module``s that hold their fp32 parameters under the
reference's parameter names (``w``, ``b``, ``scale``, ``bias``, ``table``),
so the weight bridge maps one pytree leaf onto one parameter.

The reference casts every fp32 weight to the compute dtype on each call.
``cast`` does that cast once and keeps the copy on the parameter: the cast
is deterministic, so the result is the same, and a bf16 serving step does
not re-read the fp32 weights. While autograd records (training), a
parameter that requires grad is cast afresh, so its gradient flows.
Parameters are made with ``requires_grad=False``; the trainer turns it on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding as SH


def cast(p: torch.Tensor | None, dtype: torch.dtype):
    """``p`` in ``dtype``. The converted copy is kept on the parameter and
    refreshed whenever the parameter is written in place or moved (keyed by
    its version counter and storage pointer). Write parameters through the
    tensor itself (``load_state_dict``, or ``p.copy_`` under ``no_grad``):
    a write through ``p.data`` bumps another version counter and is not
    seen. Under grad mode a parameter that requires grad gets the
    differentiable ``p.to(dtype)`` instead, and nothing is kept; so does a
    DTensor or fake parameter (the dry run's, ``launch/specs.py``)."""
    if p is None or p.dtype == dtype:
        return p
    if (p.requires_grad and torch.is_grad_enabled()
            or isinstance(p, DTensor) or is_fake(p)):
        return p.to(dtype)          # no storage of its own to key a copy on
    key = (dtype, p._version, p.data_ptr())
    cached = getattr(p, "_cast_copy", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(dtype))
        p._cast_copy = cached
    return cached[1]


def param(*shape, axes: str, fp32: bool = False, device=None):
    """A zero fp32 parameter of ``shape`` (``()`` for a scalar), made with
    ``requires_grad=False`` (serving); the trainer turns grads on.

    ``axes``: its logical axes, one comma-joined name per dimension ("" for
    an unnamed one; "" alone leaves every dimension unnamed), the
    reference's ``ctx.param`` axes without the leading
    ``layers`` of its stacked blocks; kept on the parameter as
    ``logical_axes`` (``models.transformer.lm_axes`` reads them).
    ``fp32``: the reference keeps this leaf in fp32 whatever
    ``cfg.param_dtype`` is (``keeps_fp32``; ``transformer.
    cast_param_dtype``)."""
    if axes and len(axes.split(",")) != len(shape):
        raise ValueError(f"axes {axes!r} do not name the {len(shape)} dims "
                         f"of {shape}")
    p = nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)
    p.logical_axes = axes
    p.keeps_fp32 = fp32
    return p


def normal_(p: torch.Tensor, std: float, generator: torch.Generator):
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * std)


def fan_in_normal_(p: torch.Tensor, generator: torch.Generator, *,
                   axis: int = 0, scale: float = 1.0):
    """The reference's ``fan_in_normal(scale, axis)``: std = scale /
    sqrt(fan_in), fan_in the product of the dims up to ``axis`` inclusive."""
    normal_(p, scale / math.sqrt(math.prod(p.shape[:axis + 1])), generator)


def zero_(p: torch.Tensor | None):
    if p is not None:
        with torch.no_grad():
            p.zero_()


# ---------------------------------------------------------------- linear ----
def linear(x, w, b=None, *, dtype=torch.bfloat16):
    y = x.to(dtype) @ cast(w, dtype)
    if b is not None:
        y = y + cast(b, dtype)
    return y


def heads_proj(x, w, b=None, *, dtype=torch.bfloat16):
    """(..., d) @ (d, heads, head_dim) -> (..., heads, head_dim). Under a
    mesh, where the rules split neither the heads nor the head_dim of
    ``w`` (a head count the axis does not divide), each device multiplies
    its rows by the whole weight (``sharding.rows_times``), so the head
    view splits no sharded dimension."""
    d, h, k = w.shape
    x, w2 = x.to(dtype), cast(w, dtype).reshape(d, h * k)
    y = (SH.rows_times(x, w2) if SH.takes_rows_times(x, w, (1, 2))
         else x @ w2).unflatten(-1, (h, k))
    if b is not None:
        y = y + cast(b, dtype)
    return y


def heads_out(x, w, *, dtype=torch.bfloat16):
    """(..., heads, head_dim) @ (heads, head_dim, d) -> (..., d)."""
    h, k, d = w.shape
    return x.to(dtype).flatten(-2) @ cast(w, dtype).reshape(h * k, d)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, axes: tuple,
                 bias: bool = False, device=None):
        super().__init__()
        self.w = param(d_in, d_out, axes=",".join(axes), device=device)
        self.b = (param(d_out, axes=axes[1], device=device) if bias
                  else None)

    def reset_parameters(self, generator: torch.Generator, scale=1.0):
        normal_(self.w, scale / math.sqrt(self.w.shape[0]), generator)
        zero_(self.b)

    def forward(self, x, dtype=torch.bfloat16):
        return linear(x, self.w, self.b, dtype=dtype)


class HeadsProj(nn.Module):
    """(d_model) -> (heads, head_dim) projection, weight (d, H, dk)."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *,
                 head_axis: str = "heads", bias: bool = False, device=None):
        super().__init__()
        self.w = param(d_model, n_heads, head_dim,
                       axes=f"embed,{head_axis},", device=device)
        self.b = (param(n_heads, head_dim, axes=f"{head_axis},",
                        device=device) if bias else None)

    def reset_parameters(self, generator: torch.Generator, scale=1.0):
        normal_(self.w, scale / math.sqrt(self.w.shape[0]), generator)
        zero_(self.b)

    def forward(self, x, dtype=torch.bfloat16):
        return heads_proj(x, self.w, self.b, dtype=dtype)


class HeadsOut(nn.Module):
    """(heads, head_dim) -> (d_model) projection, weight (H, dk, d)."""

    def __init__(self, n_heads: int, head_dim: int, d_model: int, *,
                 device=None):
        super().__init__()
        self.w = param(n_heads, head_dim, d_model, axes="heads,,embed",
                       device=device)

    def reset_parameters(self, generator: torch.Generator, scale=1.0):
        # fan-in over (heads, head_dim), as the reference's fan_in_normal
        # with axis=1
        fan_in = self.w.shape[0] * self.w.shape[1]
        normal_(self.w, scale / math.sqrt(fan_in), generator)

    def forward(self, x, dtype=torch.bfloat16):
        return heads_out(x, self.w, dtype=dtype)


# ----------------------------------------------------------------- norms ----
def rmsnorm(x, scale, *, eps=1e-6, zero_centered=True):
    """RMSNorm; scale stored zero-centred (init 0 == gain 1)."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    g = scale.float()
    g = 1.0 + g if zero_centered else g
    return (x * g).to(dtype)


def layernorm(x, scale, bias, *, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dtype)


class Norm(nn.Module):
    """``rmsnorm`` (parameter ``scale``, init 0) or ``layernorm``
    (``scale`` init 1, ``bias`` init 0)."""

    def __init__(self, d: int, *, kind: str = "rmsnorm", device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.scale = param(d, axes="norm", device=device)
        self.bias = (param(d, axes="norm", device=device)
                     if kind == "layernorm" else None)

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.kind == "rmsnorm" else 1.0)
        zero_(self.bias)

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale)
        return layernorm(x, self.scale, self.bias)


# ------------------------------------------------------------- embedding ----
def embed(table, ids, *, dtype=torch.bfloat16):
    return F.embedding(ids, cast(_whole_rows(table), dtype))


def _whole_rows(table):
    """A DTensor table (the dry run's) with its embedding dimension
    gathered, as a sharded step all-gathers an FSDP weight before its use:
    DTensor's vocab-parallel lookup then masks the rows of this device's
    own ids. Anything else as it is."""
    if not isinstance(table, DTensor) or not any(
            isinstance(q, Shard) and q.dim == 1 for q in table.placements):
        return table
    return table.redistribute(table.device_mesh, [
        Replicate() if isinstance(q, Shard) and q.dim == 1 else q
        for q in table.placements])


def unembed(table, x, *, dtype=torch.bfloat16):
    """Tied LM head: x @ table.T -> logits over vocab."""
    return x.to(dtype) @ cast(table, dtype).T


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None):
        super().__init__()
        self.table = param(vocab, d, axes="vocab,embed", device=device)

    def reset_parameters(self, generator: torch.Generator):
        # 1/sqrt(d) keeps tied-unembed logits O(1) at init
        normal_(self.table, self.table.shape[1] ** -0.5, generator)
