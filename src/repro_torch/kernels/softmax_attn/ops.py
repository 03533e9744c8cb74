"""Public wrapper of the online-softmax attention kernel, the baseline the
paper compares ConSmax against.

Takes the model layout — q ``(b, sq, nh, d)``, k/v ``(b, skv, nkv, d)`` —
and dispatches by the tensors' device: on the CPU it computes the plain
version (``ref.softmax_attention_ref``); on a CUDA device it launches the
hand-written kernel in ``csrc/softmax_attn.cu`` (built at first use, see
``kernels/_build.py``) or raises. There is no fallback, and no library
attention call: the comparison with ``consmax_attn`` stays like for like.

``softmax_attention_op.launches`` counts kernel launches (CUDA only): the
kernel adds one to the wrapper's device counter (``_build.counted``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref


@functools.cache
def _lib():
    lib = _build.load("softmax_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for entry in (lib.softmax_attn_launch, lib.softmax_attn_f32_launch):
        entry.argtypes = [p] * 4 + [i] * 8 + [f, f, p, p]
        entry.restype = i
    return lib


def attention_plan(q, k, v):
    """Check the operands and plan the launch, as
    ``consmax_attn.ops.attention_plan`` does."""
    b, sq, H, dk = q.shape
    _build.check_sequence_operands("softmax_attention", q, k, v, heads={})
    if q.dtype == torch.float32:
        return LP.f32_plan("softmax_attention", b=b, sq=sq, H=H,
                           hkv=k.shape[2], dk=dk,
                           out_shape=q.shape)
    return LP.walk_plan("softmax_attention", b=b, c=sq, H=H, hkv=k.shape[2],
                        dk=dk, kv_dtype=k.dtype,
                        out_shape=q.shape, out_dtype=q.dtype)


def softmax_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0,
                           scale=None):
    """Launch the CUDA kernel. q (b, sq, H, dk), k, v (b, skv, hkv, dk),
    all bf16 (the wgmma mainloop) or all fp32 (the 3xTF32 kernel).
    Returns (b, sq, H, dk) in q's dtype."""
    b, sq, H, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    attention_plan(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    entry = (lib.softmax_attn_f32_launch if q.dtype == torch.float32
             else lib.softmax_attn_launch)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        H, hkv, dk, int(causal), window, softcap, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
        _build.launch_counter("softmax_attention", q.device))
    _build.check(lib, err, "softmax_attention")
    return out


@_build.counted("softmax_attention")
def softmax_attention_op(q, k, v, *, causal=True, window=0, softcap=0.0,
                         scale=None):
    """q: (b, sq, nh, d); k, v: (b, skv, nkv, d) — model layout. Returns
    (b, sq, nh, d) in q.dtype. Masking and ``scale`` as
    ``consmax_attention_op``; the reference's ``bq``/``bk`` TPU tile sizes
    are not taken (the CUDA kernel picks its own tiles)."""
    if LP.capturing():
        return LP.record(attention_plan(q, k, v), dict(q=q, k=k, v=v),
                         q.device)
    if q.device.type == "cpu":
        out = softmax_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=softcap, scale=scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"softmax_attention: no kernel for device {q.device}")
    return softmax_attention_cuda(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
