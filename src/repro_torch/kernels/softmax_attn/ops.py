"""Public wrapper of the online-softmax attention kernel, the baseline the
paper compares ConSmax against.

Takes the model layout — q ``(b, sq, nh, d)``, k/v ``(b, skv, nkv, d)`` —
and dispatches by the tensors' device: on the CPU it computes the plain
version (``ref.softmax_attention_ref``); on a CUDA device it launches the
hand-written kernel in ``csrc/softmax_attn.cu`` (built at first use, see
``kernels/_build.py``) or raises. There is no fallback, and no library
attention call: the comparison with ``consmax_attn`` stays like for like.

``softmax_attention_op.launches`` counts kernel launches (CUDA only).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref


@functools.cache
def _lib():
    lib = _build.load("softmax_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.softmax_attn_launch.argtypes = [p] * 4 + [i] * 8 + [f, f, p]
    lib.softmax_attn_launch.restype = i
    return lib


def softmax_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0,
                           scale=None):
    """Launch the CUDA kernel. q (b, sq, H, dk) bf16; k, v (b, skv, hkv,
    dk) bf16. Returns (b, sq, H, dk) bf16."""
    b, sq, H, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _build.check_sequence_operands("softmax_attention", q, k, v, heads={})
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.softmax_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        H, hkv, dk, int(causal), window, softcap, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "softmax_attention")
    softmax_attention_op.launches += 1
    return out


def softmax_attention_op(q, k, v, *, causal=True, window=0, softcap=0.0,
                         scale=None):
    """q: (b, sq, nh, d); k, v: (b, skv, nkv, d) — model layout. Returns
    (b, sq, nh, d) in q.dtype. Masking and ``scale`` as
    ``consmax_attention_op``; the reference's ``bq``/``bk`` TPU tile sizes
    are not taken (the CUDA kernel picks its own tiles)."""
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


softmax_attention_op.launches = 0
