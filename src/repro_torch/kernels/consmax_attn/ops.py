"""Public wrapper of the full-sequence ConSmax attention kernel.

Takes the model layout — q ``(b, sq, nh, d)``, k/v ``(b, skv, nkv, d)`` —
and dispatches by the tensors' device: on the CPU it computes the plain
version (``ref.consmax_attention_ref``, in the kernel layout behind a
transpose); on a CUDA device it launches the kernel in
``csrc/consmax_attn.cu`` (built at first use, see ``kernels/_build.py``),
which reads the model layout as stored, or raises. There is no fallback
from one to the other.

``consmax_attention_op.launches`` counts kernel launches (CUDA only).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref


@functools.cache
def _lib():
    lib = _build.load("consmax_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.consmax_attn_launch.argtypes = [p] * 6 + [i] * 8 + [f, f, i, p]
    lib.consmax_attn_launch.restype = i
    return lib


def consmax_attention_cuda(q, k, v, beta, gamma, *, causal=True, window=0,
                           softcap=0.0, merged=False, scale=None):
    """Launch the CUDA kernel. q (b, sq, H, dk) bf16; k, v (b, skv, hkv,
    dk) bf16; beta/gamma (H,) fp32. Returns (b, sq, H, dk) bf16."""
    b, sq, H, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    beta = beta.float().contiguous()
    gamma = gamma.float().contiguous()
    _build.check_sequence_operands("consmax_attention", q, k, v,
                                   heads={"beta": beta, "gamma": gamma})
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.consmax_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), beta.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), b, sq, skv, H, hkv, dk,
        int(causal), window, softcap, scale, int(merged),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "consmax_attention")
    consmax_attention_op.launches += 1
    return out


def consmax_attention_op(q, k, v, beta, gamma, *, causal=True, window=0,
                         softcap=0.0, merged=False, scale=None):
    """q: (b, sq, nh, d); k, v: (b, skv, nkv, d) — model layout; beta/gamma:
    (nh,) fp32. Returns (b, sq, nh, d) in q.dtype.

    Causal masking is top-left aligned (query i sees keys <= i, also when
    skv > sq); without it every query sees all skv keys. ``scale=None``
    applies 1/sqrt(d); ``merged`` picks Eq. 3 (C * exp(s)) over Eq. 2. The
    reference's ``bq``/``bk`` are TPU tile sizes and are not taken: the
    CUDA kernel picks its own tiles (64 folded query rows per block, 64 KV
    rows per tile, 32 at d = 256)."""
    if q.device.type == "cpu":
        out = consmax_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), beta,
            gamma, causal=causal, window=window, softcap=softcap,
            merged=merged, scale=scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_attention: no kernel for device {q.device}")
    return consmax_attention_cuda(q, k, v, beta, gamma, causal=causal,
                                  window=window, softcap=softcap,
                                  merged=merged, scale=scale)


consmax_attention_op.launches = 0
