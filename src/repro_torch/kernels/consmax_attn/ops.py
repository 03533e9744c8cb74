"""Public wrapper of the full-sequence ConSmax attention kernel.

Takes the model layout — q ``(b, sq, nh, d)``, k/v ``(b, skv, nkv, d)`` —
and dispatches by the tensors' device: on the CPU it computes the plain
version (``ref.consmax_attention_ref``, in the kernel layout behind a
transpose); on a CUDA device it launches the kernel in
``csrc/consmax_attn.cu`` (built at first use, see ``kernels/_build.py``),
which reads the model layout as stored, or raises. There is no fallback
from one to the other. bf16 operands run the wgmma mainloop; fp32 operands
the plain SIMT kernel of ``csrc/attn_f32.cuh``.

``consmax_attention_op.launches`` counts kernel launches (CUDA only).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref


@functools.cache
def _lib():
    lib = _build.load("consmax_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for entry in (lib.consmax_attn_launch, lib.consmax_attn_f32_launch):
        entry.argtypes = [p] * 6 + [i] * 8 + [f, f, i, p]
        entry.restype = i
    return lib


def attention_plan(q, k, v, beta, gamma):
    """Check the operands and plan the launch: bf16 q / k / v on the wgmma
    mainloop, two consumer warpgroups at dk <= 128; fp32 on the SIMT kernel
    of ``csrc/attn_f32.cuh``. Returns the plan and the fp32 beta, gamma."""
    b, sq, H, dk = q.shape
    beta = beta.float().contiguous()
    gamma = gamma.float().contiguous()
    _build.check_sequence_operands("consmax_attention", q, k, v,
                                   heads={"beta": beta, "gamma": gamma})
    if q.dtype == torch.float32:
        plan = LP.f32_plan("consmax_attention", b=b, sq=sq, H=H, dk=dk,
                           out_shape=q.shape)
    else:
        plan = LP.walk_plan("consmax_attention", b=b, c=sq, H=H,
                            hkv=k.shape[2], dk=dk, kv_dtype=k.dtype,
                            wide=True, out_shape=q.shape, out_dtype=q.dtype)
    return plan, beta, gamma


def consmax_attention_cuda(q, k, v, beta, gamma, *, causal=True, window=0,
                           softcap=0.0, merged=False, scale=None):
    """Launch the CUDA kernel. q (b, sq, H, dk), k, v (b, skv, hkv, dk),
    all bf16 (the wgmma mainloop) or all fp32 (the fp32 SIMT kernel);
    beta/gamma (H,) fp32. Returns (b, sq, H, dk) in q's dtype."""
    b, sq, H, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _, beta, gamma = attention_plan(q, k, v, beta, gamma)
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    entry = (lib.consmax_attn_f32_launch if q.dtype == torch.float32
             else lib.consmax_attn_launch)
    err = entry(
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
    rows per tile, 32 at d = 256); fp32 operands take a plain SIMT kernel
    (fp32 products and exp, the reference's fp32 tolerance)."""
    if LP.capturing():
        plan, _, _ = attention_plan(q, k, v, beta, gamma)
        return LP.record(plan, dict(q=q, k=k, v=v), q.device)
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
