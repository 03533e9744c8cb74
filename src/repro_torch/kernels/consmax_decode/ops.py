"""Public wrapper of the split-KV ConSmax decode kernel.

Takes the model's serving layouts — q ``(b, 1, H, dk)``, cache k/v
``(b, L, hkv, dk)``, per-slot cache ``index`` ``(b,)`` — and dispatches by
the tensors' device: on the CPU it computes the plain version
(``ref.consmax_decode_ref``); on a CUDA device it launches the kernel in
``csrc/consmax_decode.cu`` (built at first use, see ``kernels/_build.py``)
or raises. There is no fallback from one to the other.

``consmax_decode_op.launches`` counts kernel launches (CUDA only).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref

MAX_BLOCK = 512          # keeps the kernel's shared memory under 48 KB


@functools.cache
def _lib():
    lib = _build.load("consmax_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.consmax_decode_launch.argtypes = [p] * 8 + [i] * 7 + [f, f, i, i, p]
    lib.consmax_decode_launch.restype = i
    return lib


def consmax_decode_cuda(q, k, v, lengths, beta, gamma, *, window=0,
                        softcap=0.0, merged=True, scale=None, bk=256,
                        fill_bound=True):
    """Launch the CUDA kernel. q (b, H, dk) bf16; k, v (b, L, hkv, dk) bf16;
    lengths (b,) int32 valid rows; beta/gamma (H,) fp32. Returns
    (b, H, dk) bf16."""
    b, H, dk = q.shape
    L, hkv = k.shape[1], k.shape[2]
    bk = min(bk, L)
    lengths = lengths.to(torch.int32).contiguous()
    beta = beta.float().contiguous()
    gamma = gamma.float().contiguous()
    _build.check_operands("consmax_decode", q, k, v,
                          slots={"lengths": lengths},
                          heads={"beta": beta, "gamma": gamma})
    if not 0 < bk <= MAX_BLOCK:
        raise ValueError(f"consmax_decode: bk {bk} not in (0, {MAX_BLOCK}]")
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ns = -(-L // bk)
    partials = torch.empty((b, hkv, ns, H // hkv, dk), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, H, dk), dtype=q.dtype, device=q.device)
    lib = _lib()
    err = lib.consmax_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        beta.data_ptr(), gamma.data_ptr(), partials.data_ptr(),
        out.data_ptr(), b, H, hkv, L, dk, bk, window, softcap, scale,
        int(merged), int(fill_bound),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "consmax_decode")
    consmax_decode_op.launches += 1
    return out


def consmax_decode_op(q, k, v, index, beta, gamma, *, window=0, softcap=0.0,
                      merged=True, scale=None, bk=256, fill_bound=True):
    """q: (b, 1, H, dk); k, v: (b, L, hkv, dk) — the cache after this
    step's K/V row was written at ``index``; index: (b,) current position
    (the valid-row count is ``index + 1``); beta/gamma: (H,) fp32.

    Returns (b, 1, H, dk) in q.dtype. ``scale=1.0`` when q is pre-scaled
    (the model path); None applies 1/sqrt(dk). ``bk`` is the kernel's KV
    shard and ``fill_bound`` skips shards past each slot's fill (both only
    shape the CUDA launch; the plain version computes the whole row)."""
    lengths = index + 1
    if q.device.type == "cpu":
        return consmax_decode_ref(q[:, 0], k, v, lengths, beta, gamma,
                                  window=window, softcap=softcap,
                                  merged=merged, scale=scale)[:, None]
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_decode: no kernel for device {q.device}")
    return consmax_decode_cuda(q[:, 0], k, v, lengths, beta, gamma,
                               window=window, softcap=softcap, merged=merged,
                               scale=scale, bk=bk,
                               fill_bound=fill_bound)[:, None]


consmax_decode_op.launches = 0
