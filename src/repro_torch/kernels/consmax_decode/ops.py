"""Public wrappers of the split-KV ConSmax decode kernels.

Take the model's serving layouts — q ``(b, 1, H, dk)``, cache k/v
``(b, L, hkv, dk)`` and per-slot cache ``index`` ``(b,)``, or the shared
``(P, ps, hkv, dk)`` page pools with a ``(b, npg)`` page table and per-slot
``lengths`` — and dispatch by the tensors' device: on the CPU they compute
the plain versions (``ref.consmax_decode_ref`` / ``consmax_decode_paged_ref``);
on a CUDA device they launch the kernel in ``csrc/consmax_decode.cu`` (built
at first use, see ``kernels/_build.py``) or raise. There is no fallback from
one to the other. A quantized (int8 / fp8_e4m3) cache comes with its fp32
``k_scale``/``v_scale`` (``(b, L, hkv)``, or ``(P, ps, hkv)`` pools), and
both paths dequantize it block by block as they read it; a quantized cache
without scales, or a bf16 cache with them, raises.

``consmax_decode_op.launches`` and ``consmax_decode_paged_op.launches``
count kernel launches (CUDA only), each its own entry point.

The kernel sums its shards' partials itself: the last shard of each (slot,
KV head) to finish, found by an integer ticket, adds them in shard order.
The tickets live in one zeroed int32 buffer per (device, stream)
(``_tickets``), which every launch leaves zero again, so launches on one
stream (and a CUDA graph captured on its own stream) may reuse it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consmax_decode.ref import (consmax_decode_paged_ref,
                                                   consmax_decode_ref)

# The largest KV shard (kMaxBlock in the kernel): a paged CTA keeps its
# shard's page-table entries, bk + 1 at most, in shared memory beside its
# tiles (the tiles themselves do not grow with bk).
MAX_BLOCK = 512


@functools.cache
def _lib():
    lib = _build.load("consmax_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.consmax_decode_launch.argtypes = ([p] * 10 + [i] * 7
                                          + [f, f, i, i, i, p, p])
    lib.consmax_decode_launch.restype = i
    lib.consmax_decode_paged_launch.argtypes = ([p] * 11 + [i] * 8
                                                + [f, f, i, i, i, p, p])
    lib.consmax_decode_paged_launch.restype = i
    lib.consmax_decode_smem_bytes.argtypes = [i] * 4
    lib.consmax_decode_smem_bytes.restype = i
    return lib


_TICKETS = {}


def _tickets(device, stream, n):
    """The zeroed int32 ticket buffer of ``stream`` on ``device``, with at
    least ``n`` entries (one per slot and KV head); kernels leave it
    zero."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=device)
    return t


def _check_smem(lib, kernel, dk, kv_type, paged, bk):
    """Raise before a launch the card would refuse for its shared memory
    (the library's own byte count for this head_dim, cache type, row
    address and shard size)."""
    need = lib.consmax_decode_smem_bytes(dk, kv_type, int(paged), bk)
    if not 0 < need <= _build.SMEM_PER_BLOCK:
        raise ValueError(f"{kernel}: {need} B of shared memory at dk {dk}, "
                         f"bk {bk}; a block may use {_build.SMEM_PER_BLOCK}")


def _operands(kernel, q, k, v, lengths, beta, gamma, L, hkv, bk, scale,
              page_table=None, k_scale=None, v_scale=None):
    """Checked operands, the cache's kv_type code, the shard size, the
    scale and the scratch and output tensors of one launch over ``L``
    logical rows per slot."""
    b, H, dk = q.shape
    bk = min(bk, L)
    lengths = lengths.to(torch.int32).contiguous()
    beta = beta.float().contiguous()
    gamma = gamma.float().contiguous()
    kv_type = _build.check_operands(
        kernel, q, k, v, slots={"lengths": lengths},
        heads={"beta": beta, "gamma": gamma}, page_table=page_table,
        k_scale=k_scale, v_scale=v_scale)
    if not 0 < bk <= MAX_BLOCK:
        raise ValueError(f"{kernel}: bk {bk} not in (0, {MAX_BLOCK}]")
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ns = -(-L // bk)
    partials = torch.empty((b, hkv, ns, H // hkv, dk), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, H, dk), dtype=q.dtype, device=q.device)
    return kv_type, lengths, beta, gamma, bk, scale, partials, out


def consmax_decode_cuda(q, k, v, lengths, beta, gamma, *, window=0,
                        softcap=0.0, merged=True, scale=None, bk=256,
                        fill_bound=True, k_scale=None, v_scale=None):
    """Launch the CUDA kernel. q (b, H, dk) bf16; k, v (b, L, hkv, dk) bf16,
    or int8 / fp8_e4m3 with k_scale, v_scale (b, L, hkv) fp32; lengths (b,)
    int32 valid rows; beta/gamma (H,) fp32. Returns (b, H, dk) bf16."""
    b, H, dk = q.shape
    L, hkv = k.shape[1], k.shape[2]
    kv_type, lengths, beta, gamma, bk, scale, partials, out = _operands(
        "consmax_decode", q, k, v, lengths, beta, gamma, L, hkv, bk, scale,
        k_scale=k_scale, v_scale=v_scale)
    lib = _lib()
    _check_smem(lib, "consmax_decode", dk, kv_type, False, bk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.consmax_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), lengths.data_ptr(), beta.data_ptr(),
        gamma.data_ptr(), partials.data_ptr(), out.data_ptr(), b, H, hkv, L,
        dk, bk, window, softcap, scale, int(merged), int(fill_bound),
        kv_type, stream, _tickets(q.device, stream, b * hkv).data_ptr())
    _build.check(lib, err, "consmax_decode")
    consmax_decode_op.launches += 1
    return out


def consmax_decode_op(q, k, v, index, beta, gamma, *, window=0, softcap=0.0,
                      merged=True, scale=None, bk=256, fill_bound=True,
                      k_scale=None, v_scale=None):
    """q: (b, 1, H, dk); k, v: (b, L, hkv, dk) — the cache after this
    step's K/V row was written at ``index``; index: (b,) current position
    (the valid-row count is ``index + 1``); beta/gamma: (H,) fp32;
    k_scale, v_scale: (b, L, hkv) fp32 row scales of an int8 / fp8_e4m3
    cache (None for bf16).

    Returns (b, 1, H, dk) in q.dtype. ``scale=1.0`` when q is pre-scaled
    (the model path); None applies 1/sqrt(dk). ``bk`` is the kernel's KV
    shard and ``fill_bound`` skips shards past each slot's fill (both only
    shape the CUDA launch; the plain version computes the whole row)."""
    _build.check_kv_scales("consmax_decode", k, v, k_scale, v_scale)
    lengths = index + 1
    if q.device.type == "cpu":
        return consmax_decode_ref(q[:, 0], k, v, lengths, beta, gamma,
                                  window=window, softcap=softcap,
                                  merged=merged, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)[:, None]
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_decode: no kernel for device {q.device}")
    return consmax_decode_cuda(q[:, 0], k, v, lengths, beta, gamma,
                               window=window, softcap=softcap, merged=merged,
                               scale=scale, bk=bk, fill_bound=fill_bound,
                               k_scale=k_scale, v_scale=v_scale)[:, None]


consmax_decode_op.launches = 0


def consmax_decode_paged_cuda(q, kp, vp, page_table, lengths, beta, gamma, *,
                              window=0, softcap=0.0, merged=True, scale=None,
                              bk=256, fill_bound=True, k_scale=None,
                              v_scale=None):
    """Launch the paged CUDA kernel. q (b, H, dk) bf16; kp, vp (P, ps, hkv,
    dk) bf16 pools, or int8 / fp8_e4m3 with k_scale, v_scale (P, ps, hkv)
    fp32 scale pools; page_table (b, npg) int32 (-1 = unmapped); lengths
    (b,) int32 valid logical rows (0 allowed); beta/gamma (H,) fp32. The KV
    shards are ``bk`` logical rows, as in the contiguous kernel, for any
    page size. Returns (b, H, dk) bf16."""
    b, H, dk = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    npg = page_table.shape[1]
    kv_type, lengths, beta, gamma, bk, scale, partials, out = _operands(
        "consmax_decode_paged", q, kp, vp, lengths, beta, gamma, npg * ps,
        hkv, bk, scale, page_table=page_table, k_scale=k_scale,
        v_scale=v_scale)
    lib = _lib()
    _check_smem(lib, "consmax_decode_paged", dk, kv_type, True, bk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.consmax_decode_paged_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), page_table.data_ptr(), lengths.data_ptr(),
        beta.data_ptr(), gamma.data_ptr(), partials.data_ptr(),
        out.data_ptr(), b, H, hkv, npg, ps, dk, bk, window, softcap, scale,
        int(merged), int(fill_bound), kv_type, stream,
        _tickets(q.device, stream, b * hkv).data_ptr())
    _build.check(lib, err, "consmax_decode_paged")
    consmax_decode_paged_op.launches += 1
    return out


def consmax_decode_paged_op(q, kp, vp, page_table, lengths, beta, gamma, *,
                            window=0, softcap=0.0, merged=True, scale=None,
                            bk=256, fill_bound=True, k_scale=None,
                            v_scale=None):
    """Paged-pool variant, with the reference's signature. q: (b, 1, H, dk);
    kp, vp: shared (P, ps, hkv, dk) page pools after this step's K/V row
    was written; page_table: (b, npg) int32; lengths: (b,) valid logical
    rows (``index + active``: it already counts this step's row, and is 0
    for a free slot at index 0); k_scale, v_scale: (P, ps, hkv) fp32 scale
    pools of an int8 / fp8_e4m3 pool (None for bf16).

    Returns (b, 1, H, dk) in q.dtype. ``bk`` is the kernel's KV shard in
    logical rows and ``fill_bound`` skips shards past each slot's fill
    (both only shape the CUDA launch)."""
    _build.check_kv_scales("consmax_decode_paged", kp, vp, k_scale, v_scale)
    if q.device.type == "cpu":
        return consmax_decode_paged_ref(q[:, 0], kp, vp, page_table, lengths,
                                        beta, gamma, window=window,
                                        softcap=softcap, merged=merged,
                                        scale=scale, k_scale=k_scale,
                                        v_scale=v_scale)[:, None]
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_decode_paged: no kernel for device {q.device}")
    return consmax_decode_paged_cuda(q[:, 0], kp, vp, page_table, lengths,
                                     beta, gamma, window=window,
                                     softcap=softcap, merged=merged,
                                     scale=scale, bk=bk,
                                     fill_bound=fill_bound, k_scale=k_scale,
                                     v_scale=v_scale)[:, None]


consmax_decode_paged_op.launches = 0
