"""Public wrappers of the ConSmax append-prefill kernels.

Take the model's serving layouts — q chunk ``(b, c, H, dk)``, cache k/v
``(b, L, hkv, dk)`` or the shared ``(P, ps, hkv, dk)`` page pools with a
``(b, npg)`` page table, per-slot ``index``/``lengths`` ``(b,)`` — and
dispatch by the tensors' device: on the CPU they compute the plain versions
(``ref.consmax_prefill_ref`` / ``consmax_prefill_paged_ref``); on a CUDA
device they launch the kernel in ``csrc/consmax_prefill.cu`` (built at first
use, see ``kernels/_build.py``) or raise. There is no fallback from one to
the other. A quantized (int8 / fp8_e4m3) cache comes with its fp32
``k_scale``/``v_scale`` (``(b, L, hkv)``, or ``(P, ps, hkv)`` pools), and
both paths dequantize it block by block as they read it; a quantized cache
without scales, or a bf16 cache with them, raises.

``bk`` (``ServeConfig.prefill_kv_block``, default 512 as in the reference)
sizes the kernels' KV shards over the cache's logical rows
(``cache_layout.prefill_shards``: rounded up to whole 64-row tiles, at most
64 shards); the shards' fp32 partials are summed in shard order inside the
launch, by the last live shard of each row tile, elected with the integer
tickets of ``_build.tickets``. ``bk >= L`` is one shard: the unsplit walk.
The plain versions compute the whole product and ignore ``bk``.

``slot`` (the contiguous kernel): a ``(b,)`` int32 device tensor naming the
cache slot each chunk row reads and the cache ``(B, L, hkv, dk)`` the whole
slot pool — the engine's static prefill step, whose slot is a value, never
an address or a Python int. Without it the cache is ``(b, L, hkv, dk)`` and
row b reads slot b. The two give the same bits on the same rows.

``consmax_prefill_op.launches`` and ``consmax_prefill_paged_op.launches``
count kernel launches (CUDA only), each its own entry point: the kernel
adds one to its wrapper's device counter (``_build.counted``), so a launch
a CUDA graph replays counts too.
``prefill_plan`` is the launch in plain Python (``kernels/launch_plan``),
which the CUDA launch and ``launch_plan.capture`` both take.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.consmax_prefill.ref import (
    consmax_prefill_paged_ref, consmax_prefill_ref)


@functools.cache
def _lib():
    lib = _build.load("consmax_prefill")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.consmax_prefill_launch.argtypes = ([p] * 10 + [i] * 7
                                           + [f, f, i, i, i, p, i, i, p, p,
                                              p, p])
    lib.consmax_prefill_launch.restype = i
    lib.consmax_prefill_paged_launch.argtypes = ([p] * 11 + [i] * 8
                                                 + [f, f, i, i, i, p, i, i,
                                                    p, p, p])
    lib.consmax_prefill_paged_launch.restype = i
    return lib


def prefill_plan(kernel, q, k, v, index, lengths, beta, gamma, *, bk=512,
                 page_table=None, k_scale=None, v_scale=None, slot=None):
    """Check one launch's operands and plan it: the attention mainloop
    (``launch_plan.walk_plan``) over the KV shards of ``bk`` rows of the
    cache's L logical rows (``k.shape[1]``, or the table's ``npg * ps``),
    one (row tile, shard) per block, two consumer warpgroups on its 128
    folded query rows at head_dim <= 128 (one on 64 at 256). Returns the
    plan and the checked operands (index, lengths, beta, gamma, slot,
    kv_type)."""
    b, c, H, dk = q.shape
    L = (k.shape[1] if page_table is None
         else page_table.shape[1] * k.shape[1])
    index = index.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    beta = beta.float().contiguous()
    gamma = gamma.float().contiguous()
    slots = {"index": index, "lengths": lengths}
    if slot is not None:
        slots["slot"] = slot = slot.to(torch.int32).contiguous()
    kv_type = _build.check_operands(
        kernel, q, k, v, slots=slots,
        heads={"beta": beta, "gamma": gamma}, page_table=page_table,
        k_scale=k_scale, v_scale=v_scale)
    ops = [LP.index_operand("page_table", page_table)] if (
        page_table is not None) else []
    ops += [LP.index_operand(name, t) for name, t in slots.items()]
    plan = LP.walk_plan(kernel, b=b, c=c, H=H, hkv=k.shape[2], dk=dk,
                        kv_dtype=k.dtype, index_operands=ops,
                        n_index=len(ops), out_shape=q.shape,
                        out_dtype=q.dtype, L=L, bk=bk)
    return plan, dict(index=index, lengths=lengths, beta=beta, gamma=gamma,
                      slot=slot, kv_type=kv_type)


def _capture(kernel, q, k, v, index, lengths, beta, gamma, page_table,
             k_scale, v_scale, bk, slot=None):
    plan, o = prefill_plan(kernel, q, k, v, index, lengths, beta, gamma,
                           bk=bk, page_table=page_table, k_scale=k_scale,
                           v_scale=v_scale, slot=slot)
    return LP.record(plan, dict(q=q, k=k, v=v, page_table=page_table,
                                index=o["index"], lengths=o["lengths"],
                                slot=o["slot"], k_scale=k_scale,
                                v_scale=v_scale), q.device)


def _scale(scale, dk):
    return 1.0 / math.sqrt(dk) if scale is None else scale


def _split(plan, q):
    """The launch's shard arguments: (shard_rows, ns, partials, tickets);
    the scratch partials and the stream's tickets only for ns > 1."""
    lay = plan.layout
    if lay["ns"] == 1:
        return lay["shard_rows"], 1, None, None
    partials = plan.outputs[0]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_tiles = plan.grid[0] // lay["ns"] * plan.grid[1] * plan.grid[2]
    return (lay["shard_rows"], lay["ns"],
            torch.empty(partials.shape, dtype=torch.float32,
                        device=q.device),
            _build.tickets(q.device, stream, n_tiles))


def consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, *, window=0,
                         softcap=0.0, merged=True, scale=None,
                         fill_bound=True, k_scale=None, v_scale=None,
                         bk=512, slot=None):
    """Launch the CUDA kernel. q (b, c, H, dk) bf16; k, v (b, L, hkv, dk)
    bf16, or int8 / fp8_e4m3 with k_scale, v_scale (b, L, hkv) fp32 — with
    ``slot`` (b,) int32, (B, L, ...) caches whose slot ``slot[i]`` row i
    reads; index, lengths (b,) int32; beta/gamma (H,) fp32; bk the KV shard
    size. Returns (b, c, H, dk) bf16."""
    b, c, H, dk = q.shape
    L, hkv = k.shape[1], k.shape[2]
    plan, o = prefill_plan("consmax_prefill", q, k, v, index, lengths, beta,
                           gamma, bk=bk, k_scale=k_scale, v_scale=v_scale,
                           slot=slot)
    shard_rows, ns, partials, tickets = _split(plan, q)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.consmax_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), o["index"].data_ptr(),
        o["lengths"].data_ptr(), o["beta"].data_ptr(), o["gamma"].data_ptr(),
        out.data_ptr(), b, c, H, hkv, L, dk, window, softcap,
        _scale(scale, dk), int(merged), int(fill_bound), o["kv_type"],
        torch.cuda.current_stream(q.device).cuda_stream, shard_rows, ns,
        _build.data_ptr(partials), _build.data_ptr(tickets),
        _build.data_ptr(o["slot"]),
        _build.launch_counter("consmax_prefill", q.device))
    _build.check(lib, err, "consmax_prefill")
    return out


@_build.counted("consmax_prefill")
def consmax_prefill_op(q, k, v, index, lengths, beta, gamma, *, window=0,
                       softcap=0.0, merged=True, scale=None, fill_bound=True,
                       k_scale=None, v_scale=None, bk=512, slot=None):
    """q: (b, c, H, dk) chunk at per-slot cache positions index + [0, c);
    k, v: (b, L, hkv, dk) caches after the chunk's K/V were written (with
    ``slot`` (b,) int32: the whole (B, L, hkv, dk) slot pool, row i
    reading slot ``slot[i]``); index, lengths: (b,) int32 (row i's own);
    beta/gamma: (H,) fp32; k_scale, v_scale: (b | B, L, hkv) fp32 row
    scales of an int8 / fp8_e4m3 cache (None for
    bf16). Returns (b, c, H, dk) in q.dtype; rows >= lengths are pad rows
    the caller discards. ``scale=1.0`` when q is pre-scaled (the model
    path). ``fill_bound`` skips KV tiles no row of a block can see and
    ``bk`` sizes the KV shards (CUDA launch only; the plain version
    computes the whole matrix)."""
    _build.check_kv_scales("consmax_prefill", k, v, k_scale, v_scale)
    if LP.capturing():
        return _capture("consmax_prefill", q, k, v, index, lengths, beta,
                        gamma, None, k_scale, v_scale, bk, slot)
    if q.device.type == "cpu":
        return consmax_prefill_ref(q, k, v, index, lengths, beta, gamma,
                                   window=window, softcap=softcap,
                                   merged=merged, scale=scale,
                                   k_scale=k_scale, v_scale=v_scale,
                                   slot=slot).to(q.dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_prefill: no kernel for device {q.device}")
    return consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma,
                                window=window, softcap=softcap,
                                merged=merged, scale=scale,
                                fill_bound=fill_bound, k_scale=k_scale,
                                v_scale=v_scale, bk=bk, slot=slot)


def consmax_prefill_paged_cuda(q, kp, vp, page_table, index, lengths, beta,
                               gamma, *, window=0, softcap=0.0, merged=True,
                               scale=None, fill_bound=True, k_scale=None,
                               v_scale=None, bk=512):
    """Launch the paged CUDA kernel. q (b, c, H, dk) bf16; kp, vp (P, ps,
    hkv, dk) bf16 pools, or int8 / fp8_e4m3 with k_scale, v_scale
    (P, ps, hkv) fp32 scale pools; page_table (b, npg) int32 (-1 =
    unmapped); index, lengths (b,) int32; beta/gamma (H,) fp32; bk the KV
    shard size over the npg * ps logical rows. Any page size. Returns
    (b, c, H, dk) bf16."""
    b, c, H, dk = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    npg = page_table.shape[1]
    plan, o = prefill_plan("consmax_prefill_paged", q, kp, vp, index,
                           lengths, beta, gamma, bk=bk,
                           page_table=page_table, k_scale=k_scale,
                           v_scale=v_scale)
    shard_rows, ns, partials, tickets = _split(plan, q)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.consmax_prefill_paged_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), page_table.data_ptr(),
        o["index"].data_ptr(), o["lengths"].data_ptr(), o["beta"].data_ptr(),
        o["gamma"].data_ptr(), out.data_ptr(), b, c, H, hkv, npg, ps, dk,
        window, softcap, _scale(scale, dk), int(merged), int(fill_bound),
        o["kv_type"], torch.cuda.current_stream(q.device).cuda_stream,
        shard_rows, ns, _build.data_ptr(partials), _build.data_ptr(tickets),
        _build.launch_counter("consmax_prefill_paged", q.device))
    _build.check(lib, err, "consmax_prefill_paged")
    return out


@_build.counted("consmax_prefill_paged")
def consmax_prefill_paged_op(q, kp, vp, page_table, index, lengths, beta,
                             gamma, *, window=0, softcap=0.0, merged=True,
                             scale=None, fill_bound=True, k_scale=None,
                             v_scale=None, bk=512):
    """Paged-pool variant, with the reference's signature and ``bk`` (the
    reference's paged kernel walks pages and takes none; this one walks the
    contiguous kernel's logical shards, so the two give the same bits).
    kp, vp: shared (P, ps, hkv, dk) pools after the chunk's K/V were
    written; page_table: (b, npg) int32 (-1 = unmapped); k_scale, v_scale:
    (P, ps, hkv) fp32 scale pools of an int8 / fp8_e4m3 pool (None for
    bf16). Returns (b, c, H, dk) in q.dtype; rows >= lengths are pad rows
    the caller discards. ``fill_bound`` and ``bk`` only shape the CUDA
    launch."""
    _build.check_kv_scales("consmax_prefill_paged", kp, vp, k_scale,
                           v_scale)
    if LP.capturing():
        return _capture("consmax_prefill_paged", q, kp, vp, index, lengths,
                        beta, gamma, page_table, k_scale, v_scale, bk)
    if q.device.type == "cpu":
        return consmax_prefill_paged_ref(
            q, kp, vp, page_table, index, lengths, beta, gamma,
            window=window, softcap=softcap, merged=merged, scale=scale,
            k_scale=k_scale, v_scale=v_scale).to(q.dtype)
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_prefill_paged: no kernel for device {q.device}")
    return consmax_prefill_paged_cuda(q, kp, vp, page_table, index, lengths,
                                      beta, gamma, window=window,
                                      softcap=softcap, merged=merged,
                                      scale=scale, fill_bound=fill_bound,
                                      k_scale=k_scale, v_scale=v_scale,
                                      bk=bk)
