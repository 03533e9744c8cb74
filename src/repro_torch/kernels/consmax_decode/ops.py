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
count kernel launches (CUDA only), each its own entry point: the kernel
adds one to its wrapper's device counter (``_build.counted``), so a launch
a CUDA graph replays counts too.

``decode_plan`` is the launch in plain Python (``kernels/launch_plan``):
the checks, the grid, the shared memory (``decode_smem_bytes``, the twin of
the library's ``consmax_decode_smem_bytes``), the tiles each block writes;
the CUDA launch and ``launch_plan.capture`` both take it.

The kernel sums its shards' partials itself: the last shard of each (slot,
KV head) to finish, found by an integer ticket, adds them in shard order.
The tickets live in one zeroed int32 buffer per (device, stream)
(``_build.tickets``, shared with the prefill kernels), which every launch
leaves zero again, so launches on one
stream (and a CUDA graph captured on its own stream) may reuse it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.consmax_decode.ref import (consmax_decode_paged_ref,
                                                   consmax_decode_ref)

# The largest KV shard (kMaxBlock in the kernel): a paged CTA keeps its
# shard's page-table entries, bk + 1 at most, in shared memory beside its
# tiles (the tiles themselves do not grow with bk).
MAX_BLOCK = 512
THREADS = 256      # kThreads: 8 warps per block
TILE_ROWS = 64     # kRows: KV rows per tile


@functools.cache
def _lib():
    lib = _build.load("consmax_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.consmax_decode_launch.argtypes = ([p] * 10 + [i] * 7
                                          + [f, f, i, i, i, p, p, p])
    lib.consmax_decode_launch.restype = i
    lib.consmax_decode_paged_launch.argtypes = ([p] * 11 + [i] * 8
                                                + [f, f, i, i, i, p, p,
                                                   p])
    lib.consmax_decode_paged_launch.restype = i
    lib.consmax_decode_smem_bytes.argtypes = [i] * 4
    lib.consmax_decode_smem_bytes.restype = i
    return lib


def _check_smem(lib, kernel, dk, kv_type, paged, bk):
    """Raise before a launch the card would refuse for its shared memory
    (the library's own byte count for this head_dim, cache type, row
    address and shard size)."""
    need = lib.consmax_decode_smem_bytes(dk, kv_type, int(paged), bk)
    if not 0 < need <= _build.SMEM_PER_BLOCK:
        raise ValueError(f"{kernel}: {need} B of shared memory at dk {dk}, "
                         f"bk {bk}; a block may use {_build.SMEM_PER_BLOCK}")


def decode_stages(dk: int, quantized: bool) -> int:
    """DecodeLayout<dk>::stages() (csrc/consmax_decode.cu)."""
    if dk == 256:
        return 3
    if dk == 128:
        return 4 if quantized else 3
    if dk == 96:
        return 6 if quantized else 4
    if dk == 64:
        return 8 if quantized else 5
    return 8


def decode_smem_bytes(dk: int, quantized: bool, paged: bool, bk: int) -> int:
    """DecodeLayout<dk, TKV, paged>::bytes(bk) (csrc/consmax_decode.cu): the
    mbarriers' 128 bytes, two P tiles of 16 heads, the ring of stages, for
    codes one dequantized bf16 K/V tile pair, and a paged shard's bk + 1
    page entries."""
    row = 2 * dk + 16                      # a bf16 operand row, padded
    tile = TILE_ROWS * row
    stage = (2 * TILE_ROWS * dk + 2 * TILE_ROWS * 4 if quantized
             else 2 * tile)
    ring = 128 + 2 * 16 * (TILE_ROWS * 2 + 16)
    pages = (ring + decode_stages(dk, quantized) * stage
             + (2 * tile if quantized else 0))
    return pages + ((bk + 1) * 4 if paged else 0)


def decode_plan(kernel, q, k, v, lengths, beta, gamma, *, bk, L,
                page_table=None, k_scale=None, v_scale=None):
    """Check one launch's operands and plan it over ``L`` logical rows per
    slot: grid (ceil(L / bk), hkv, b) of 256 threads, the layout's shared
    memory. Block (shard, h, slot) writes its (g, dk) fp32 partial; the
    slot's (g, dk) output rows of KV head h are written by ONE block per
    (slot, KV head), elected at run time among the shards by the integer
    ticket (the last live shard to finish; shard 0 for a slot with none).
    Returns the plan and the checked operands (lengths, beta, gamma, the
    shard size bk, the cache's kv_type code)."""
    b, H, dk = q.shape
    hkv = k.shape[2]
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
    ns, g = -(-L // bk), H // hkv
    paged = page_table is not None
    index = [LP.index_operand("page_table", page_table)] if paged else []
    index.append(LP.index_operand("lengths", lengths))
    plan = LP.LaunchPlan(
        name=kernel, kernel="decode_partials", grid=(ns, hkv, b),
        block=THREADS, smem=decode_smem_bytes(dk, kv_type != 0, paged, bk),
        outputs=[LP.OutputTile("partials", (b, hkv, ns, g, dk), "float32",
                               lambda bx, by, bz: (bz, by, bx)),
                 LP.OutputTile("out", (b, H, dk), LP.dtype_name(q.dtype),
                               lambda bx, by, bz: (bz, by),
                               elected_over=(0,))],
        scratch_bytes=b * hkv * ns * g * dk * 4, index_operands=index,
        n_index=2 if paged else 1, election="tickets",
        layout=dict(dk=dk, kv_type=kv_type, paged=int(paged), bk=bk))
    return plan, dict(lengths=lengths, beta=beta, gamma=gamma, bk=bk,
                      kv_type=kv_type)


def _outputs(plan, q):
    """The plan's scratch partials and output, allocated on q's device."""
    partials, out = plan.outputs
    return (torch.empty(partials.shape, dtype=torch.float32,
                        device=q.device),
            torch.empty(out.shape, dtype=q.dtype, device=q.device))


def _scale(scale, dk):
    return 1.0 / math.sqrt(dk) if scale is None else scale


def consmax_decode_cuda(q, k, v, lengths, beta, gamma, *, window=0,
                        softcap=0.0, merged=True, scale=None, bk=256,
                        fill_bound=True, k_scale=None, v_scale=None):
    """Launch the CUDA kernel. q (b, H, dk) bf16; k, v (b, L, hkv, dk) bf16,
    or int8 / fp8_e4m3 with k_scale, v_scale (b, L, hkv) fp32; lengths (b,)
    int32 valid rows; beta/gamma (H,) fp32. Returns (b, H, dk) bf16."""
    b, H, dk = q.shape
    L, hkv = k.shape[1], k.shape[2]
    plan, o = decode_plan("consmax_decode", q, k, v, lengths, beta, gamma,
                          bk=bk, L=L, k_scale=k_scale, v_scale=v_scale)
    partials, out = _outputs(plan, q)
    lib = _lib()
    _check_smem(lib, "consmax_decode", dk, o["kv_type"], False, o["bk"])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.consmax_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), o["lengths"].data_ptr(),
        o["beta"].data_ptr(), o["gamma"].data_ptr(), partials.data_ptr(),
        out.data_ptr(), b, H, hkv, L, dk, o["bk"], window, softcap,
        _scale(scale, dk), int(merged), int(fill_bound), o["kv_type"],
        stream, _build.tickets(q.device, stream, b * hkv).data_ptr(),
        _build.launch_counter("consmax_decode", q.device))
    _build.check(lib, err, "consmax_decode")
    return out


@_build.counted("consmax_decode")
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
    if LP.capturing():
        plan, o = decode_plan("consmax_decode", q[:, 0], k, v, lengths, beta,
                              gamma, bk=bk, L=k.shape[1], k_scale=k_scale,
                              v_scale=v_scale)
        return LP.record(plan, dict(q=q, k=k, v=v, lengths=o["lengths"],
                                    k_scale=k_scale, v_scale=v_scale),
                         q.device)[:, None]
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
    plan, o = decode_plan("consmax_decode_paged", q, kp, vp, lengths, beta,
                          gamma, bk=bk, L=npg * ps, page_table=page_table,
                          k_scale=k_scale, v_scale=v_scale)
    partials, out = _outputs(plan, q)
    lib = _lib()
    _check_smem(lib, "consmax_decode_paged", dk, o["kv_type"], True,
                o["bk"])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.consmax_decode_paged_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _build.data_ptr(k_scale),
        _build.data_ptr(v_scale), page_table.data_ptr(),
        o["lengths"].data_ptr(), o["beta"].data_ptr(), o["gamma"].data_ptr(),
        partials.data_ptr(), out.data_ptr(), b, H, hkv, npg, ps, dk, o["bk"],
        window, softcap, _scale(scale, dk), int(merged), int(fill_bound),
        o["kv_type"], stream,
        _build.tickets(q.device, stream, b * hkv).data_ptr(),
        _build.launch_counter("consmax_decode_paged", q.device))
    _build.check(lib, err, "consmax_decode_paged")
    return out


@_build.counted("consmax_decode_paged")
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
    if LP.capturing():
        plan, o = decode_plan("consmax_decode_paged", q[:, 0], kp, vp,
                              lengths, beta, gamma, bk=bk,
                              L=page_table.shape[1] * kp.shape[1],
                              page_table=page_table, k_scale=k_scale,
                              v_scale=v_scale)
        return LP.record(plan, dict(q=q, k=kp, v=vp, page_table=page_table,
                                    lengths=o["lengths"], k_scale=k_scale,
                                    v_scale=v_scale), q.device)[:, None]
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
