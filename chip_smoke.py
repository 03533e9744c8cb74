"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. header: the card's ``nvidia-smi`` name and power limit, torch and CUDA;
2. build: every CUDA kernel of the path, from ``src/repro_torch`` (nvcc,
   one process per source, all at once); then, for each instantiation of
   the shared attention mainloop (``attn_walk_kernel``) and of the decode
   kernel (``decode_partials``), its registers, dynamic and static shared
   memory and spills from ``ptxas -v``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (qwen2-1.5b: 8 slots x 8192 rows, 2 KV heads,
   GQA group 6, head_dim 128, bf16; prefill chunk 512) and the
   gpt2-consmax engine's (8 x 1024 rows, MHA, head_dim 64; chunk 128),
   plus small window / softcap / unmerged cases; the prefill kernel's
   ``slot`` operand (the engine's static step: the chunk against the
   whole 8-slot pool) at each slot, bit-equal to the slot-view launch and
   within the plain version's bounds, both timed; error, kernel and plain
   times, bound; then the paged kernels (below);
3b. paper kernels: ``consmax_attention``, ``softmax_attention`` and the
   bitwidth-split ``consmax_lut`` through their ops at full widths
   (qwen2-1.5b b 2 x s 4096 causal; gpt2-consmax b 8 x s 256 and 1024;
   a gemma2-2b local layer, dk 256, window 4096, softcap 50, s 8192; the
   LUT on 12 x 4096 x 4096 int8 scores), launch counts read around that
   run; then non-causal cross-length, merged, odd-length, bit-equality with
   the prefill kernel, the decode kernel's last row, all 256 LUT codes;
   times beside ``scaled_dot_product_attention``, the ConSmax (Eq. 2 and
   Eq. 3) / softmax time ratio and each kernel's share of its bound;
3c. quantized kernels: the four serving kernels on int8 and fp8_e4m3
   caches (codes + per-row fp32 scales) at the qwen2-1.5b and gpt2-consmax
   shapes above: bit-equal to the same kernel on the dequantized bf16
   cache, within the bounds of the plain version, paged == contiguous bits;
   times beside the bf16 kernel, same data (the decode kernels' int8 / bf16
   and fp8 / bf16 time ratios, contiguous and paged); then the LUT check
   (the int8 decode kernel on all 256 K codes == ``consmax_lut`` within one
   bf16 ulp);
3d. gemma2-2b kernels: the four serving kernels at a local layer's shapes
   (8 x 8192 rows, 4 KV heads, head_dim 256, window 4096, softcap 50;
   prefill chunk 512 at fills 0-8192; page size 256) against their plain
   versions, paged == contiguous bits; times and bounds;
   in 3, 3c and 3d the prefill kernels run the KV-shard sweep
   (``prefill_kv_block`` 512, the default, 256 and 64, and one shard,
   bk = L): at every bk within the plain version's bounds, fill-bounded ==
   capacity-swept bits, paged == contiguous bits at every page size the
   phase uses, int8 / fp8 == the bf16 kernel on the dequantized cache, and
   a split within the bf16 bounds of the one-shard launch; the timed
   chunks' times at each bk beside the bound and the plain time (the
   result line's ``ms`` is the default's);
4. model: full-width qwen2-1.5b logits with both kernels vs the plain
   walks on a small input;
5. engine: full-width qwen2-1.5b (28 layers, random weights from a seed)
   served by ``ContinuousBatchingEngine`` with both kernels, 12 greedy
   requests; every request finishes, both kernels ran, and one request
   served alone equals its tokens served among the others;
   Every single-device engine replays its prefill and decode steps as
   CUDA graphs, whatever its score norm and kernel flags; each engine's
   ``[graphs]`` line gives ``graphed``, its captures (seconds each),
   replays per iteration and graph pool, and the run fails unless it was
   graphed with at most 2 graphs and one signature per step (the mesh,
   the MoE trace and each ``cuda_graphs=False`` twin run eagerly and say
   so); every ``ServeSession`` replays its decode step as one graph per
   (b, mode), its ``[graphs]`` line giving the held caches' and the
   pool's MiB per batch size;
5b. graphs: qwen2-1.5b contiguous, paged bf16 and paged int8 and
   gemma2-2b contiguous, each graphed and with ``cuda_graphs=False`` on
   the same greedy and sampled requests: the same tokens;
6. engine: full-width gpt2-consmax (MHA, g = 1), the same checks, then
   the same requests at ``prefill_kv_block=64`` (solo == batched there);
7. paged engine: full-width qwen2-1.5b on a 128-page pool (16 slots x 8192
   rows), prefix cache on, with shared-prefix traffic: the pool drains,
   the cache hits, a page is copied on write, the prefill and launch counts
   add up, and the tokens equal the contiguous engine's and a warm
   request's served alone;
8. the same paged phase with an int8 KV cache: the same checks and trace,
   int8 paged tokens == int8 contiguous tokens, and both caches' bytes ==
   the reckoning from the shapes (dk + 4 bytes per row, KV head and tensor);
9. gpt2-consmax from an fp8_e4m3 cache: paged == contiguous tokens, solo
   == batched;
10. perplexity: full-width gpt2-consmax teacher-forced through
   ``make_serve_fns``'s ``decode_step`` on 128 tokens; int8-KV within 1 %
   of bf16-KV, fp8's printed;
11. sampling: threefry2x32 against Random123's known answers and vectors
   of the reference (``JAX_DRAWS``); keys, draws, uniforms and Gumbel noise
   on the card == the CPU's bits; sampled tokens card vs CPU (flips only at
   near-ties, counted); device ops of the greedy and the sampled epilogue;
12. gemma2-2b at full width (dk 256, windows of 4096, softcaps) on the
   contiguous and the paged engine, greedy and sampled requests mixed:
   paged == contiguous, fused == host-sampling, solo == batched (a greedy
   and a sampled request), one prefill and one decode signature; launches
   of the four serving kernels at dk 256 (their times come from phase 3d);
13. ``ServeSession`` at full-width qwen2-1.5b (fp32 compute): fused ==
   host-sampling, graphed == eager (``cuda_graphs=False``), ragged rows ==
   prompts served alone, greedy == the continuous engine;
13b. ``ServeSession`` graphed vs eager, b 4 x 512 prompt tokens, 32
   steps, bf16: qwen2-1.5b at full width with the decode kernel (its
   launches == (steps - 1) x layers either way) and with the plain decode
   (max_seq 32,768), gpt2-consmax with softmax and softermax, jamba at
   smoke size: graphed == eager tokens, greedy and sampled; ms per decode
   step of each;
14. the plain walks bounded on the device: ``append_attention`` and
   ``paged_attention`` at qwen2-1.5b's heads (8 x 8192 rows, blocks of
   1024 or pages of 256), consmax / softmax / softermax over bf16 and int8
   K/V, each captured once with each block an IF node on ``j < hi``
   (``kernels/graph_cond``) and replayed at fills from one block to every
   block: each replay == the eager sweep bit for bit, one conditional
   node per block, a one-block replay runs one block's walk kernels;
   then softmax and softermax: gpt2-consmax served through the plain
   online walks, paged == contiguous tokens, graphed (bounded walks) ==
   eager (the sweep) tokens; ms per iteration and tok/s of each, and wall
   and device-busy ms per traced iteration with the idle share; each
   ``[graphs]`` line gives every graph's nodes and conditional nodes (one
   per walk block and layer: a gate);
14b. qwen2-1.5b at full width with both kernel flags off (8 x 8192,
   ``kv_chunk`` 1024; paged on pages of 256), graphed vs eager: the same
   tokens, the conditional nodes; ms per iteration and tok/s of each, the
   graphed engines traced;
15. train (no kernel runs in training: it goes through the torch
   ``blockwise_attention`` with autograd, as the reference trains through
   jnp):
   15a. gpt2-consmax at the paper's width (6 L, d 384, vocab 8,192; b 8 x
   s 256, bf16) trained 200 steps with ConSmax and with Softmax through
   ``Trainer``: finite losses that fall; the gap, ms per step, tokens/s,
   how far beta / gamma moved; then 10 fp32 steps on the card against the
   same 10 on the CPU, per-step loss within ``CARD_VS_CPU_RTOL``;
   15b. resume, in a process of its own under deterministic algorithms:
   k steps, save, a new ``Trainer`` resumes at k and its next losses equal
   an uninterrupted run's bit for bit (ops that warn are named);
   15c. qwen2-1.5b at full width (b 4 x s 2048): 3 steps with remat
   "full", one more traced (device time of the bf16 GEMMs, the fp32
   attention einsums and the rest), then step 0 with "dots"; the step-0
   loss in its band and bit-equal across the two; peak memory beside the
   reckoning, ms per step, tokens/s, model-FLOP share;
   15d. the model trained in 15a served through the kernels: each kernel
   against its plain version on every layer's trained K/V and learned
   beta / gamma; contiguous and paged engines (paged == contiguous, solo ==
   batched, launches counted per run); the int8 / fp8 perplexity gate; no
   parameter gets a ``.grad``.
16. the model families of the ninth slice (random weights from seeds):
   16a. phi3.5-moe-42b-a6.6b at its published widths (d 4096, 32 heads, 8
   KV heads, 16 experts top-2 of ff 6400, vocab 32,064), depth cut from 32
   to 4 layers: the four serving kernels at its shapes (16 slots x 8192
   rows, GQA group 4, dk 128) against their plain versions, times and
   bounds (the ``[phi3.5-moe]`` rows); the continuous engine, contiguous
   and paged, bf16 KV, chunk 512, greedy and sampled requests of 512-2048
   prompt tokens: paged == contiguous, solo == batched, one signature per
   step, launches per run, router near-ties counted, wall ms per
   iteration and tok/s, one iteration traced (the MoE layers' device ms
   by expert ``bmm``, router, dispatch); a short int8-KV run;
   16b. phi3.5-moe training at full width, 2 layers, two ``make_train_fns``
   steps with a non-zero aux, in its own process under deterministic
   algorithms, twice (bit-equal); ms per step, peak memory vs reckoning;
   16c. xlstm-1.3b at full width (48 blocks): ``ServeSession`` ms per
   decode step, graphed (logits mode) and eager, the same tokens; fp32
   decode-step logits vs one whole-sequence ``lm_apply``;
   16d. musicgen-large at full width, 8 of 48 layers: frame embeddings,
   cross-attention over 256 cond tokens, decode steps through the decode
   kernel (dk 64) vs the whole pass and vs the plain walk;
   16e. the six new archs' smoke configs, card vs CPU logits, whole and
   through caches.
17. the device mesh, ranks sharing the one card over gloo (children
   ``chip_smoke.py --mesh-rank <spec> <rank>``): 17a qwen2-1.5b at tp 2
   (contiguous) and tp 2 x seq 2 (paged) == one device's tokens, head-slice
   and seq-block kernel bits, collective bytes == the reckoning; 17b
   context-parallel decode; 17c 2-rank FSDP training; 17d NCCL only with
   two cards; 17e tp 2 == one device's tokens past qwen2's bf16 widths:
   chatglm3-6b (d 4096, 4 of 28 layers) and qwen2-1.5b at fp32 compute (8
   of 28 layers, plain walks).
18. the eleventh slice: 18a the six attention kernels at phi-3-vision's
   head_dim 96 against their plain versions (bit gates: bounded ==
   capacity, paged == contiguous, int8 == dequantized, consmax_attention
   == consmax_prefill), times and bounds; 18b the two full-sequence kernels
   on fp32 operands within the reference's atol 2e-5; 18c
   phi-3-vision-4.2b at full width (its phi3 backbone on tokens) through
   the continuous engine, contiguous and paged, rows 1-4 at dk 96, every
   fused step under ``torch.cuda.set_sync_debug_mode("error")``; 18d the
   analysis gate ``repro_torch.launch.analyze --device cuda`` (0
   violations; ``--self-test`` exit 1, every rule fired) and every launch
   plan's shared memory == the library's.
19. the dry run: 19a ``repro_torch.launch.dryrun --device cuda`` on the
   (16, 16) mesh for qwen2-1.5b, gemma2-2b and phi3.5-moe x decode_32k
   and jamba-1.5-large-398b x long_500k, one niced process per cell
   (children ``--dryrun-host`` and ``--dryrun-meshfake`` trace 19b's and
   19c's cells the same way), four at a time, started once the host-bound
   decode cell of 19b has run beside the longest of them only; every cell
   ``ok``; 19b three cells
   on one card (1 x 1), only the batch cut, run for real
   (``--dryrun-real``: device ms, median of 5 after 2 warm-ups, >= 0.95 x
   the dry run's ``bound_sec``; peak memory within 10 % of its
   ``peak_bytes_per_device``), the decode cell also through the decode
   kernel at b 16 x 32,768 (each layer's call within the kernel bound on
   its own inputs; the step's logits, and their distance from an fp32
   step's, within phase 4's model bound); 19c the
   collective records of 4 gloo ranks (``--dry-rank``) == the dry run's
   for the same (2, 2) cell; 19d GPipe over qwen2-1.5b's 28 blocks on 4
   ranks sharing the card, bit-equal to the sequential forward, 9 permutes
   + 1 all-reduce each; 19e the three examples with ``--device cuda``.

The trace phases print device busy ms per engine iteration and, within
it, ``prefill_kernel``: the mainloop kernel's (``attn_walk_kernel``) ms, and
``decode_kernel``: the decode kernel's (``decode_partials``) ms.

Launch counts: each kernel counts its own launches on the card (block
(0, 0, 0) adds one to its wrapper's device counter, ``_build.counted``), so
a launch a CUDA graph replays counts as one made eagerly, and a capture,
which launches nothing, counts nothing. Each serving path
is run with the kernels' counts set to 0 just before it and read just
after (the bf16 contiguous kernels from phase
5, the bf16 paged ones from 7, the int8 rows from 8, the fp8 rows from 9,
the ``[gemma2-2b]`` rows from 12, the ``[phi3.5-moe]`` rows from 16a, the
``[phi-3-vision]`` rows from 18c; the ``[dk96]`` / ``[fp32]`` rows of the
full-sequence kernels count their calls in 18a / 18b).

Phase 3 covers the paged kernels too, at the paged engine's shapes (page
size 256; then 16 and 64, a -1 hole, window / softcap / unmerged, and the
gpt2-consmax shapes): each against its plain paged version, and bit for bit
against the contiguous kernel on the same rows. Each phase prints its
seconds.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. TF32 is switched off for fp32 matmuls
and convolutions, so the plain versions run in full fp32.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12       # outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # dense TF32 on the tensor cores
TOL_NOTE = ("|kernel - plain| <= 2^-7 * sum_j p_j |v_j| elementwise: bf16 "
            "output rounding and (prefill) bf16 weights are each 2^-9 "
            "relative per term; and per output row (a decode slot, a "
            "prefill query row) ||kernel - plain|| <= 2^-7 ||plain||, four "
            "times the 2^-9 rounding, which one lost or doubled 64-row KV "
            "tile of an 8192-row slot (~9 % of ||plain||) would exceed")
REL_L2_BOUND = 2.0 ** -7
_worst_rel = [0.0]          # largest per-row relative L2 error of the run


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, flush, reps):
    """Mean device time of ``fn`` over ``reps`` calls, each after a read of
    ``flush`` (256 MB) that evicts the 50 MB L2 (the serving path reads
    every layer's cache cold) and leaves it clean (a write would leave
    50 MB of dirty lines, whose write-backs would double a short kernel's
    DRAM traffic), then a device-side wait long enough for the host to
    enqueue the call, so the events time the device work and not the
    wrapper's host time (which can outlast the flush for a short kernel)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.max()
        torch.cuda._sleep(500_000)     # ~0.25 ms at the H100's clocks
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bound_ms(nbytes, flops, peak=PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_err(got, ref, ref_absv):
    """(within bound, max_abs_err, max row relative L2): the elementwise
    bound against ``ref_absv`` = sum_j p_j |v_j|, and a relative L2 bound
    per output row (the trailing (H, dk) of each slot or query row) over the
    rows whose plain output is not all zero; the all-zero rows (no visible
    key) are held by the elementwise bound."""
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= 2.0 ** -7 * ref_absv.float() + 1e-6).all())
    ref_n = ref.float().flatten(-2).norm(dim=-1)
    err_n = err.flatten(-2).norm(dim=-1)
    live = ref_n > 0
    rel = float((err_n[live] / ref_n[live]).max()) if live.any() else 0.0
    return ok and rel <= REL_L2_BOUND, float(err.max()), rel


def _check(name, got, ref, ref_absv):
    """``_kernel_err``'s bound, logged; raises if the kernel is outside it."""
    ok, e, rel = _kernel_err(got, ref, ref_absv)
    _worst_rel[0] = max(_worst_rel[0], rel)
    _log(f"[kernels] {name}: max_abs_err {e:.3e} "
         f"(max |plain| {float(ref.float().abs().max()):.3e}), max row "
         f"relative L2 {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return e


# the prefill kernels' KV-shard sweep: the default prefill_kv_block, two
# finer splits, then one shard (bk = L: the unsplit walk)
SWEEP_BK = (512, 256, 64)


def _prefill_sweep(tag, flush, launch, ref, ref_absv, L, *, same=None,
                   timed=True, bound=None, plain_ms=None):
    """The prefill kernel at each shard size of the sweep, ``launch(bk,
    fill_bound)`` -> out: at every bk within the bounds of the plain
    ``ref``, fill-bounded == capacity-swept bits, ``same(bk, out)`` (the
    phase's bit gates at that bk) and, for a split, within the bf16 bounds
    of the one-shard launch (the sum's order differs across shards, so no
    bits are asked there). ``timed``: each bk's device time over 50
    launches, logged beside the others, the ``bound`` (ms, by) and the
    plain version's ``plain_ms``. Returns ({bk: ms}, max_abs_err); the
    one-shard time is under key "one"."""
    from repro_torch.kernels import cache_layout as CL
    outs, errs = {}, []
    for bk in (*SWEEP_BK, L):
        _, ns = CL.prefill_shards(L, bk)
        name = f"{tag} bk={bk if bk < L else 'L'} (ns {ns})"
        out = launch(bk, True)
        errs.append(_check(name, out, ref, ref_absv))
        _same_bits(name, out, launch(bk, False), "the capacity-swept launch")
        if same is not None:
            same(bk, out)
        outs[bk] = out
    for bk in SWEEP_BK:
        ok, e, rel = _kernel_err(outs[bk], outs[L], ref_absv)
        _log(f"[kernels] {tag} bk={bk} vs one shard: max_abs_err {e:.3e}, "
             f"max row relative L2 {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} bk={bk}: split launch outside the "
                                 "bf16 bounds of the one-shard launch")
    if not timed:
        return {}, max(errs)
    times = {bk: _time_ms(lambda bk=bk: launch(bk, True), flush, 50)
             for bk in SWEEP_BK}
    times["one"] = _time_ms(lambda: launch(L, True), flush, 50)
    _log(f"[kernels] {tag} shard sweep: "
         + ", ".join(f"bk {bk} {times[bk] * 1e3:.1f} us" for bk in SWEEP_BK)
         + f", one shard {times['one'] * 1e3:.1f} us"
         + (f"; bound {bound[0] * 1e3:.2f} us by {bound[1]}" if bound
            else "")
         + (f"; plain {plain_ms * 1e3:.1f} us" if plain_ms else ""))
    return times, max(errs)


def _rand(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _head_params(gen, H):
    beta = 0.5 + 2.0 * torch.rand(H, generator=gen, device="cuda")
    return beta, torch.full((H,), 100.0, device="cuda")


def kernel_phase(flush):
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, L, H, hkv, dk, bk, c = 8, 8192, 12, 2, 128, 256, 512
    rows = {}

    # ---- decode: 8 slots, mixed fills (valid rows = index + 1): a free
    # slot (index 0), a shard boundary, mid-shard, long and full slots
    lengths = torch.tensor([1, 256, 257, 1000, 3000, 4096, 8191, 8192],
                           dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw)
    ref = consmax_decode_ref(q.float(), k, v, lengths, beta, gamma, **kw)
    err = _check("decode b=8 L=8192 mixed fills", got, ref,
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    ms = _time_ms(lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                              bk=bk, **kw), flush, 50)
    plain_ms = _time_ms(lambda: consmax_decode_ref(q, k, v, lengths, beta,
                                                   gamma, **kw), flush, 5)
    fill = int(lengths.sum())
    bound, by = _bound_ms(fill * hkv * dk * 2 * 2 + 2 * b * H * dk * 2,
                          4 * fill * H * dk)
    rows["consmax_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by)

    # ---- prefill: the engine's (1, 512) chunk at fills 0 (a 0-length
    # chunk), 512, 4096 (the timed case), a ragged 200-row tail, and the
    # chunk that fills the cache; then 8 slots at once
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = _rand(gen, (1, L, hkv, dk)), _rand(gen, (1, L, hkv, dk))
    errs = []
    for idx, n in [(0, 0), (0, 512), (3584, 512), (4000, 200), (7680, 512)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw)
        ref = consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw)
        errs.append(_check(f"prefill c=512 index={idx} len={n}", got, ref,
                           consmax_prefill_ref(q1, k1, v1.abs(), ti, tn,
                                               beta, gamma, **kw)))
    qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
    ib = torch.tensor([0, 0, 256, 1000, 3584, 4000, 7000, 7680],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 512, 512, 77, 512, 300, 512, 512],
                      dtype=torch.int32, device="cuda")
    errs.append(_prefill_sweep(
        "prefill b=8 c=512 mixed fills", flush,
        lambda bk, fb: consmax_prefill_cuda(qb, k, v, ib, nb, beta, gamma,
                                            bk=bk, fill_bound=fb, **kw),
        consmax_prefill_ref(qb, k, v, ib, nb, beta, gamma, **kw),
        consmax_prefill_ref(qb, k, v.abs(), ib, nb, beta, gamma, **kw), L,
        timed=False)[1])
    idx, n = 3584, 512
    ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
    tn = torch.tensor([n], dtype=torch.int32, device="cuda")
    plain_ms = _time_ms(lambda: consmax_prefill_ref(q1, k1, v1, ti, tn, beta,
                                                    gamma, **kw), flush, 5)
    kvl = idx + n
    visible = sum(min(idx + i + 1, kvl) for i in range(c))   # causal keys
    bound, by = _bound_ms(kvl * hkv * dk * 2 * 2 + 2 * c * H * dk * 2,
                          4 * visible * H * dk)
    times, e = _prefill_sweep(
        "prefill c=512 at fill 4096", flush,
        lambda bk, fb: consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma,
                                            bk=bk, fill_bound=fb, **kw),
        consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
        consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma, **kw), L,
        bound=(bound, by), plain_ms=plain_ms)
    errs.append(e)
    # the engine's static step: the chunk against the whole 8-slot pool,
    # its slot a device operand; == the slot-view launch bit for bit
    for s in range(b):
        ts = torch.tensor([s], dtype=torch.int32, device="cuda")
        got = consmax_prefill_cuda(q1, k, v, ib[s:s + 1], nb[s:s + 1], beta,
                                   gamma, slot=ts, **kw)
        one = consmax_prefill_cuda(q1, k[s:s + 1], v[s:s + 1], ib[s:s + 1],
                                   nb[s:s + 1], beta, gamma, **kw)
        errs.append(_check(
            f"prefill slot operand, slot {s} of 8 (index {int(ib[s])}, "
            f"len {int(nb[s])})", got,
            consmax_prefill_ref(q1, k, v, ib[s:s + 1], nb[s:s + 1], beta,
                                gamma, slot=ts, **kw),
            consmax_prefill_ref(q1, k, v.abs(), ib[s:s + 1], nb[s:s + 1],
                                beta, gamma, slot=ts, **kw)))
        _same_bits(f"prefill slot operand, slot {s}", got, one,
                   "the slot-view launch")
    ts = torch.tensor([4], dtype=torch.int32, device="cuda")
    k4, v4 = k[4:5].contiguous(), v[4:5].contiguous()
    slot_ms = _time_ms(lambda: consmax_prefill_cuda(
        q1, k, v, ti, tn, beta, gamma, slot=ts, **kw), flush, 50)
    view_ms = _time_ms(lambda: consmax_prefill_cuda(
        q1, k4, v4, ti, tn, beta, gamma, **kw), flush, 50)
    _log(f"[kernels] prefill c=512 at fill 4096, bk 512: slot operand "
         f"(slot 4 of the 8 x 8192 pool) {slot_ms:.4f} ms, slot view "
         f"{view_ms:.4f} ms")
    rows["consmax_prefill"] = dict(max_abs_err=max(errs), ms=times[512],
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, slot_ms=slot_ms)

    # ---- the options qwen2-1.5b does not use, and the MHA (g = 1) edge
    for name, kwx in [("window", dict(window=300)),
                      ("softcap", dict(softcap=30.0)),
                      ("unmerged", dict(merged=False))]:
        kx = dict(kw, **kwx)
        sl = slice(0, 1024)
        ks, vs = k[:, sl].contiguous(), v[:, sl].contiguous()
        lx = lengths.clamp(max=1024)
        _check(f"decode {name}",
               consmax_decode_cuda(q, ks, vs, lx, beta, gamma, bk=bk, **kx),
               consmax_decode_ref(q.float(), ks, vs, lx, beta, gamma, **kx),
               consmax_decode_ref(q.float(), ks, vs.abs(), lx, beta, gamma,
                                  **kx))
        ti = torch.tensor([400], dtype=torch.int32, device="cuda")
        tn = torch.tensor([c], dtype=torch.int32, device="cuda")
        ks1, vs1 = ks[:1].contiguous(), vs[:1].contiguous()
        _check(f"prefill {name}",
               consmax_prefill_cuda(q1, ks1, vs1, ti, tn, beta, gamma, **kx),
               consmax_prefill_ref(q1, ks1, vs1, ti, tn, beta, gamma, **kx),
               consmax_prefill_ref(q1, ks1, vs1.abs(), ti, tn, beta, gamma,
                                   **kx))
    gpt2_kernel_checks(gen, bk, kw)
    return rows


def gpt2_kernel_checks(gen, bk, kw):
    """The gpt2-consmax engine's shapes (MHA, g = 1, head_dim 64): 8 slots
    x 1024 rows, decode shard bk, prefill chunk 128."""
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref

    b, L, H, dk, c = 8, 1024, 6, 64, 128
    k, v = _rand(gen, (b, L, H, dk)), _rand(gen, (b, L, H, dk))
    beta, gamma = _head_params(gen, H)
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    lengths = torch.tensor([1, 64, 255, 256, 257, 500, 1023, 1024],
                           dtype=torch.int32, device="cuda")
    _check("gpt2 decode MHA b=8 L=1024 mixed fills",
           consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw),
           consmax_decode_ref(q.float(), k, v, lengths, beta, gamma, **kw),
           consmax_decode_ref(q.float(), k, v.abs(), lengths, beta, gamma,
                              **kw))
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[:1].contiguous(), v[:1].contiguous()
    # a 0-length chunk, the first chunk, a ragged tail, the chunk that
    # ends the cache
    for idx, n in [(0, 0), (0, 128), (640, 59), (896, 128)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        _check(f"gpt2 prefill MHA c=128 index={idx} len={n}",
               consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw),
               consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
               consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                   **kw))
    qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
    ib = torch.tensor([0, 0, 128, 200, 384, 640, 700, 896],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 128, 128, 31, 128, 59, 128, 128],
                      dtype=torch.int32, device="cuda")
    _check("gpt2 prefill MHA b=8 c=128 mixed fills",
           consmax_prefill_cuda(qb, k, v, ib, nb, beta, gamma, **kw),
           consmax_prefill_ref(qb, k, v, ib, nb, beta, gamma, **kw),
           consmax_prefill_ref(qb, k, v.abs(), ib, nb, beta, gamma, **kw))


def _paginate_rows(tensors, fills, ps, num_pages, seed):
    """Move the rows of contiguous (b, L, ...) tensors (K/V rows, bf16 or
    codes, and scales alike) into pools of ``num_pages`` pages of ``ps``
    rows under ONE table: slot s's pages are the next ceil(fills[s] / ps) of
    a random permutation (disjoint across slots), -1 past them. Pages no
    table maps hold random bytes (K/V) or NaN (fp32 scales): a kernel that
    read one would show it. Returns (pools, table)."""
    b, L = tensors[0].shape[:2]
    npg = -(-L // ps)
    counts = [-(-int(f) // ps) for f in fills]
    if sum(counts) > num_pages:
        raise ValueError(f"{sum(counts)} pages needed, pool {num_pages}")
    cpu = torch.Generator().manual_seed(seed)
    perm = torch.randperm(num_pages, generator=cpu)
    table = torch.full((b, npg), -1, dtype=torch.int32)
    i = 0
    for sl, n in enumerate(counts):
        table[sl, :n] = perm[i:i + n].to(torch.int32)
        i += n
    pools = []
    for t in tensors:
        shape = (num_pages, ps) + tuple(t.shape[2:])
        if t.dtype == torch.float32:
            pool = torch.full(shape, float("nan"), device="cuda")
        else:
            pool = torch.randint(
                0, 256, shape[:-1] + (shape[-1] * t.element_size(),),
                dtype=torch.uint8, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(seed)
            ).view(t.dtype)
        # one-byte codes move as bytes (padding fp8 is not implemented)
        byte = t.element_size() == 1
        rows = torch.nn.functional.pad(
            t.view(torch.uint8) if byte else t,
            (0, 0) * (t.ndim - 2) + (0, npg * ps - L))
        dst = pool.view(torch.uint8) if byte else pool
        for sl, n in enumerate(counts):
            dst[table[sl, :n].long().cuda()] = rows[sl, :n * ps].reshape(
                n, ps, *t.shape[2:])
        pools.append(pool)
    return pools, table.cuda()


def _same_bits(name, got, other, what="the contiguous kernel"):
    same = torch.equal(got, other)
    _log(f"[kernels] {name}: == {what} bit for bit: {same}")
    if not same:
        raise AssertionError(f"{name}: differs from {what}")


def _paged_decode_case(name, q, k, v, lengths, beta, gamma, kw, *, bk,
                       ps, num_pages, hole=None):
    """The paged decode kernel on ``k``/``v``'s rows paginated at ``ps``:
    held against its plain paged version, and (no ``hole``) bit for bit
    against the contiguous kernel on the same rows. ``hole`` = (slot,
    column) of a table entry set to -1 inside the fill."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref)
    (kp, vp), table = _paginate_rows([k, v], lengths.tolist(), ps, num_pages,
                                     seed=ps * 1000 + k.shape[0])
    if hole is not None:
        table[hole] = -1
    got = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta, gamma,
                                    bk=bk, **kw)
    err = _check(name, got, consmax_decode_paged_ref(
        q.float(), kp, vp, table, lengths, beta, gamma, **kw),
        consmax_decode_paged_ref(q.float(), kp, vp.abs(), table, lengths,
                                 beta, gamma, **kw))
    if hole is None:
        _same_bits(name, got, consmax_decode_cuda(q, k, v, lengths, beta,
                                                  gamma, bk=bk, **kw))
    return err, (kp, vp, table)


def _paged_prefill_case(name, q, k, v, index, lengths, beta, gamma, kw,
                        *, ps, num_pages, bks=(SWEEP_BK[0],)):
    """The paged prefill kernel against its plain paged version and, bit
    for bit, the contiguous kernel on the same rows, at each KV shard size
    of ``bks`` (the default prefill_kv_block unless asked)."""
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref)
    (kp, vp), table = _paginate_rows([k, v], (index + lengths).tolist(), ps,
                                     num_pages, seed=ps * 1000 + k.shape[0])
    ref = consmax_prefill_paged_ref(q, kp, vp, table, index, lengths, beta,
                                    gamma, **kw)
    ref_absv = consmax_prefill_paged_ref(q, kp, vp.abs(), table, index,
                                         lengths, beta, gamma, **kw)
    errs = []
    for bk in bks:
        got = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths,
                                         beta, gamma, bk=bk, **kw)
        errs.append(_check(f"{name} bk={bk}", got, ref, ref_absv))
        _same_bits(f"{name} bk={bk}", got, consmax_prefill_cuda(
            q, k, v, index, lengths, beta, gamma, bk=bk, **kw))
    return max(errs), (kp, vp, table)


def paged_kernel_phase(flush):
    """Both paged kernels at the paged engine's qwen2-1.5b shapes (page
    size 256, pools of 256 pages, each slot's table a random permutation of
    disjoint pages, -1 past its fill), against their plain paged versions
    and bit for bit against the contiguous kernels on the same rows; then a
    -1 hole inside a fill, page sizes 16 and 64, window / softcap /
    unmerged, and the gpt2-consmax shapes (MHA, head_dim 64). Returns the
    two kernels' rows of the result line."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref)

    gen = torch.Generator(device="cuda").manual_seed(10)
    L, H, hkv, dk, bk, c, ps, npages = 8192, 12, 2, 128, 256, 512, 256, 256
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    rows = {}

    # ---- decode: the contiguous case's 8 fills plus a free slot (n = 0)
    lengths = torch.tensor([1, 256, 257, 1000, 3000, 4096, 8191, 8192, 0],
                           dtype=torch.int32, device="cuda")
    b = lengths.numel()
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    err, (kp, vp, table) = _paged_decode_case(
        "paged decode b=9 L=8192 ps=256 mixed fills + n=0", q, k, v,
        lengths, beta, gamma, kw, bk=bk, ps=ps, num_pages=npages)
    ms = _time_ms(lambda: consmax_decode_paged_cuda(
        q, kp, vp, table, lengths, beta, gamma, bk=bk, **kw), flush, 50)
    plain_ms = _time_ms(lambda: consmax_decode_paged_ref(
        q, kp, vp, table, lengths, beta, gamma, **kw), flush, 5)
    fill = int(lengths.sum())
    bound, by = _bound_ms(fill * hkv * dk * 2 * 2 + 2 * b * H * dk * 2
                          + table.numel() * 4, 4 * fill * H * dk)
    rows["consmax_decode_paged"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound,
                                        bound_by=by)
    _paged_decode_case("paged decode, -1 hole inside slot 5's fill (plain "
                       "only)", q, k, v, lengths, beta, gamma, kw,
                       bk=bk, ps=ps, num_pages=npages, hole=(5, 3))
    for pss in (16, 64):
        need = sum(-(-int(f) // pss) for f in lengths.tolist())
        _paged_decode_case(f"paged decode b=9 ps={pss}", q, k, v,
                           lengths, beta, gamma, kw, bk=bk, ps=pss,
                           num_pages=need + 64)

    # ---- prefill: the engine's (1, 512) chunk at the contiguous case's
    # (index, len) pairs, then 8 slots at once
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[7:8].contiguous(), v[7:8].contiguous()
    errs = []
    for idx, n in [(0, 0), (0, 512), (3584, 512), (4000, 200), (7680, 512)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        e, pools = _paged_prefill_case(
            f"paged prefill c=512 ps=256 index={idx} len={n}", q1, k1,
            v1, ti, tn, beta, gamma, kw, ps=ps, num_pages=npages)
        errs.append(e)
        if (idx, n) == (3584, 512):
            timed = (ti, tn, *pools)
    qb = _rand(gen, (8, c, H, dk), dk ** -0.5)
    kb, vb = k[:8].contiguous(), v[:8].contiguous()
    ib = torch.tensor([0, 0, 256, 1000, 3584, 4000, 7000, 7680],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 512, 512, 77, 512, 300, 512, 512],
                      dtype=torch.int32, device="cuda")
    for pss in (256, 16, 64):
        need = sum(-(-int(f) // pss) for f in (ib + nb).tolist())
        e, _ = _paged_prefill_case(
            f"paged prefill b=8 c=512 ps={pss} mixed fills", qb, kb, vb,
            ib, nb, beta, gamma, kw, ps=pss, num_pages=max(npages, need + 64),
            bks=(*SWEEP_BK, L))
        errs.append(e)
    ti, tn, kp1, vp1, t1 = timed
    plain_ms = _time_ms(lambda: consmax_prefill_paged_ref(
        q1, kp1, vp1, t1, ti, tn, beta, gamma, **kw), flush, 5)
    idx, n = 3584, 512
    kvl = idx + n
    visible = sum(min(idx + i + 1, kvl) for i in range(c))   # causal keys
    bound, by = _bound_ms(kvl * hkv * dk * 2 * 2 + 2 * c * H * dk * 2
                          + t1.numel() * 4, 4 * visible * H * dk)
    times, e = _prefill_sweep(
        "paged prefill c=512 ps=256 at fill 4096", flush,
        lambda bk, fb: consmax_prefill_paged_cuda(
            q1, kp1, vp1, t1, ti, tn, beta, gamma, bk=bk, fill_bound=fb,
            **kw),
        consmax_prefill_paged_ref(q1, kp1, vp1, t1, ti, tn, beta, gamma,
                                  **kw),
        consmax_prefill_paged_ref(q1, kp1, vp1.abs(), t1, ti, tn, beta,
                                  gamma, **kw), L,
        same=lambda bk, out: _same_bits(
            f"paged prefill c=512 ps=256 at fill 4096 bk={bk}", out,
            consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, bk=bk,
                                 **kw)),
        bound=(bound, by), plain_ms=plain_ms)
    errs.append(e)
    rows["consmax_prefill_paged"] = dict(max_abs_err=max(errs),
                                         ms=times[512], plain_ms=plain_ms,
                                         bound_ms=bound, bound_by=by)

    # ---- the options qwen2-1.5b does not use, at 1024 rows
    sl = slice(0, 1024)
    ks, vs = k[:, sl].contiguous(), v[:, sl].contiguous()
    lx = lengths.clamp(max=1024)
    for name, kwx in [("window", dict(window=300)),
                      ("softcap", dict(softcap=30.0)),
                      ("unmerged", dict(merged=False))]:
        kx = dict(kw, **kwx)
        _paged_decode_case(f"paged decode {name}", q, ks, vs, lx, beta,
                           gamma, kx, bk=bk, ps=ps, num_pages=npages)
        _paged_prefill_case(
            f"paged prefill {name}", q1, ks[7:8].contiguous(),
            vs[7:8].contiguous(),
            torch.tensor([400], dtype=torch.int32, device="cuda"),
            torch.tensor([512], dtype=torch.int32, device="cuda"), beta,
            gamma, kx, ps=ps, num_pages=npages)
    del k, v, kp, vp, kb, vb

    # ---- gpt2-consmax shapes: MHA (g = 1), head_dim 64, page size 128
    b, L, H, dk, c = 8, 1024, 6, 64, 128
    k, v = _rand(gen, (b, L, H, dk)), _rand(gen, (b, L, H, dk))
    beta, gamma = _head_params(gen, H)
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    lengths = torch.tensor([1, 64, 255, 256, 257, 500, 1023, 1024],
                           dtype=torch.int32, device="cuda")
    _paged_decode_case("gpt2 paged decode MHA b=8 L=1024 ps=128", q, k,
                       v, lengths, beta, gamma, kw, bk=bk, ps=128,
                       num_pages=128)
    qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
    ib = torch.tensor([0, 0, 128, 200, 384, 640, 700, 896],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 128, 128, 31, 128, 59, 128, 128],
                      dtype=torch.int32, device="cuda")
    _paged_prefill_case("gpt2 paged prefill MHA b=8 c=128 ps=128", qb, k,
                        v, ib, nb, beta, gamma, kw, ps=128, num_pages=128)
    return rows


QDTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def _quantize(x, name):
    """Codes, fp32 scales and the dequantized bf16 cache of ``x``."""
    from repro_torch.kernels import cache_layout as CL
    codes, scale = CL.quantize_kv(x, QDTYPES[name])
    return codes, scale, CL.dequant_block(codes, scale, torch.bfloat16)


def quantized_kernel_phase(flush):
    """The four serving kernels on int8 and fp8_e4m3 caches (codes and
    per-row fp32 scales from ``quantize_kv``), at the qwen2-1.5b serving
    shapes (decode b 8 x L 8192 at mixed fills; prefill c 512 at fill 4096
    and 8 slots of mixed fills; paged page size 256) and gpt2-consmax's (MHA,
    dk 64: decode b 8 x L 1024, prefill c 128, page size 128). Each
    quantized kernel is bit-equal to the same kernel on the dequantized
    bf16 cache, within the bounds of its plain version on that cache, and
    the paged kernels bit-equal to the contiguous ones on the same rows.
    Timed beside the bf16 kernel on the dequantized cache, same data, same
    run; bound by bytes: dk + 4 per row per KV head per tensor. Then the LUT
    check. Returns the eight (kernel, dtype) rows of the result line."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref

    gen = torch.Generator(device="cuda").manual_seed(30)
    rows = {}
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    for arch, (b, L, H, hkv, dk, c, ps, npages) in {
            "qwen2-1.5b": (8, 8192, 12, 2, 128, 512, 256, 256),
            "gpt2-consmax": (8, 1024, 6, 6, 64, 128, 128, 128)}.items():
        timed = arch == "qwen2-1.5b"
        lengths = (torch.tensor([1, 256, 257, 1000, 3000, 4096, 8191, 8192])
                   if timed else
                   torch.tensor([1, 64, 255, 256, 257, 500, 1023, 1024])
                   ).to(torch.int32).cuda()
        ib, nb = ((torch.tensor([0, 0, 256, 1000, 3584, 4000, 7000, 7680]),
                   torch.tensor([0, 512, 512, 77, 512, 300, 512, 512]))
                  if timed else
                  (torch.tensor([0, 0, 128, 200, 384, 640, 700, 896]),
                   torch.tensor([0, 128, 128, 31, 128, 59, 128, 128])))
        ib, nb = ib.to(torch.int32).cuda(), nb.to(torch.int32).cuda()
        k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
        beta, gamma = _head_params(gen, H)
        q = _rand(gen, (b, H, dk), dk ** -0.5)
        qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
        for name in QDTYPES:
            kq, ks, kd = _quantize(k, name)
            vq, vs, vd = _quantize(v, name)
            sc = dict(k_scale=ks, v_scale=vs)
            tag = f"{arch} {name}"
            # ---- decode, contiguous and paged
            dec = consmax_decode_cuda(q, kq, vq, lengths, beta, gamma,
                                      bk=256, **sc, **kw)
            _same_bits(f"{tag} decode b=8 L={L}", dec, consmax_decode_cuda(
                q, kd, vd, lengths, beta, gamma, bk=256, **kw),
                "the bf16 kernel on the dequantized cache")
            d_err = _check(f"{tag} decode b=8 L={L}", dec,
                           consmax_decode_ref(q.float(), kd, vd, lengths,
                                              beta, gamma, **kw),
                           consmax_decode_ref(q.float(), kd, vd.abs(),
                                              lengths, beta, gamma, **kw))
            (kp, vp, ksp, vsp), table = _paginate_rows(
                [kq, vq, ks, vs], lengths.tolist(), ps, npages, seed=ps)
            psc = dict(k_scale=ksp, v_scale=vsp)
            pdec = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta,
                                             gamma, bk=256, **psc, **kw)
            _same_bits(f"{tag} paged decode ps={ps}", pdec, dec)
            # ---- prefill: 8 slots of mixed fills, contiguous and paged,
            # at every shard size of the sweep
            (kpp, vpp, kspp, vspp), tpp = _paginate_rows(
                [kq, vq, ks, vs], (ib + nb).tolist(), ps, npages,
                seed=ps + 1)

            def same(bk, pre):
                _same_bits(f"{tag} prefill b=8 c={c} bk={bk}", pre,
                           consmax_prefill_cuda(qb, kd, vd, ib, nb, beta,
                                                gamma, bk=bk, **kw),
                           "the bf16 kernel on the dequantized cache")
                _same_bits(f"{tag} paged prefill ps={ps} bk={bk}",
                           consmax_prefill_paged_cuda(
                               qb, kpp, vpp, tpp, ib, nb, beta, gamma,
                               k_scale=kspp, v_scale=vspp, bk=bk, **kw), pre)

            p_err = _prefill_sweep(
                f"{tag} prefill b=8 c={c}", flush,
                lambda bk, fb: consmax_prefill_cuda(
                    qb, kq, vq, ib, nb, beta, gamma, bk=bk, fill_bound=fb,
                    **sc, **kw),
                consmax_prefill_ref(qb, kd, vd, ib, nb, beta, gamma, **kw),
                consmax_prefill_ref(qb, kd, vd.abs(), ib, nb, beta, gamma,
                                    **kw), L, same=same, timed=False)[1]
            if not timed:
                continue
            rows.update(_quantized_times(
                flush, name, q, (kq, vq, ks, vs), (kd, vd), (kp, vp, ksp, vsp),
                table, lengths, beta, gamma, kw, d_err, p_err))
        del k, v
    lut_check()
    return rows


def _quantized_times(flush, name, q, quant, deq, pools, table, lengths,
                     beta, gamma, kw, d_err, p_err):
    """Times of the four quantized kernels at the qwen2-1.5b shapes (decode
    b 8 x L 8192 mixed fills; prefill slot 7's rows, one (1, 512) chunk at
    fill 4096), each beside the bf16 kernel on the dequantized cache and its
    plain version on the quantized cache, same run."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref, consmax_decode_ref)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref, consmax_prefill_ref)

    kq, vq, ks, vs = quant
    kd, vd = deq
    kp, vp, ksp, vsp = pools
    # the dequantized rows in bf16 pools of the same page size
    (kpb, vpb), tb = _paginate_rows([kd, vd], lengths.tolist(), kp.shape[1],
                                    kp.shape[0], seed=kp.shape[1])
    b, H, dk = q.shape
    hkv = kq.shape[2]
    sc, psc = dict(k_scale=ks, v_scale=vs), dict(k_scale=ksp, v_scale=vsp)
    fill = int(lengths.sum())
    row_bytes = hkv * (dk + 4) * 2                 # K and V codes + scales
    qo_bytes = 2 * b * H * dk * 2
    out = {}
    t = {
        "decode": _time_ms(lambda: consmax_decode_cuda(
            q, kq, vq, lengths, beta, gamma, bk=256, **sc, **kw), flush, 50),
        "decode bf16": _time_ms(lambda: consmax_decode_cuda(
            q, kd, vd, lengths, beta, gamma, bk=256, **kw), flush, 50),
        "decode plain": _time_ms(lambda: consmax_decode_ref(
            q, kq, vq, lengths, beta, gamma, **sc, **kw), flush, 5),
        "paged decode": _time_ms(lambda: consmax_decode_paged_cuda(
            q, kp, vp, table, lengths, beta, gamma, bk=256, **psc, **kw),
            flush, 50),
        "paged decode bf16": _time_ms(lambda: consmax_decode_paged_cuda(
            q, kpb, vpb, tb, lengths, beta, gamma, bk=256, **kw),
            flush, 50),
        "paged decode plain": _time_ms(lambda: consmax_decode_paged_ref(
            q, kp, vp, table, lengths, beta, gamma, **psc, **kw), flush, 5)}
    dec_bound = _bound_ms(fill * row_bytes + qo_bytes, 4 * fill * H * dk)
    pdec_bound = _bound_ms(fill * row_bytes + qo_bytes + table.numel() * 4,
                           4 * fill * H * dk)
    # prefill: slot 7's rows (8192 filled), a (1, 512) chunk at fill 4096
    c, idx = 512, 3584
    gen = torch.Generator(device="cuda").manual_seed(31)
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    one = [x[7:8].contiguous() for x in (kq, vq, ks, vs, kd, vd)]
    k1, v1, ks1, vs1, kd1, vd1 = one
    (kp1, vp1, ksp1, vsp1), t1 = _paginate_rows([k1, v1, ks1, vs1], [8192],
                                                256, 64, seed=7)
    ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
    tn = torch.tensor([c], dtype=torch.int32, device="cuda")
    sc1, psc1 = dict(k_scale=ks1, v_scale=vs1), dict(k_scale=ksp1,
                                                     v_scale=vsp1)
    t.update({
        "prefill bf16": _time_ms(lambda: consmax_prefill_cuda(
            q1, kd1, vd1, ti, tn, beta, gamma, **kw), flush, 50),
        "prefill plain": _time_ms(lambda: consmax_prefill_ref(
            q1, k1, v1, ti, tn, beta, gamma, **sc1, **kw), flush, 5),
        "paged prefill plain": _time_ms(lambda: consmax_prefill_paged_ref(
            q1, kp1, vp1, t1, ti, tn, beta, gamma, **psc1, **kw), flush, 5)})
    kvl = idx + c
    visible = sum(min(idx + i + 1, kvl) for i in range(c))
    pre_bound = _bound_ms(kvl * row_bytes + 2 * c * H * dk * 2,
                          4 * visible * H * dk)
    ppre_bound = _bound_ms(kvl * row_bytes + 2 * c * H * dk * 2
                           + t1.numel() * 4, 4 * visible * H * dk)
    # the shard sweep of both prefill kernels on the codes (== the bf16
    # kernel on the dequantized rows, paged == contiguous, at every bk)
    L = k1.shape[1]
    ref = consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **sc1, **kw)
    ref_absv = consmax_prefill_ref(q1, kd1, vd1.abs(), ti, tn, beta, gamma,
                                   **kw)
    tag = f"{name} qwen2-1.5b prefill c=512 at fill 4096"
    sweep, _ = _prefill_sweep(
        tag, flush, lambda bk, fb: consmax_prefill_cuda(
            q1, k1, v1, ti, tn, beta, gamma, bk=bk, fill_bound=fb, **sc1,
            **kw), ref, ref_absv, L,
        same=lambda bk, out: _same_bits(
            f"{tag} bk={bk}", out, consmax_prefill_cuda(
                q1, kd1, vd1, ti, tn, beta, gamma, bk=bk, **kw),
            "the bf16 kernel on the dequantized cache"),
        bound=pre_bound, plain_ms=t["prefill plain"])
    psweep, _ = _prefill_sweep(
        f"{name} qwen2-1.5b paged prefill ps=256 at fill 4096", flush,
        lambda bk, fb: consmax_prefill_paged_cuda(
            q1, kp1, vp1, t1, ti, tn, beta, gamma, bk=bk, fill_bound=fb,
            **psc1, **kw), ref, ref_absv, L,
        same=lambda bk, out: _same_bits(
            f"{name} paged prefill bk={bk}", out, consmax_prefill_cuda(
                q1, k1, v1, ti, tn, beta, gamma, bk=bk, **sc1, **kw)),
        bound=ppre_bound, plain_ms=t["paged prefill plain"])
    t["prefill"], t["paged prefill"] = sweep[SWEEP_BK[0]], psweep[SWEEP_BK[0]]
    _log(f"[quantized] {name} qwen2-1.5b decode {name} / bf16 time ratio "
         f"{t['decode'] / t['decode bf16']:.4f} contiguous, "
         f"{t['paged decode'] / t['paged decode bf16']:.4f} paged (page "
         f"size {kp.shape[1]}; bytes ratio {row_bytes / (hkv * dk * 4):.4f})")
    _log(f"[quantized] {name} qwen2-1.5b: decode {t['decode'] * 1e3:.1f} us "
         f"(bf16 kernel on the dequantized cache {t['decode bf16'] * 1e3:.1f}"
         f" us, ratio {t['decode'] / t['decode bf16']:.4f}; plain "
         f"{t['decode plain'] * 1e3:.1f} us; bound "
         f"{dec_bound[0] * 1e3:.2f} us by {dec_bound[1]}); paged decode "
         f"{t['paged decode'] * 1e3:.1f} us (bf16 "
         f"{t['paged decode bf16'] * 1e3:.1f} us); prefill c=512 at fill 4096 "
         f"{t['prefill'] * 1e3:.1f} us (bf16 {t['prefill bf16'] * 1e3:.1f} "
         f"us, ratio {t['prefill'] / t['prefill bf16']:.4f}; bound "
         f"{pre_bound[0] * 1e3:.2f} us by {pre_bound[1]}); paged prefill "
         f"{t['paged prefill'] * 1e3:.1f} us")
    for kernel, ms, plain, bound, err in (
            ("consmax_decode", t["decode"], t["decode plain"], dec_bound,
             d_err),
            ("consmax_prefill", t["prefill"], t["prefill plain"], pre_bound,
             p_err),
            ("consmax_decode_paged", t["paged decode"],
             t["paged decode plain"], pdec_bound, d_err),
            ("consmax_prefill_paged", t["paged prefill"],
             t["paged prefill plain"], ppre_bound, p_err)):
        out[f"{kernel}[{name}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound[0],
            bound_by=bound[1], library_ms=None)
    return out


def lut_check():
    """The reference's LUT check (``tests/test_quantized_kv.py:217``) on the
    card, at dk 256 over all 256 int8 codes: K row j holds code s_j in lane
    0 (scale 1.0), q = e_0 in bf16, V the identity (scale 1.0), so lane d of
    the quantized decode kernel's output is ``C * exp(sigma * s_d)``,
    ``consmax_lut``'s value, within one bf16 ulp (the output is bf16)."""
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_lut.ops import consmax_lut_op

    n, sigma = 256, 1.0 / 16.0
    codes = torch.arange(-128, 128, device="cuda").to(torch.int8)
    k = torch.zeros((1, n, 1, n), dtype=torch.int8, device="cuda")
    k[0, :, 0, 0] = codes
    v = torch.eye(n, dtype=torch.int8, device="cuda")[None, :, None, :]
    ones = torch.ones((1, n, 1), device="cuda")
    q = torch.zeros((1, 1, n), dtype=torch.bfloat16, device="cuda")
    q[0, 0, 0] = 1.0
    beta = torch.tensor([1.5], device="cuda")
    gamma = torch.tensor([100.0], device="cuda")
    out = consmax_decode_cuda(q, k, v, torch.tensor(
        [n], dtype=torch.int32, device="cuda"), beta, gamma, scale=sigma,
        bk=256, k_scale=ones, v_scale=ones)[0, 0].float()
    lut = consmax_lut_op(codes, torch.exp(-beta[0]) / gamma[0], scale=sigma)
    ulp = 2.0 ** (torch.floor(torch.log2(lut.abs())) - 7)
    worst = float(((out - lut).abs() / ulp).max())
    ok = worst <= 1.0
    _log(f"[quantized] LUT check: int8 decode on all 256 K codes vs "
         f"consmax_lut: largest difference {worst:.3f} bf16 ulp (bound 1) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("quantized decode disagrees with consmax_lut")


def _visible_pairs(sq, skv, *, causal, window=0):
    """(query, key) pairs the full-sequence mask lets through, per (batch
    row, head): the work the attention kernels must do on these inputs."""
    i = np.arange(sq)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def _attn_bound(b, sq, skv, H, hkv, dk, **mask):
    """q, k, v and out moved once; 4 * dk * H flops per visible pair."""
    nbytes = 2 * (2 * b * sq * H * dk + 2 * b * skv * hkv * dk)
    return _bound_ms(nbytes, 4 * dk * H * b * _visible_pairs(sq, skv,
                                                              **mask))


def paper_kernel_phase(flush):
    """The paper's kernels at full model widths, through their public ops.

    Main path (launch counts zeroed just before, read just after): causal
    whole-prompt ConSmax and softmax attention at qwen2-1.5b widths (b 2,
    s 4096, 12 heads, 2 KV heads, dk 128) and gpt2-consmax's (MHA, 6
    heads, dk 64, b 8, s 256 and 1024), ConSmax at a gemma2-2b local layer
    (8 heads, 4 KV heads, dk 256, window 4096, softcap 50, s 8192), and the
    LUT on one qwen2 layer's int8 score matrix at a 4096 prompt (12 x 4096
    x 4096 codes); each output held to its plain version. Then checks
    outside the counted run: non-causal sq 512 vs skv 4096, merged vs
    unmerged, an odd length, consmax_attention vs the consmax_prefill
    kernel bit for bit and vs the consmax_decode kernel's last row, the LUT
    over all 256 codes at three scales and at n = 7 and 1000. Then the
    times: each kernel, its plain version, its bound, and
    scaled_dot_product_attention beside the softmax kernel. Returns the
    three kernels' rows of the result line and their launch counts."""
    from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
    from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_lut.ops import consmax_lut_op, make_luts
    from repro_torch.kernels.consmax_lut.ref import (consmax_lut_ref,
                                                     lut_product)
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.softmax_attn.ops import softmax_attention_op
    from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(20)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def T(x):
        return x.transpose(1, 2)

    def consmax_plain(q, k, v, beta, gamma, **kw):
        return T(consmax_attention_ref(T(q.float()), T(k), T(v), beta, gamma,
                                       **kw))

    def softmax_plain(q, k, v, **kw):
        return T(softmax_attention_ref(T(q.float()), T(k), T(v), **kw))

    def inputs(b, sq, skv, H, hkv, dk):
        q = _rand(gen, (b, sq, H, dk))
        k, v = _rand(gen, (b, skv, hkv, dk)), _rand(gen, (b, skv, hkv, dk))
        return (q, k, v, *_head_params(gen, H))

    def check_consmax(name, out, q, k, v, beta, gamma, **kw):
        return _check(name, out, consmax_plain(q, k, v, beta, gamma, **kw),
                      consmax_plain(q, k, v.abs(), beta, gamma, **kw))

    def check_softmax(name, out, q, k, v, **kw):
        return _check(name, out, softmax_plain(q, k, v, **kw),
                      softmax_plain(q, k, v.abs(), **kw))

    shapes = {  # name: (b, sq, skv, H, hkv, dk), mask / weight keywords
        "qwen2-1.5b b=2 s=4096": ((2, 4096, 4096, 12, 2, 128), {}),
        "gpt2-consmax b=8 s=256": ((8, 256, 256, 6, 6, 64), {}),
        "gpt2-consmax b=8 s=1024": ((8, 1024, 1024, 6, 6, 64), {}),
        "gemma2-2b local b=1 s=8192": ((1, 8192, 8192, 8, 4, 256),
                                       dict(window=4096, softcap=50.0)),
    }
    data = {name: inputs(*shape) for name, (shape, _) in shapes.items()}
    n_lut, lut_scale = 12 * 4096 * 4096, 128 ** -0.5
    codes = torch.randint(-128, 128, (n_lut,), dtype=torch.int8,
                          device="cuda", generator=gen)
    c_dev = torch.tensor(0.01, device="cuda")

    # ---- the main path: every op once per shape, counts read after
    ops = (consmax_attention_op, softmax_attention_op, consmax_lut_op)
    for op in ops:
        op.launches = 0
    outs = {}
    for name, (shape, kw) in shapes.items():
        q, k, v, beta, gamma = data[name]
        outs[name, "consmax"] = consmax_attention_op(q, k, v, beta, gamma,
                                                     **kw)
        if not kw:
            outs[name, "softmax"] = softmax_attention_op(q, k, v)
    lut_out = consmax_lut_op(codes, c_dev, scale=lut_scale)
    torch.cuda.synchronize()
    counts = {"consmax_attention": consmax_attention_op.launches,
              "softmax_attention": softmax_attention_op.launches,
              "consmax_lut": consmax_lut_op.launches}
    _log(f"[paper] main path launches {counts}")
    if counts != {"consmax_attention": 4, "softmax_attention": 3,
                  "consmax_lut": 1}:
        raise AssertionError(f"paper path launch counts {counts}")
    errs = {"consmax_attention": [], "softmax_attention": []}
    for (name, kind), out in outs.items():
        q, k, v, beta, gamma = data[name]
        kw = shapes[name][1]
        if out.shape != q.shape or out.dtype != torch.bfloat16:
            raise AssertionError(f"{name} {kind}: output {out.shape} "
                                 f"{out.dtype}")
        if kind == "consmax":
            errs["consmax_attention"].append(check_consmax(
                f"consmax_attention {name} {kw or 'causal'}", out, q, k, v,
                beta, gamma, **kw))
        else:
            errs["softmax_attention"].append(check_softmax(
                f"softmax_attention {name} causal", out, q, k, v))
    del outs
    plain = lut_product(codes, c_dev, *make_luts(lut_scale, "cuda"))
    direct = consmax_lut_ref(codes, c_dev, lut_scale)
    lut_rel = float(((lut_out - direct).abs() / direct.abs()).max())
    lut_ok = (torch.equal(lut_out, plain) and lut_rel <= 1e-5
              and lut_out.shape == codes.shape)
    lut_err = float((lut_out - plain).abs().max())
    _log(f"[paper] consmax_lut n={n_lut}: == plain (same tables, same "
         f"order) bit for bit: {torch.equal(lut_out, plain)}; max relative "
         f"error vs C*exp(scale*s) {lut_rel:.3e} (bound 1e-5) "
         f"{'ok' if lut_ok else 'FAIL'}")
    if not lut_ok:
        raise AssertionError("consmax_lut disagrees with its plain version")
    del plain, direct, lut_out

    # ---- checks outside the counted run
    q, k, v, beta, gamma = data["qwen2-1.5b b=2 s=4096"]
    qx = q[:, :512].contiguous()
    check_consmax("consmax_attention non-causal sq=512 skv=4096",
                  consmax_attention_op(qx, k, v, beta, gamma, causal=False),
                  qx, k, v, beta, gamma, causal=False)
    check_softmax("softmax_attention non-causal sq=512 skv=4096",
                  softmax_attention_op(qx, k, v, causal=False), qx, k, v,
                  causal=False)
    unmerged = consmax_attention_op(qx, k[:, :512].contiguous(),
                                    v[:, :512].contiguous(), beta, gamma)
    merged = consmax_attention_op(qx, k[:, :512].contiguous(),
                                  v[:, :512].contiguous(), beta, gamma,
                                  merged=True)
    _check("consmax_attention merged vs unmerged (s=512)", merged,
           unmerged.float(), consmax_plain(qx, k[:, :512].contiguous(),
                                           v[:, :512].abs().contiguous(),
                                           beta, gamma))
    odd = 1000
    qo, ko, vo = (t[:, :odd].contiguous() for t in (q, k, v))
    check_consmax(f"consmax_attention odd length s={odd}",
                  consmax_attention_op(qo, ko, vo, beta, gamma), qo, ko, vo,
                  beta, gamma)
    check_softmax(f"softmax_attention odd length s={odd}",
                  softmax_attention_op(qo, ko, vo), qo, ko, vo)
    for name in ("qwen2-1.5b b=2 s=4096", "gpt2-consmax b=8 s=1024",
                 "gemma2-2b local b=1 s=8192"):
        q, k, v, beta, gamma = data[name]
        kw = dict(shapes[name][1], merged=True, scale=1.0)
        qs = (q.float() * q.shape[-1] ** -0.5).to(torch.bfloat16)
        b, sq = q.shape[:2]
        index = torch.zeros(b, dtype=torch.int32, device="cuda")
        lengths = torch.full((b,), sq, dtype=torch.int32, device="cuda")
        # one KV shard (bk = sq): across shards the sum's order differs
        _same_bits(f"consmax_attention {name} causal merged scale=1",
                   consmax_attention_op(qs, k, v, beta, gamma, **kw),
                   consmax_prefill_cuda(qs, k, v, index, lengths, beta,
                                        gamma, bk=sq, **kw),
                   "consmax_prefill (index 0, lengths sq, one shard)")
    q, k, v, beta, gamma = data["qwen2-1.5b b=2 s=4096"]
    b, sq = q.shape[:2]
    _check("consmax_decode last position vs consmax_attention last row",
           consmax_decode_cuda(q[:, -1].contiguous(), k, v,
                               torch.full((b,), sq, dtype=torch.int32,
                                          device="cuda"), beta, gamma,
                               merged=False, bk=256),
           consmax_attention_op(q, k, v, beta, gamma)[:, -1].float(),
           consmax_plain(q, k, v.abs(), beta, gamma)[:, -1])
    for scale in (0.03, 128 ** -0.5, 0.125):
        s8 = torch.arange(-128, 128, dtype=torch.int8, device="cuda")
        # codes[1:...] starts off a 16-byte boundary: the code-by-code path
        for what, x in (("n=256 (all codes)", s8), ("n=7", codes[:7]),
                        ("n=1000", codes[:1000]),
                        ("n=9000 off a 16-byte boundary", codes[1:9001])):
            got = consmax_lut_op(x, 0.01, scale=scale)
            ref = consmax_lut_ref(x, 0.01, scale)
            rel = float(((got - ref).abs() / ref.abs()).max())
            ok = (torch.equal(got, lut_product(x, 0.01, *make_luts(
                scale, "cuda"))) and rel <= 1e-5)
            _log(f"[paper] consmax_lut {what} scale={scale:.5f}: bit-equal "
                 f"to plain, relative error {rel:.3e} "
                 f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"consmax_lut {what} scale={scale}")

    # ---- times (CUDA events, L2 flushed before each call)
    rows, times = {}, {}
    for name, (shape, kw) in shapes.items():
        q, k, v, beta, gamma = data[name]
        reps = 10 if shape[1] >= 4096 else 30
        t = {"consmax": _time_ms(lambda: consmax_attention_op(
            q, k, v, beta, gamma, **kw), flush, reps)}
        t["consmax_plain"] = _time_ms(lambda: consmax_plain(
            q, k, v, beta, gamma, **kw), flush, 3)
        if not kw:
            t["merged"] = _time_ms(lambda: consmax_attention_op(
                q, k, v, beta, gamma, merged=True), flush, reps)
            t["softmax"] = _time_ms(lambda: softmax_attention_op(q, k, v),
                                    flush, reps)
            t["softmax_plain"] = _time_ms(lambda: softmax_plain(q, k, v),
                                          flush, 3)
            t["sdpa"] = _time_ms(lambda: sdpa(T(q), T(k), T(v),
                                              is_causal=True,
                                              enable_gqa=True), flush, reps)
        t["bound"], t["by"] = _attn_bound(*shape, causal=True,
                                          window=kw.get("window", 0))
        times[name] = t
        ratio = (f"; ConSmax/softmax time ratio "
                 f"{t['consmax'] / t['softmax']:.4f} (Eq. 2), "
                 f"{t['merged'] / t['softmax']:.4f} (Eq. 3)" if not kw else "")
        _log(f"[paper] {name} {kw or 'causal'}: consmax_attention "
             f"{t['consmax'] * 1e3:.1f} us (plain "
             f"{t['consmax_plain'] * 1e3:.1f} us)"
             + (f", merged (Eq. 3) {t['merged'] * 1e3:.1f} us, "
                f"softmax_attention {t['softmax'] * 1e3:.1f} us (plain "
                f"{t['softmax_plain'] * 1e3:.1f} us), "
                f"scaled_dot_product_attention {t['sdpa'] * 1e3:.1f} us"
                if not kw else "")
             + f"; bound {t['bound'] * 1e3:.2f} us by {t['by']}{ratio}; "
             f"share of the bound (bound / time): consmax_attention "
             f"{t['bound'] / t['consmax']:.3f}" + (
                 f", merged {t['bound'] / t['merged']:.3f}, "
                 f"softmax_attention {t['bound'] / t['softmax']:.3f}, "
                 f"scaled_dot_product_attention "
                 f"{t['bound'] / t['sdpa']:.3f}" if not kw else ""))
    head = times["qwen2-1.5b b=2 s=4096"]
    rows["consmax_attention"] = dict(
        max_abs_err=max(errs["consmax_attention"]), ms=head["consmax"],
        plain_ms=head["consmax_plain"], bound_ms=head["bound"],
        bound_by=head["by"], library_ms=None)
    rows["softmax_attention"] = dict(
        max_abs_err=max(errs["softmax_attention"]), ms=head["softmax"],
        plain_ms=head["softmax_plain"], bound_ms=head["bound"],
        bound_by=head["by"], library_ms=head["sdpa"])
    ms = _time_ms(lambda: consmax_lut_op(codes, c_dev, scale=lut_scale),
                  flush, 30)
    plain_ms = _time_ms(lambda: lut_product(codes, c_dev, *make_luts(
        lut_scale, "cuda")), flush, 3)
    bound, by = _bound_ms(5 * n_lut, 2 * n_lut, peak=PEAK_FP32_FLOPS)
    _log(f"[paper] consmax_lut n={n_lut}: {ms * 1e3:.1f} us (plain "
         f"{plain_ms * 1e3:.1f} us), bound {bound * 1e3:.2f} us by {by}")
    rows["consmax_lut"] = dict(max_abs_err=lut_err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound, bound_by=by, library_ms=None)
    return rows, counts


def model_phase():
    """Full-width qwen2-1.5b logits, both kernels vs the plain walks, on a
    small input: a ragged 64-token chunk per slot, then 4 decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    r = np.random.default_rng(1)
    toks = torch.tensor(r.integers(0, cfg.vocab_size, (2, 68)),
                        dtype=torch.int32, device="cuda")
    lens = torch.tensor([64, 41], dtype=torch.int32, device="cuda")
    outs = {}
    with torch.no_grad():
        for kernels in (False, True):
            kw = dict(decode_kernel=kernels, prefill_kernel=kernels,
                      merged=True)
            caches = T.init_caches(cfg, 2, 1024, device="cuda")
            lg, caches, _ = T.lm_apply(model, cfg, tokens=toks[:, :64],
                                    caches=caches, prefill_append=lens,
                                    logits_index=lens - 1, **kw)
            seq = [lg.float()]
            for t in range(4):
                idx = T.cache_index(caches)
                lg, caches, _ = T.lm_apply(model, cfg,
                                        tokens=toks[:, 64 + t:65 + t],
                                        caches=caches,
                                        positions=idx[:, None], **kw)
                seq.append(lg.float())
            outs[kernels] = torch.stack(seq)
    plain, kern = outs[False], outs[True]
    rel = float((kern - plain).norm() / plain.norm())
    ok = (bool(torch.isfinite(kern).all())
          and kern.shape == (5, 2, 1, cfg.vocab_size) and rel <= 2 ** -4)
    _log(f"[model] qwen2-1.5b logits, kernels vs plain walks: relative L2 "
         f"error {rel:.3e} (bound 2^-4: bf16 rounds at other places in the "
         f"two paths, compounded over 28 layers), max |diff| "
         f"{float((kern - plain).abs().max()):.3e} of max |logit| "
         f"{float(plain.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("model logits with kernels disagree")
    del model


# prefill_kernel ms per traced iteration recorded in PERF.md §5 when every
# prefill launch walked its KV rows unsplit (NVIDIA H100 80GB HBM3, 700 W)
UNSPLIT_PREFILL_MS = {"qwen2-1.5b": 3.29, "qwen2-1.5b paged bfloat16": 1.96,
                      "qwen2-1.5b paged int8": 2.22}


def _graph_log(tag, eng, *, graphed=True):
    """Log whether ``eng`` replayed its steps as CUDA graphs: its captures
    (seconds each), replays per iteration and graph pool; raise unless it
    ran as ``graphed`` says (every single-device engine is graphed unless
    built with ``cuda_graphs=False``), with at most 2 graphs and one
    signature per step, and one replay for every model step but each
    graph's first (eager) run."""
    nodes = getattr(eng, "graph_nodes", {})
    caps = ", ".join(
        f"{step}{' draw' if draw else ''} {sec:.3f} s"
        + (f", {nodes[step, draw][0]:,} nodes, {nodes[step, draw][1]} "
           f"conditional" if (step, draw) in nodes else "")
        for (step, draw), sec in eng.capture_seconds.items())
    it = max(eng.iterations, 1)
    _log(f"[graphs] {tag}: graphed {eng.graphed}; captures prefill "
         f"{eng.prefill_graphs}, decode {eng.decode_graphs}"
         + (f" ({caps})" if caps else "")
         + f"; {eng.graph_replays} replays over {eng.iterations} iterations "
         f"({eng.graph_replays / it:.2f} per iteration, {eng.model_steps} "
         f"model steps); graph pool "
         f"{eng.graph_pool_bytes / 2**20:.1f} MiB; signatures "
         f"{eng.prefill_cache_size} / {eng.decode_cache_size}")
    ok = (eng.graphed == graphed and eng.prefill_graphs <= 2
          and eng.decode_graphs <= 2
          and eng.prefill_cache_size <= 1 and eng.decode_cache_size <= 1
          and eng.graph_replays + eng.prefill_graphs + eng.decode_graphs
          == (eng.model_steps if graphed else 0))
    if not ok:
        raise AssertionError(f"{tag}: the engine's graph contract failed")


def _session_log(tag, sess, *, graphed=True):
    """Log whether the static ``sess`` replayed its decode step as CUDA
    graphs: its captures by (b, mode) (seconds each), replays, and per
    batch size the graph pool's and the held cache trees' MiB; raise
    unless it ran as ``graphed`` says, with at most one graph per (b,
    mode) and one replay for every decode step but each graph's first
    (eager) run."""
    nodes = getattr(sess, "graph_nodes", {})
    caps = ", ".join(
        f"b {b} {mode} {sec:.3f} s"
        + (f", {nodes[b, mode][0]:,} nodes, {nodes[b, mode][1]} conditional"
           if (b, mode) in nodes else "")
        for (b, mode), sec in sess.capture_seconds.items())
    per_b = "; ".join(
        f"b {b}: held caches {nbytes / 2**20:.1f} MiB, graph pool "
        f"{sess.graph_pool_bytes_of(b) / 2**20:.1f} MiB"
        for b, nbytes in sorted(sess.held_cache_bytes.items()))
    _log(f"[graphs] {tag}: graphed {sess.graphed}; decode graphs "
         f"{sess.decode_graphs}" + (f" ({caps})" if caps else "")
         + f"; {sess.graph_replays} replays over {sess.decode_steps} decode "
         f"steps; {per_b}")
    keys = list(sess.capture_seconds)
    ok = (sess.graphed == graphed and len(set(keys)) == len(keys)
          == sess.decode_graphs
          and sess.graph_replays + sess.decode_graphs
          == (sess.decode_steps if graphed else 0))
    if not ok:
        raise AssertionError(f"{tag}: the session's graph contract failed")


def _session_ms(sess, prompts, steps, **kw):
    """(tokens, ms per decode step, tok/s) of ``sess.generate(prompts,
    steps=steps)``: the step's ms is the wall time of that call less a
    one-token (prefill-only) call's, over ``steps - 1``; tok/s is the
    whole call's generated tokens over its wall."""
    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.generate(prompts, steps=n, **kw).cpu()
        return out, time.perf_counter() - t0
    _, t1 = timed(1)
    out, tn = timed(steps)
    return out, 1e3 * (tn - t1) / (steps - 1), out.numel() / tn


def trace_steps(eng, arch, *, skip, steps):
    """Where an engine iteration's time goes: ``steps`` iterations (after
    ``skip``) under ``torch.profiler``; device busy time is the union of
    the device events' intervals. The profiler adds host time, so the
    traced wall per step is an upper bound on the untraced one."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    replays = eng.graph_replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replays = eng.graph_replays - replays
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), defaultdict(float)
    for e in sorted(dev, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        by_name[e.name[:40]] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    walk_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "attn_walk_kernel" in e.name) / 1e3
    dec_ms = sum(e.time_range.elapsed_us() for e in dev
                 if "decode_partials" in e.name) / 1e3
    busy_ms = busy / 1e3
    _log(f"[trace] {arch}: {steps} engine iterations under torch.profiler: "
         f"wall {wall * 1e3 / steps:.1f} ms/iteration, device busy "
         f"{busy_ms / steps:.1f} ms/iteration (idle share "
         f"{1 - busy_ms / (wall * 1e3):.3f}), {len(dev) / steps:.0f} device "
         f"ops/iteration; prefill_kernel (the mainloop's "
         f"attn_walk_kernel) {walk_ms / steps:.2f} ms/iteration"
         + (f" (unsplit, PERF.md §5: {UNSPLIT_PREFILL_MS[arch]:.2f})"
            if arch in UNSPLIT_PREFILL_MS else "") + "; "
         f"decode_kernel (decode_partials) {dec_ms / steps:.2f} "
         f"ms/iteration; graphed {eng.graphed}, {replays / steps:.2f} "
         f"graph replays/iteration, graph pool "
         f"{eng.graph_pool_bytes / 2**20:.1f} MiB; device "
         f"time by kernel: "
         + ", ".join(f"{n} {t / 1e3 / steps:.2f} ms" for n, t in top))
    return dict(wall_ms=wall * 1e3 / steps, busy_ms=busy_ms / steps,
                idle=1 - busy_ms / (wall * 1e3))


def engine_phase(arch, *, max_seq, chunk, prompt_lens, new_tokens, seed,
                 trace=False, kv_block=None):
    """Serve ``prompt_lens`` greedy requests on the full-width ``arch``
    with both kernels; returns the launch counts of that run. ``trace``:
    afterwards, trace a few iterations of a fresh run of the same
    requests. ``kv_block``: then serve them again at that
    ``prefill_kv_block`` (solo == batched there too; the tokens that match
    the default's are counted, not gated: the shards' sum order differs)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_op
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.weights import init_params

    cfg = get_config(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    scfg = ServeConfig(max_slots=8, max_seq=max_seq, prefill_chunk=chunk,
                       decode_kernel=True, prefill_kernel=True,
                       score_norm=cfg.score_norm)
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]

    def serve(batch):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        uids = [eng.submit(prompts[i], new_tokens) for i in batch]
        consmax_decode_op.launches = consmax_prefill_op.launches = 0
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"consmax_decode": consmax_decode_op.launches,
                  "consmax_prefill": consmax_prefill_op.launches}
        _graph_log(f"{arch} engine, {len(uids)} requests, prefill_kv_block "
                   f"{scfg.prefill_kv_block}", eng)
        return eng, [results.get(u) for u in uids], wall, counts

    eng, toks, wall, counts = serve(range(len(prompts)))
    if any(t is None or len(t) != new_tokens for t in toks):
        raise AssertionError(f"{arch}: a request did not finish")
    chunks = sum(-(-n // chunk) for n in prompt_lens)
    if counts["consmax_prefill"] != chunks * cfg.n_layers:
        raise AssertionError(f"{arch}: prefill kernel launches {counts}")
    if counts["consmax_decode"] < cfg.n_layers:
        raise AssertionError(f"{arch}: decode kernel never launched")
    ttft = np.mean(list(eng.ttft.values()))
    gen = sum(len(t) for t in toks)
    _log(f"[engine] {arch}: {len(prompts)} requests, {sum(prompt_lens)} "
         f"prompt + {gen} generated tokens in {wall:.3f} s on one wall "
         f"clock: {gen / wall:.1f} generated tok/s, "
         f"{sum(prompt_lens) / wall:.1f} prompt tok/s, mean TTFT "
         f"{ttft:.3f} s; {chunks} prefill chunks, "
         f"{counts['consmax_decode'] // cfg.n_layers} decode steps; kernel "
         f"launches {counts}")
    del eng
    solo = min(range(len(prompts)), key=lambda i: prompt_lens[i])
    _, alone, _, _ = serve([solo])
    same = alone[0] == toks[solo]
    _log(f"[engine] {arch}: request {solo} served alone == served among "
         f"the others: {same}")
    if not same:
        raise AssertionError(f"{arch}: solo and batched tokens differ")
    if trace:
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for p in prompts:
            eng.submit(p, new_tokens)
        trace_steps(eng, arch, skip=8, steps=6)
    if kv_block is not None:
        import dataclasses
        scfg = dataclasses.replace(scfg, prefill_kv_block=kv_block)
        _, toks_b, wall, cb = serve(range(len(prompts)))
        if any(t is None or len(t) != new_tokens for t in toks_b) or (
                cb["consmax_prefill"] != chunks * cfg.n_layers):
            raise AssertionError(f"{arch} prefill_kv_block={kv_block}: "
                                 f"{cb}")
        _, alone, _, _ = serve([solo])
        same = alone[0] == toks_b[solo]
        match = sum(a == b for x, y in zip(toks, toks_b)
                    for a, b in zip(x, y))
        _log(f"[engine] {arch} at prefill_kv_block={kv_block}: "
             f"{len(prompts)} requests in {wall:.3f} s, kernel launches "
             f"{cb}; request {solo} alone == among the others: {same}; "
             f"{match} of {len(prompts) * new_tokens} tokens equal to the "
             f"default prefill_kv_block's")
        if not same:
            raise AssertionError(f"{arch} prefill_kv_block={kv_block}: "
                                 "solo and batched tokens differ")
    return counts


GRAPH_CELLS = (("qwen2-1.5b", False, "bfloat16"), ("qwen2-1.5b", True,
                                                    "bfloat16"),
               ("qwen2-1.5b", True, "int8"), ("gemma2-2b", False, "bfloat16"))


def graph_phase(smi, *, seed=14, new_tokens=16):
    """5b: each graphed engine against the same engine run eagerly
    (``cuda_graphs=False``) on the same six requests of 300-3000 prompt
    tokens, every other one sampled: qwen2-1.5b contiguous, paged bf16 and
    paged int8 (pages of 256), and gemma2-2b contiguous (dk 256, windows,
    softcaps); 8 slots x 8192 rows, chunk 512, random weights from
    ``seed``. Checked: graphed tokens == eager tokens, the graph contract
    (``_graph_log``). Printed: capture seconds per graph, the graph pool's
    MiB, and both runs' wall time."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    checks, models = {}, {}
    for arch, paged, kv in GRAPH_CELLS:
        if arch not in models:
            models.clear()
            torch.cuda.empty_cache()
            cfg = get_config(arch)
            models[arch] = (cfg, init_params(
                cfg, torch.Generator(device="cuda").manual_seed(seed),
                device="cuda"))
        cfg, model = models[arch]
        extra = dict(paged_kv=True, page_size=256, num_pages=128) if (
            paged) else {}
        scfg = ServeConfig(max_slots=8, max_seq=8192, prefill_chunk=512,
                           decode_kernel=True, prefill_kernel=True,
                           score_norm=cfg.score_norm, kv_cache_dtype=kv,
                           **extra)
        r = np.random.default_rng(seed)
        reqs = [(r.integers(0, cfg.vocab_size, int(n)).tolist(),
                 SamplingParams(**HOT, seed=400 + i) if i % 2 else None)
                for i, n in enumerate(r.integers(300, 3001, 6))]
        tag = f"{arch} {'paged' if paged else 'contiguous'} {kv}"
        toks, walls = {}, {}
        for graphs in (True, False):
            eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda",
                                           cuda_graphs=graphs)
            uids = [eng.submit(p, new_tokens, sampling=sp) for p, sp in reqs]
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            walls[graphs] = time.perf_counter() - t0
            toks[graphs] = [res.get(u) for u in uids]
            _graph_log(f"[graph] {tag} "
                       f"({'graphed' if graphs else 'cuda_graphs=False'})",
                       eng, graphed=graphs)
            del eng
            torch.cuda.empty_cache()
        checks[f"{tag}: graphed tokens == eager tokens"] = (
            toks[True] == toks[False]
            and all(t is not None and len(t) == new_tokens
                    for t in toks[True]))
        _log(f"[graph] {tag}: {len(reqs)} requests (3 sampled), graphed "
             f"{walls[True]:.3f} s, eager {walls[False]:.3f} s (each "
             f"graphed run includes its captures); tokens equal "
             f"{toks[True] == toks[False]}; on {smi}")
    del models
    torch.cuda.empty_cache()
    for name, ok in checks.items():
        _log(f"[graph] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("graph phase checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


def _cache_bytes(caches):
    """Bytes of the KV leaves (K/V, and a quantized cache's scales)."""
    return sum(t.numel() * t.element_size() for sup in caches
               for blk in sup.values()
               for key, t in blk["attn"].items() if key != "index")


def paged_engine_phase(*, seed=4, new_tokens=32, kv_dtype="bfloat16"):
    """Full-width qwen2-1.5b (28 layers, random weights from ``seed``) on the
    paged engine, its KV cache in ``kv_dtype`` (bf16, or int8 codes with
    per-row fp32 scales): 16 slots x 8192 rows over a pool of 128 pages of
    256 rows
    (a quarter of 16 x 8192, so admission waits for pages), prefix cache
    on (lru), both paged kernels, greedy. Traffic, in submit order: a
    2048-token page-aligned prefix P + 300 tokens (cold; the rest are
    submitted once its prefill has covered P, so P is cached), six P +
    100-1500-token suffixes (warm), P alone (fully cached: a 1-token tail
    re-score that copies the shared last page), P + 500 tokens with n=2,
    and six unrelated prompts of 200-6000 tokens. Checked: every request
    finishes, the pool drains, the cache hits and copies, the prefill
    token and kernel launch counts, the tokens equal the contiguous
    engine's on the same requests (same KV dtype) and one warm request's
    tokens served alone (cold) on a fresh paged engine, and both caches'
    bytes equal the reckoning from the shapes; then a few iterations of a
    fresh paged run are traced. Returns the kernels' launch counts of the
    paged run and of the contiguous run."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.weights import init_params

    arch, chunk, ps, npages, plen = "qwen2-1.5b", 512, 256, 128, 2048
    cfg = get_config(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    common = dict(max_slots=16, max_seq=8192, prefill_chunk=chunk,
                  decode_kernel=True, prefill_kernel=True,
                  score_norm=cfg.score_norm, kv_cache_dtype=kv_dtype)
    ops = _serving_ops()
    tag = f"[paged {kv_dtype}]"
    paged_cfg = ServeConfig(**common, paged_kv=True, page_size=ps,
                            num_pages=npages, prefix_cache=True,
                            prefix_evict="lru")
    r = np.random.default_rng(seed)

    def toks(n):
        return r.integers(0, cfg.vocab_size, n).tolist()

    P = toks(plen)
    # (prompt, n streams, prefix rows the paged engine skips)
    reqs = [(P + toks(300), 1, 0)]
    reqs += [(P + toks(int(n)), 1, plen)
             for n in r.integers(100, 1501, 6)]
    reqs += [(P, 1, plen - 1), (P + toks(500), 2, plen)]
    reqs += [(toks(int(n)), 1, 0) for n in r.integers(200, 6001, 6)]

    def serve(scfg, items, *, stage=True):
        """Serve ``items`` on a fresh engine; the first alone until its
        prefill has covered P (when ``stage``). Returns (engine, tokens per
        stream, wall seconds, kernel launches of the run)."""
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        uids = [eng.submit(items[0][0], new_tokens, n=items[0][1])]
        for _ in range(plen // chunk if stage else 0):
            eng.step()                         # one chunk per iteration
        if stage and eng.scheduler.slots[0].filled != plen:
            raise AssertionError("the first request has not covered P")
        uids += [eng.submit(p, new_tokens, n=n) for p, n, _ in items[1:]]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flat = [u for x in uids for u in (x if isinstance(x, list) else [x])]
        counts = {name: op.launches for name, op in ops.items()}
        _graph_log(f"{tag} {'paged' if scfg.paged_kv else 'contiguous'} "
                   f"engine, {len(flat)} requests", eng)
        return eng, [results.get(u) for u in flat], wall, counts

    eng, paged_toks, wall, all_counts = serve(paged_cfg, reqs)
    counts = {k: all_counts[k] for k in ("consmax_decode_paged",
                                         "consmax_prefill_paged")}
    if all_counts["consmax_decode"] or all_counts["consmax_prefill"]:
        raise AssertionError("paged engine launched a contiguous kernel")
    pool = eng.pool
    streams = [(p, skip) for p, n, skip in reqs for _ in range(n)]
    if any(t is None or len(t) != new_tokens for t in paged_toks):
        raise AssertionError("paged engine: a request did not finish")
    cold_total = sum(len(p) for p, _ in streams)
    full = sum(1 for p, skip in streams if skip == len(p) - 1)
    chunks = sum(-(-(len(p) - skip) // chunk) for p, skip in streams)
    checks = {
        "pool drained (free_pages == 128)": pool.free_pages == npages,
        "prefix_hit_rows >= 9 x 2048": pool.prefix_hit_rows >= 9 * plen,
        "cow_copies >= 1": pool.cow_copies >= 1,
        "prefilled_tokens == cold total - hit rows + tail re-scores":
            eng.prefilled_tokens == cold_total - pool.prefix_hit_rows + full,
        "paged prefill launches == 28 x chunks":
            counts["consmax_prefill_paged"] == cfg.n_layers * chunks,
        "paged decode launches >= 28":
            counts["consmax_decode_paged"] >= cfg.n_layers,
    }
    gen = sum(len(t) for t in paged_toks)
    ttft = np.mean(list(eng.ttft.values()))
    pool_bytes = _cache_bytes(eng.caches)
    per_row = 2 * cfg.head_dim_ if kv_dtype == "bfloat16" else (
        cfg.head_dim_ + 4)                    # per KV head, K or V
    reckoned = cfg.n_layers * cfg.n_kv_heads * per_row * 2
    checks[f"pool bytes == {npages + 1} pages x {ps} rows x reckoning"] = (
        pool_bytes == (npages + 1) * ps * reckoned)
    _log(f"{tag} {arch}: {len(streams)} requests, {cold_total} prompt "
         f"tokens ({eng.prefilled_tokens} prefilled, "
         f"{pool.prefix_hit_rows} rows from cached pages, "
         f"{pool.cow_copies} cow copies, {pool.evictions} evictions) + "
         f"{gen} generated in {wall:.3f} s: {gen / wall:.1f} generated "
         f"tok/s, {cold_total / wall:.1f} prompt tok/s, mean TTFT "
         f"{ttft:.3f} s; {chunks} prefill chunks; peak page occupancy "
         f"{pool.peak_in_use / npages:.3f} ({pool.peak_in_use} of {npages} "
         f"pages), peak reserved {pool.peak_reserved} pages; pool "
         f"{pool_bytes / 2**20:.1f} MiB (K/V + scales + index); kernel "
         f"launches {counts}")
    del eng
    torch.cuda.empty_cache()

    ceng, cont_toks, cwall, ccounts = serve(ServeConfig(**common), reqs)
    cont_bytes = _cache_bytes(ceng.caches)
    cttft = np.mean(list(ceng.ttft.values()))
    _log(f"{tag} {arch} contiguous engine, same requests and order: "
         f"{cwall:.3f} s, {gen / cwall:.1f} generated tok/s, "
         f"{cold_total / cwall:.1f} prompt tok/s, mean TTFT {cttft:.3f} s, "
         f"{ceng.prefilled_tokens} prefilled tokens; cache "
         f"{cont_bytes / 2**20:.1f} MiB; kernel launches {ccounts}")
    del ceng
    torch.cuda.empty_cache()
    checks["tokens == contiguous engine's"] = paged_toks == cont_toks
    checks["contiguous cache bytes == 16 x 8192 rows x reckoning"] = (
        cont_bytes == 16 * 8192 * reckoned)
    checks["contiguous engine ran both contiguous kernels only"] = (
        min(ccounts["consmax_decode"], ccounts["consmax_prefill"])
        >= cfg.n_layers and not ccounts["consmax_decode_paged"]
        and not ccounts["consmax_prefill_paged"])
    ccounts = {k: ccounts[k] for k in ("consmax_decode", "consmax_prefill")}

    solo = 3                                   # a warm P + suffix request
    _, alone, _, _ = serve(paged_cfg, [reqs[solo]], stage=False)
    name = f"request {solo} alone (cold) == served warm among the others"
    checks[name] = alone[0] == paged_toks[solo]
    for name, ok in checks.items():
        _log(f"{tag} check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("paged engine checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))

    eng = ContinuousBatchingEngine(cfg, paged_cfg, model, device="cuda")
    for p, n, _ in reqs:
        eng.submit(p, new_tokens, n=n)
    trace_steps(eng, f"{arch} paged {kv_dtype}", skip=8, steps=6)
    return counts, ccounts


def gpt2_fp8_engine_phase(*, seed=3, new_tokens=16):
    """Full-width gpt2-consmax (random weights from ``seed``) served from an
    fp8_e4m3 KV cache with both kernels, 6 greedy requests (20-999 prompt
    tokens): on the contiguous engine (8 slots x 1024 rows, chunk 128) and
    on the paged engine (page size 128, 64 pages, prefix cache on). Checked:
    every request finishes, both engines give the same tokens, one request
    served alone equals its tokens served among the others, and each run
    went through its two fp8 kernels. Returns the launch counts of both
    runs."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.weights import init_params

    cfg = get_config("gpt2-consmax")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    common = dict(max_slots=8, max_seq=1024, prefill_chunk=128,
                  decode_kernel=True, prefill_kernel=True,
                  kv_cache_dtype="fp8_e4m3", score_norm=cfg.score_norm)
    cfgs = {"contiguous": ServeConfig(**common),
            "paged": ServeConfig(**common, paged_kv=True, page_size=128,
                                 num_pages=64)}
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 700, 131, 256, 999, 64)]
    ops = _serving_ops()

    def serve(scfg, batch):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for op in ops.values():
            op.launches = 0
        uids = [eng.submit(prompts[i], new_tokens) for i in batch]
        results = eng.run()
        torch.cuda.synchronize()
        _graph_log(f"[fp8] gpt2-consmax fp8_e4m3 "
                   f"{'paged' if scfg.paged_kv else 'contiguous'} engine, "
                   f"{len(uids)} requests", eng)
        return ([results.get(u) for u in uids],
                {n: op.launches for n, op in ops.items()})

    toks, counts = {}, {}
    for kind, scfg in cfgs.items():
        toks[kind], counts[kind] = serve(scfg, range(len(prompts)))
    alone, _ = serve(cfgs["contiguous"], [2])
    checks = {
        "every request finished": all(
            t is not None and len(t) == new_tokens
            for t in toks["contiguous"] + toks["paged"]),
        "paged tokens == contiguous tokens":
            toks["paged"] == toks["contiguous"],
        "request 2 alone == served among the others":
            alone[0] == toks["contiguous"][2],
        "contiguous run: fp8 contiguous kernels only": min(
            counts["contiguous"]["consmax_decode"],
            counts["contiguous"]["consmax_prefill"]) >= cfg.n_layers
            and not counts["contiguous"]["consmax_decode_paged"],
        "paged run: fp8 paged kernels only": min(
            counts["paged"]["consmax_decode_paged"],
            counts["paged"]["consmax_prefill_paged"]) >= cfg.n_layers
            and not counts["paged"]["consmax_decode"],
    }
    _log(f"[fp8] gpt2-consmax fp8_e4m3 engines: kernel launches {counts}")
    for name, ok in checks.items():
        _log(f"[fp8] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("fp8 engine checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))
    return counts


def perplexity_phase(*, seed=5, n_tokens=128, model=None, toks=None,
                     what="random weights"):
    """The reference's quantized-cache accuracy gate
    (``tests/test_quantized_kv.py:285``) on the card, at full width:
    gpt2-consmax with random weights from ``seed`` (or ``model``), a
    ``n_tokens``-token sequence (random from ``seed``, or ``toks``)
    teacher-forced through ``make_serve_fns``'s logits-returning
    ``decode_step`` (both kernels on, so every K/V row is written to and
    read back from the cache dtype). int8-KV perplexity within 1 % of
    bf16-KV's; fp8_e4m3's printed beside them. Returns the perplexities."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.weights import init_params

    cfg = get_config("gpt2-consmax")
    if model is None:
        model = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
    if toks is None:
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    n_tokens)
    n_tokens = len(toks)
    ppl = {}
    for kv in ("bfloat16", "int8", "fp8_e4m3"):
        scfg = ServeConfig(max_seq=n_tokens + 2, max_slots=1,
                           kv_cache_dtype=kv, fused_sampling=False,
                           decode_kernel=True, prefill_kernel=True,
                           score_norm="consmax")
        init_caches, _, decode_step, _ = make_serve_fns(cfg, scfg,
                                                        device="cuda")
        caches = init_caches(1)
        nll = torch.zeros((), dtype=torch.float64, device="cuda")
        for t in range(n_tokens - 1):
            logits, caches = decode_step(model, caches, {
                "tokens": torch.tensor([[toks[t]]], dtype=torch.int32,
                                       device="cuda")})
            logp = torch.log_softmax(logits[0].float(), dim=-1)
            nll -= logp[int(toks[t + 1])].double()
        ppl[kv] = float(torch.exp(nll / (n_tokens - 1)))
    rel = {kv: abs(ppl[kv] - ppl["bfloat16"]) / ppl["bfloat16"]
           for kv in ("int8", "fp8_e4m3")}
    ok = all(np.isfinite(list(ppl.values()))) and rel["int8"] <= 0.01
    _log(f"[ppl] gpt2-consmax (full width, {what}), {n_tokens} tokens "
         f"teacher-forced through make_serve_fns decode_step: perplexity "
         f"bf16-KV {ppl['bfloat16']:.4f}, int8-KV {ppl['int8']:.4f} "
         f"(relative {rel['int8']:.3e}, gate 1e-2), fp8_e4m3-KV "
         f"{ppl['fp8_e4m3']:.4f} (relative {rel['fp8_e4m3']:.3e}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8-KV perplexity gate failed")
    return ppl


def gemma2_engine_phase(*, seed=6, new_tokens=16):
    """Full-width gemma2-2b (26 layers, d 2304, 8 heads, 4 KV heads,
    head_dim 256, vocab 256,000, local / global windows of 4096, attention
    softcap 50, final softcap 30; random weights from ``seed``) with both
    kernels and a bf16 KV cache: 8 slots x 8192 rows, chunk 512, on the
    contiguous engine and on the paged engine (pages of 256, a 128-page
    pool, prefix cache on). Six requests of 300-7000 prompt tokens, three
    greedy and three sampled (temperature 0.8, top-k 50, top-p 0.95, min-p
    0.05, each on its own seed), three of them behind a shared 2048-token
    prefix (cached once the first has prefilled it). Checked: every request
    finishes; paged == contiguous tokens; fused == host-sampling tokens on
    the contiguous engine; one greedy and one sampled request served alone
    == served among the others; one prefill and one decode signature per
    engine; which kernels each engine launched. Returns the launch counts
    of the contiguous fused run (rows 1-2) and of the paged run (rows
    3-4)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    cfg = get_config("gemma2-2b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    chunk, ps, npages, plen = 512, 256, 128, 2048
    common = dict(max_slots=8, max_seq=8192, prefill_chunk=chunk,
                  decode_kernel=True, prefill_kernel=True,
                  score_norm=cfg.score_norm)
    cfgs = {"contiguous": ServeConfig(**common),
            "contiguous host-sampling": ServeConfig(**common,
                                                    fused_sampling=False),
            "paged": ServeConfig(**common, paged_kv=True, page_size=ps,
                                 num_pages=npages)}
    ops = _serving_ops()
    r = np.random.default_rng(seed)

    def toks(n):
        return r.integers(0, cfg.vocab_size, n).tolist()

    P = toks(plen)
    reqs = [(P + toks(300), None),
            (toks(300), SamplingParams(**HOT, seed=101)),
            (P + toks(952), None),
            (toks(7000), None),
            (P + toks(2000), SamplingParams(**HOT, seed=102)),
            (toks(4500), SamplingParams(**HOT, seed=103))]

    def serve(scfg, items, *, stage=True):
        """A fresh engine serves ``items``, the first alone until its
        prefill has covered P (when ``stage``)."""
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        uids = [eng.submit(items[0][0], new_tokens, sampling=items[0][1])]
        for _ in range(plen // chunk if stage else 0):
            eng.step()
        uids += [eng.submit(p, new_tokens, sampling=sp)
                 for p, sp in items[1:]]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: op.launches for name, op in ops.items()}
        _graph_log(f"[gemma2] gemma2-2b "
                   f"{'paged' if scfg.paged_kv else 'contiguous'} engine "
                   f"(fused sampling {scfg.fused_sampling}), {len(uids)} "
                   "requests", eng)
        return eng, [results.get(u) for u in uids], wall, counts

    out, counts, checks = {}, {}, {}
    for kind, scfg in cfgs.items():
        eng, out[kind], wall, counts[kind] = serve(scfg, reqs)
        gen = sum(len(t or []) for t in out[kind])
        cold = sum(len(p) for p, _ in reqs)
        hits = eng.pool.prefix_hit_rows if eng.pool is not None else 0
        _log(f"[gemma2] gemma2-2b {kind} engine: {len(reqs)} requests, "
             f"{cold} prompt tokens ({eng.prefilled_tokens} prefilled, "
             f"{hits} rows from cached pages) + {gen} generated in "
             f"{wall:.3f} s: {gen / wall:.1f} generated tok/s, "
             f"{cold / wall:.1f} prompt tok/s, mean TTFT "
             f"{np.mean(list(eng.ttft.values())):.3f} s; prefill / decode "
             f"signatures {eng.prefill_cache_size} / "
             f"{eng.decode_cache_size}; kernel launches {counts[kind]}")
        checks[f"{kind}: every request finished"] = all(
            t is not None and len(t) == new_tokens for t in out[kind])
        checks[f"{kind}: prefill_cache_size == decode_cache_size == 1"] = (
            eng.prefill_cache_size == eng.decode_cache_size == 1)
        del eng
        torch.cuda.empty_cache()
    c, pg = counts["contiguous"], counts["paged"]
    chunks = sum(-(-len(p) // chunk) for p, _ in reqs)
    checks["contiguous: prefill launches == 26 x chunks, decode >= 26, no "
           "paged kernel"] = (
        c["consmax_prefill"] == cfg.n_layers * chunks
        and c["consmax_decode"] >= cfg.n_layers
        and not c["consmax_decode_paged"] and not c["consmax_prefill_paged"])
    checks["paged: paged kernels only, each >= 26"] = (
        min(pg["consmax_decode_paged"], pg["consmax_prefill_paged"])
        >= cfg.n_layers and not pg["consmax_decode"]
        and not pg["consmax_prefill"])
    checks["paged tokens == contiguous tokens"] = (
        out["paged"] == out["contiguous"])
    checks["host-sampling tokens == fused tokens"] = (
        out["contiguous host-sampling"] == out["contiguous"])
    for i in (2, 1):                        # a greedy and a sampled request
        _, alone, _, _ = serve(cfgs["contiguous"], [reqs[i]], stage=False)
        kind = "sampled" if reqs[i][1] else "greedy"
        checks[f"{kind} request {i} alone == served among the others"] = (
            alone[0] == out["contiguous"][i])
    for name, ok in checks.items():
        _log(f"[gemma2] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("gemma2-2b engine checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))
    return {**{k: c[k] for k in ("consmax_decode", "consmax_prefill")},
            **{k: pg[k] for k in ("consmax_decode_paged",
                                  "consmax_prefill_paged")}}


def session_phase(*, seed=7, steps=16):
    """``ServeSession`` at full-width qwen2-1.5b (random weights from
    ``seed``), b 4 x 512-token prompts, ``steps`` tokens, compute in fp32
    (TF32 off; the plain walks, since the kernels take bf16): fused ==
    host-sampling tokens (sampled, whole prompts); row r of a ragged batch
    (lengths 512, 200, 377, 64; sampled) == prompt r served alone (a batch
    of one, its length given, seed + r); the session's greedy tokens
    (ragged path) == the continuous engine's (4 slots) on the same prompts.
    The sessions replay their decode step as CUDA graphs (one per (b,
    mode): b 4 and b 1 take turns) and the engine its steps; the fused
    session's tokens == the same session run eagerly
    (``cuda_graphs=False``), and the graph contracts hold.

    Why the ragged path for "alone", and fp32: whole-prompt prefill attends
    the unrounded K/V and only writes the bf16 cache, while the ragged and
    the engine's append paths attend the bf16 cache, so the two differ at
    bf16 rounding and a sampled or greedy token of the random-weight model
    can flip between them (seen on the card); and at bf16 compute a batch
    of one goes through GEMMs of another shape than a batch of four, which
    cuBLAS may sum in another order. fp32 keeps those near 1e-7."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeSession
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b", compute_dtype="float32")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    scfg = ServeConfig(max_seq=512 + steps + 8, score_norm=cfg.score_norm)
    r = np.random.default_rng(seed)
    prompts = torch.tensor(r.integers(0, cfg.vocab_size, (4, 512)),
                           dtype=torch.int32, device="cuda")
    sp = SamplingParams(**HOT, seed=seed)
    out, walls = {}, {}
    for kind, fused, graphs in (("fused", True, True), ("host", False, True),
                                ("fused eager", True, False)):
        sess = ServeSession(cfg, dataclasses.replace(
            scfg, fused_sampling=fused), model, device="cuda",
            cuda_graphs=graphs)
        sess.generate(prompts[:, :8], steps=2, sampling=sp)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kind] = sess.generate(prompts, steps=steps, sampling=sp).cpu()
        walls[kind] = time.perf_counter() - t0
        _session_log(f"[session] qwen2-1.5b fp32 {kind}", sess,
                     graphed=graphs)
    sess = ServeSession(cfg, scfg, model, device="cuda")
    lens = [512, 200, 377, 64]
    ragged = sess.generate(prompts, steps=steps, sampling=sp,
                           lengths=lens).cpu()
    alone = [sess.generate(prompts[i:i + 1, :n], steps=steps, lengths=[n],
                           sampling=dataclasses.replace(sp, seed=sp.seed + i)
                           ).cpu()[0] for i, n in enumerate(lens)]
    whole = [sess.generate(prompts[i:i + 1, :n], steps=steps,
                           sampling=dataclasses.replace(sp, seed=sp.seed + i)
                           ).cpu()[0] for i, n in enumerate(lens)]
    first = [next((t for t in range(steps) if w[t] != g[t]), None)
             for w, g in zip(whole, ragged)]
    _log(f"[session] not gated: prompt r alone through whole-prompt prefill "
         f"(unrounded K/V) vs ragged row r (bf16 cache): first differing "
         f"step per row {first} (None = equal)")
    greedy = sess.generate(prompts, steps=steps, lengths=[512] * 4).cpu()
    _session_log("[session] qwen2-1.5b fp32, b 4 and b 1 in turn", sess)
    eng = ContinuousBatchingEngine(cfg, dataclasses.replace(
        scfg, max_slots=4, prefill_chunk=512), model, device="cuda")
    uids = [eng.submit(p.tolist(), steps) for p in prompts]
    results = eng.run()
    _graph_log("[session] qwen2-1.5b fp32 continuous engine (plain walks)",
               eng)
    n = 4 * steps
    _log(f"[session] qwen2-1.5b ServeSession (fp32 compute), b 4 x 512 "
         f"prompt tokens, {steps} steps (graphed unless eager): "
         + ", ".join(f"{kind} {w:.3f} s ({n / w:.1f} tok/s)"
                     for kind, w in walls.items())
         + f"; continuous engine signatures {eng.prefill_cache_size} / "
         f"{eng.decode_cache_size}")
    checks = {
        "fused == host-sampling tokens": torch.equal(out["fused"],
                                                     out["host"]),
        "graphed fused == eager fused tokens": torch.equal(
            out["fused"], out["fused eager"]),
        "ragged row r == prompt r served alone (all 4)": all(
            torch.equal(ragged[i], a) for i, a in enumerate(alone)),
        "greedy session tokens == continuous engine tokens": (
            greedy.tolist() == [results[u] for u in uids]),
        "continuous engine: one prefill and one decode signature":
            eng.prefill_cache_size == eng.decode_cache_size == 1,
    }
    for name, ok in checks.items():
        _log(f"[session] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("ServeSession checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


SESSION_CELLS = (
    # (tag, arch, config overrides, ServeConfig overrides, b, prompt, steps)
    ("qwen2-1.5b decode kernel", "qwen2-1.5b", {},
     dict(decode_kernel=True), 4, 512, 32),
    ("qwen2-1.5b plain decode", "qwen2-1.5b", {}, {}, 4, 512, 32),
    ("gpt2-consmax softmax", "gpt2-consmax", dict(score_norm="softmax"),
     dict(max_seq=1024), 4, 512, 32),
    ("gpt2-consmax softermax", "gpt2-consmax", dict(score_norm="softermax"),
     dict(max_seq=1024), 4, 512, 32),
    ("jamba (smoke)", "jamba-1.5-large-398b", dict(smoke=True), {}, 4, 64,
     16),
)


def session_graph_phase(smi, *, seed=15):
    """13b: ``ServeSession`` graphed against the same session run eagerly
    (``cuda_graphs=False``), b 4, bf16, random weights from ``seed``:
    qwen2-1.5b at full width with the decode kernel (row 1) and with the
    plain decode (``decode_attention``), both at the default max_seq of
    32,768 (the held cache tree's MiB printed); gpt2-consmax at full width
    with ``score_norm`` softmax and softermax (max_seq 1024); jamba at its
    smoke size (Mamba, MoE and attention leaves in one graph; the
    published model's MoE layers do not fit one card). Each session
    generates greedy and sampled tokens from the same prompts. Checked:
    graphed == eager tokens, at most one decode graph per (b, mode), one
    replay per decode step after each capture; the decode kernel's
    launches == (steps - 1) x layers in both runs. Printed: ms per decode
    step and tok/s, graphed and eager; capture seconds; the graph pool's
    and the held caches' MiB. Returns the decode kernel's launches of the
    graphed greedy run."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    checks, launches = {}, None
    for tag, arch, over, serve, b, prompt, steps in SESSION_CELLS:
        cfg = get_config(arch, **over)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            seed), device="cuda")
        scfg = ServeConfig(score_norm=cfg.score_norm, **serve)
        prompts = torch.tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (b, prompt)), dtype=torch.int32,
            device="cuda")
        sp = SamplingParams(**HOT, seed=seed)
        toks, ms, tps, counts = {}, {}, {}, {}
        for graphs in (True, False):
            sess = ServeSession(cfg, scfg, model, device="cuda",
                                cuda_graphs=graphs)
            sess.generate(prompts[:, :16], steps=3)           # warm-up
            consmax_decode_op.launches = 0
            greedy, ms[graphs], tps[graphs] = _session_ms(sess, prompts,
                                                          steps)
            counts[graphs] = consmax_decode_op.launches
            sampled = sess.generate(prompts, steps=steps, sampling=sp).cpu()
            toks[graphs] = (greedy, sampled)
            _session_log(f"[session-graph] {tag} "
                         f"({'graphed' if graphs else 'cuda_graphs=False'})",
                         sess, graphed=graphs)
            del sess
            torch.cuda.empty_cache()
        same = all(torch.equal(a, e) for a, e in zip(toks[True],
                                                     toks[False]))
        checks[f"{tag}: graphed tokens == eager tokens"] = same
        if serve.get("decode_kernel"):
            want = (steps - 1) * cfg.n_layers
            checks[f"{tag}: decode kernel launches == (steps - 1) x "
                   "layers, graphed and eager"] = (
                counts[True] == counts[False] == want)
            launches = counts[True]
        _log(f"[session-graph] {tag}: b {b} x {prompt} prompt tokens, "
             f"{steps} steps: graphed {ms[True]:.3f} ms per decode step "
             f"({tps[True]:.1f} tok/s), eager {ms[False]:.3f} ms "
             f"({tps[False]:.1f} tok/s), x{ms[False] / ms[True]:.2f}; "
             f"decode kernel launches {counts}; tokens equal {same}; on "
             f"{smi}")
        del model
        torch.cuda.empty_cache()
    for name, ok in checks.items():
        _log(f"[session-graph] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("session graph checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))
    return launches


def _engine_ab(tag, cfg, scfg, model, reqs, new_tokens, smi, *, skip=4,
               steps=3, trace=True, trace_eager=True):
    """Serve ``reqs`` ((prompt, sampling) pairs) on ``scfg``'s engine
    graphed and with ``cuda_graphs=False``. The graphed engine serves them
    twice (the first pass captures its graphs; the second, timed, only
    replays) and the eager one once. Returns ({graphed: tokens of each
    pass}, the graphed engine's ``graph_nodes``: (nodes, conditional
    nodes) per graph); logs each engine's graph contract and the timed
    pass's generated tok/s and wall ms per iteration; with ``trace``, then
    ``steps`` traced iterations (after ``skip``) of the same requests on
    the same engine (the eager one too unless ``trace_eager`` is False):
    wall and device-busy ms per iteration, the idle share."""
    from repro_torch.serve.engine import ContinuousBatchingEngine

    toks, nodes = {}, {}
    for graphs in (True, False):
        mode = "graphed" if graphs else "cuda_graphs=False"
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda",
                                       cuda_graphs=graphs)
        toks[graphs] = []
        for _ in range(2 if graphs else 1):
            uids = [eng.submit(p, new_tokens, sampling=sp) for p, sp in reqs]
            iters = eng.iterations
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            toks[graphs].append([res.get(u) for u in uids])
        iters = eng.iterations - iters
        gen = sum(len(t or ()) for t in toks[graphs][-1])
        _graph_log(f"{tag} ({mode})", eng, graphed=graphs)
        if graphs:
            nodes = eng.graph_nodes
        line = (f"{tag} ({mode}): {len(reqs)} requests, {gen} generated "
                f"tokens in {wall:.3f} s over {iters} iterations"
                + (" (the second pass: graphs captured)" if graphs else "")
                + f": {gen / wall:.1f} generated tok/s, "
                f"{1e3 * wall / iters:.2f} ms/iteration")
        if trace and (graphs or trace_eager):
            for p, sp in reqs:
                eng.submit(p, new_tokens, sampling=sp)
            t = trace_steps(eng, f"{tag} ({mode})", skip=skip, steps=steps)
            line += (f"; traced wall {t['wall_ms']:.2f} ms/iteration, "
                     f"device busy {t['busy_ms']:.2f} ms/iteration, idle "
                     f"share {t['idle']:.3f}")
        del eng
        _log(f"{line}; on {smi}")
        torch.cuda.empty_cache()
    return toks, nodes


def _walk_nodes_ok(nodes, layers, blocks):
    """Whether every graph in ``nodes`` (``graph_nodes``) holds one
    conditional node per walk block and layer: ``blocks[step]`` blocks per
    layer (0 where the step does not walk)."""
    return bool(nodes) and all(cond == layers * blocks[step]
                               for (step, _), (_, cond) in nodes.items())


def _replay_kernels(graph, tries=5):
    """Device kernels of one replay of ``graph`` (``torch.profiler``): a
    trace holds a warm-up replay, a marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``) and the replay counted, whose kernels are the device
    events after the marker; the median of ``tries`` traces that hold the
    marker (a trace now and then misses some of its device records: at
    its start, or the marker too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for _ in range(3 * tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda._sleep(1000)
            graph.replay()
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(dev) if "spin_kernel" in e.name]
        if marks:
            counts.append(len(dev) - marks[-1] - 1)
        if len(counts) == tries:
            return sorted(counts)[tries // 2]
    raise AssertionError(f"{len(counts)} of {3 * tries} traces hold the "
                         "marker kernel")


def walk_graph_phase(smi, *, seed=18):
    """14's first gate: the plain walks alone, each block an IF node on the
    device's bound (``core/attention._walk_blocks``). ``append_attention``
    (8 slots x 8192 rows, ``kv_chunk`` 1024: 8 blocks) and
    ``paged_attention`` (pages of 256, 32 per slot) on qwen2-1.5b's heads
    (12 / 2, dk 128), a 16-row chunk, for consmax, softmax and softermax
    over bf16 and int8 K/V, each captured once (``graph_cond.graph``) and
    replayed after ``index``, ``lengths`` and the page table are rewritten
    in place at fills from one block to every block. Gates: each replay ==
    the eager sweep on the same inputs, bit for bit; one conditional node
    per block; the kernels a replay runs grow by one block's per filled
    block (a one-block replay runs one block's walk kernels). Logs each
    walk's replay ms at one block and at every block."""
    from repro_torch.configs.base import ConSmaxConfig
    from repro_torch.core import attention as TA
    from repro_torch.core.consmax import ConSmaxParams
    from repro_torch.kernels import cache_layout as CL
    from repro_torch.kernels.graph_cond import ops as GC

    b, L, hkv, g, dk, c = 8, 8192, 2, 6, 128, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = np.random.default_rng(seed)
    q = _rand(gen, (b, c, hkv * g, dk), dk ** -0.5)
    kf, vf = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    index = torch.zeros(b, dtype=torch.int32, device=dev)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    checks, notes = {}, {}
    rt, drv = GC.versions()
    _log(f"[walk] conditional nodes: library CUDA runtime {rt}, driver "
         f"{drv} (need {GC.MIN_CUDA}); torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}")
    for kv in ("bfloat16", "int8"):
        if kv == "int8":
            k, ks = CL.quantize_kv(kf.float(), torch.int8)
            v, vs = CL.quantize_kv(vf.float(), torch.int8)
            scales = dict(k_scale=ks, v_scale=vs)
        else:
            k, v, scales = kf, vf, {}
        for ps, kc in ((None, 1024), (256, 256)):
            n_blocks = L // kc
            table = full = None
            if ps:
                full = torch.tensor(r.permutation(b * n_blocks).astype(
                    np.int32), device=dev).view(b, n_blocks)
                table = full.clone()

                def pool(t):
                    out = torch.zeros((b * n_blocks + 1, ps) + t.shape[2:],
                                      dtype=t.dtype, device=dev)
                    out[full.long().flatten()] = t.reshape(
                        (b * n_blocks, ps) + t.shape[2:])
                    return out
                kk, vv = pool(k), pool(v)
                sc = {n: pool(t) for n, t in scales.items()}
            else:
                kk, vv, sc = k, v, scales
            for norm in ("consmax", "softmax", "softermax"):
                params = None
                if norm == "consmax":
                    params = ConSmaxParams(hkv * g, ConSmaxConfig(),
                                           device=dev)
                    with torch.no_grad():
                        params.beta.copy_(torch.tensor(
                            r.uniform(0.5, 2.5, hkv * g)))
                        params.gamma.copy_(torch.tensor(
                            r.uniform(20.0, 80.0, hkv * g)))
                common = dict(norm_kind=norm, norm_params=params, **sc)
                if ps:
                    def fn():
                        return TA.paged_attention(q, kk, vv, table, index,
                                                  lengths, **common)
                else:
                    def fn():
                        return TA.append_attention(q, kk, vv, index, lengths,
                                                   kv_chunk=kc, **common)

                def set_fill(f):
                    top = (f - 1) * kc + int(r.integers(1, kc + 1))
                    fills = np.minimum(r.integers(0, top + 1, b), top)
                    fills[-1] = top
                    n = np.minimum(r.integers(0, c + 1, b), fills)
                    n[1] = 0                              # inactive slot
                    index.copy_(torch.tensor(fills - n, dtype=torch.int32))
                    lengths.copy_(torch.tensor(n, dtype=torch.int32))
                    if ps:
                        t = full.clone()
                        for i, fill in enumerate(fills):
                            t[i, -(-int(fill) // ps):] = -1
                        table.copy_(t)

                tag = (f"{'paged' if ps else 'append'} {norm} {kv}, "
                       f"{n_blocks} blocks")
                side = torch.cuda.Stream()
                set_fill(n_blocks)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side), torch.no_grad():
                    fn()                                  # the warm-up sweep
                torch.cuda.synchronize()
                with torch.no_grad(), GC.graph(
                        pool=torch.cuda.graph_pool_handle(),
                        stream=side) as cap:
                    out = fn()
                same, kernels, ms, bad = True, {}, {}, []
                for f in range(1, n_blocks + 1):
                    set_fill(f)
                    cap.graph.replay()
                    torch.cuda.synchronize()
                    with torch.no_grad():
                        ref = fn()
                    if not torch.equal(out, ref):
                        same = False
                        bad.append(f)
                    if f in (1, 2, n_blocks):
                        kernels[f] = _replay_kernels(cap.graph)
                        ms[f] = _time_ms(cap.graph.replay, flush, 20)
                per_block = kernels[2] - kernels[1]
                notes[f"{tag}: replays == the eager sweep"] = (
                    f"fills {bad}")
                notes[f"{tag}: kernels grow by one block's per block"] = (
                    f"kernels by fill {kernels}")
                checks[f"{tag}: replays == the eager sweep"] = same
                checks[f"{tag}: one conditional node per block"] = (
                    cap.conditional == n_blocks)
                checks[f"{tag}: kernels grow by one block's per block"] = (
                    per_block > 0 and kernels[n_blocks]
                    == kernels[1] + (n_blocks - 1) * per_block)
                _log(f"[walk] {tag}: {cap.conditional} conditional of "
                     f"{cap.nodes} nodes; a replay runs {kernels[1]} device "
                     f"kernels at one block ({per_block} per further "
                     f"block), {kernels[n_blocks]} at {n_blocks}; "
                     f"{ms[1]:.4f} ms at one block, {ms[n_blocks]:.4f} ms "
                     f"at {n_blocks}; on {smi}")
                del cap, out
    for name, ok in checks.items():
        if not ok:
            _log(f"[walk] check {name}: False ({notes.get(name, '')})")
    _log(f"[walk] {sum(checks.values())} of {len(checks)} checks passed")
    if not all(checks.values()):
        raise AssertionError("bounded-walk replay checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


def softmax_engine_phase(smi, *, seed=8, new_tokens=16):
    """gpt2-consmax at full width served with ``score_norm`` softmax and
    softermax through the plain online walks (the kernels are ConSmax only),
    compute in fp32 (the contiguous decode materializes its score row, the
    paged one walks pages, so bf16 rounding would differ): 6 requests of
    20-999 prompt tokens (greedy) on the contiguous
    engine (8 x 1024 rows, chunk 128, ``kv_chunk`` 128) and the paged
    engine (pages of 128, no prefix cache, so a second pass is cold too),
    each graphed (each block of the plain walks an IF node on the
    device's bound, ``core/attention._walk_blocks``) and with
    ``cuda_graphs=False`` (the sweep) (``_engine_ab``); softmax's engines
    then trace 3 iterations each. Gates: paged == contiguous tokens,
    graphed == eager tokens (both graphed passes), the graph contract, one
    conditional node per walk block and layer in every graph."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.weights import init_params

    checks = {}
    for norm in ("softmax", "softermax"):
        cfg = get_config("gpt2-consmax", score_norm=norm,
                         compute_dtype="float32")
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            seed), device="cuda")
        r = np.random.default_rng(seed)
        reqs = [(r.integers(0, cfg.vocab_size, n).tolist(), None)
                for n in (20, 700, 131, 256, 999, 64)]
        common = dict(max_slots=8, max_seq=1024, prefill_chunk=128,
                      kv_chunk=128, score_norm=norm)
        toks = {}
        for kind, scfg in (("contiguous", ServeConfig(**common)),
                           ("paged", ServeConfig(**common, paged_kv=True,
                                                 page_size=128,
                                                 num_pages=64,
                                                 prefix_cache=False))):
            both, nodes = _engine_ab(
                f"[softmax] gpt2-consmax {norm} {kind}", cfg, scfg, model,
                reqs, new_tokens, smi, trace=norm == "softmax")
            # 8 blocks of 128 rows; the contiguous decode step
            # materializes its score row (decode_attention)
            checks[f"{norm} {kind}: a conditional node per walk block"] = (
                _walk_nodes_ok(nodes, cfg.n_layers, dict(
                    prefill=8, decode=8 if kind == "paged" else 0)))
            toks[kind] = both[False][0]
            checks[f"{norm} {kind}: every request finished"] = all(
                t is not None and len(t) == new_tokens for t in toks[kind])
            checks[f"{norm} {kind}: graphed tokens == eager tokens"] = all(
                t == toks[kind] for t in both[True])
        checks[f"{norm}: paged tokens == contiguous tokens"] = (
            toks["paged"] == toks["contiguous"])
    for name, ok in checks.items():
        _log(f"[softmax] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("softmax / softermax engine checks failed: "
                             + ", ".join(n for n, ok in checks.items()
                                         if not ok))


def plain_engine_phase(smi, *, seed=16, new_tokens=6):
    """14b: full-width qwen2-1.5b (28 layers, random weights from
    ``seed``, bf16) on the continuous engine with both kernel flags off,
    graphed, each block of the plain walks an IF node on the device's
    bound; eager, the walks sweep every block: 8 slots x 8192 rows, chunk
    512, contiguous (``kv_chunk`` 1024) and paged (128 pages of 256, no
    prefix cache); two requests of 300-500 prompt tokens, the second
    sampled; each engine graphed and with ``cuda_graphs=False``
    (``_engine_ab``), the graphed one traced (3 iterations after 4; the
    eager sweep's trace is ``tools/engine_ab.py``'s). Gates: graphed
    == eager tokens (both graphed passes), every request finished, the
    graph contract, one conditional node per walk block and layer in every
    graph."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    r = np.random.default_rng(seed)
    reqs = [(r.integers(0, cfg.vocab_size, int(n)).tolist(),
             SamplingParams(**HOT, seed=500 + i) if i % 2 else None)
            for i, n in enumerate(r.integers(300, 501, 2))]
    common = dict(max_slots=8, max_seq=8192, prefill_chunk=512,
                  kv_chunk=1024, score_norm=cfg.score_norm)
    checks = {}
    for kind, scfg in (("contiguous", ServeConfig(**common)),
                       ("paged", ServeConfig(**common, paged_kv=True,
                                             page_size=256, num_pages=128,
                                             prefix_cache=False))):
        both, nodes = _engine_ab(
            f"[plain] qwen2-1.5b kernel flags off {kind}", cfg, scfg, model,
            reqs, new_tokens, smi, trace_eager=False)
        # 8 blocks of 1024 rows, or 32 pages of 256; the contiguous decode
        # step materializes its score row (decode_attention)
        checks[f"{kind}: a conditional node per walk block"] = (
            _walk_nodes_ok(nodes, cfg.n_layers, dict(
                prefill=32 if kind == "paged" else 8,
                decode=32 if kind == "paged" else 0)))
        eager = both[False][0]
        checks[f"{kind}: every request finished"] = all(
            t is not None and len(t) == new_tokens for t in eager)
        checks[f"{kind}: graphed tokens == eager tokens"] = all(
            t == eager for t in both[True])
    del model
    torch.cuda.empty_cache()
    for name, ok in checks.items():
        _log(f"[plain] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("plain-walk engine checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


# Random123's threefry2x32_20 known answers: (key, counter) -> output
THREEFRY_KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]
# jax.random at jax 0.9.0 (jax_threefry_partitionable=True) on the CPU, for
# (seed, position): the key fold_in(fold_in(key(0), seed), position), the
# first four 32-bit draws random.bits(key, (4,)) and the fp32 bits of the
# first four random.gumbel(key, (4,)) values
JAX_DRAWS = {
    (0, 0): ((0xF84E8312, 0x2FEF64F3),
             (0x486056AF, 0xC9C0BF0F, 0x65C8094A, 0xEC729344),
             (0xBE6F55E3, 0x3FB7AB8C, 0x3DA58A46, 0x40221658)),
    (7, 4096): ((0x54962C14, 0x81D56FF2),
                (0x1385F957, 0x3EA5C9FA, 0x342C533E, 0xE0406C37),
                (0xBF71FEBE, 0xBEAF1093, 0xBEEDA0D0, 0x40016633)),
    (2**31, 511): ((0x33EA24D9, 0x573DA4CC),
                   (0x5945750F, 0x0E1C40F0, 0x7AFBFDFE, 0xD8C3BF75),
                   (0xBD5576F7, 0xBF8834E0, 0x3E9EF2A6, 0x3FE593A9)),
    (2**32 - 1, 8191): ((0xD159F6DD, 0xBBE1FFFE),
                        (0xB2B890B3, 0xF2DFB949, 0xE7BABC66, 0x7FFD1B77),
                        (0x3F830085, 0x403C709B, 0x40139E12, 0x3EBB96DB)),
}
HOT = dict(temperature=0.8, top_k=50, top_p=0.95, min_p=0.05)


def _device_ops(fn):
    """Device ops and device busy ms of one call of ``fn`` (torch.profiler,
    after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):                 # the first session warms the tracer
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3


def sampling_phase(*, vocab=256_000):
    """The threefry draw on the card: Random123's known answers and the
    reference's keys, draws and Gumbel bits (``JAX_DRAWS``); keys, 32-bit
    draws, uniforms and Gumbel noise bit-equal to the CPU's over a grid of
    16 seeds x 16 positions x 4099 draws; tokens on the card vs the CPU on
    one (32, ``vocab``) logits tensor with mixed greedy and sampled rows at
    two positions each (a flip must sit at a near-tie or a mask edge, and
    is counted and printed); the device ops and time of one greedy and one
    sampled epilogue over 8 rows, as a decode step runs it."""
    from repro_torch.serve import sampling as S

    def words(ws, dev):
        return [torch.tensor([w], dtype=torch.int64, device=dev) for w in ws]

    checks = {}
    checks["threefry2x32 Random123 known answers"] = all(
        tuple(int(w) for w in S.threefry2x32(*words(key + ctr, "cuda")))
        == out for key, ctr, out in THREEFRY_KAT)
    seeds = torch.tensor([sd for sd, _ in JAX_DRAWS], device="cuda")
    pos = torch.tensor([ps for _, ps in JAX_DRAWS], device="cuda")
    keys = S.slot_keys(seeds, pos)
    bits = S.random_bits(keys, 4)
    gum = S.gumbel(S.uniform(bits)).view(torch.int32).long() & 0xFFFFFFFF
    want = list(JAX_DRAWS.values())
    checks["keys, draws and Gumbel bits == jax.random's (4 vectors)"] = (
        [(int(a), int(b)) for a, b in zip(*keys)] == [w[0] for w in want]
        and bits.tolist() == [list(w[1]) for w in want]
        and gum.tolist() == [list(w[2]) for w in want])

    grid_s = torch.tensor([0, 1, 7, 99, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1]
                          + list(range(10**9, 10**9 + 8)))
    grid_p = torch.tensor([0, 1, 2, 511, 512, 4095, 4096, 8191]
                          + list(range(70_000, 70_008)))
    sd, ps = (t.reshape(-1) for t in torch.meshgrid(grid_s, grid_p,
                                                    indexing="ij"))
    per_dev = []
    for dev in ("cpu", "cuda"):
        k = S.slot_keys(sd.to(dev), ps.to(dev))
        draws = S.random_bits(k, 4099)
        u = S.uniform(draws)
        per_dev.append([*k, draws, u.view(torch.int32),
                        S.gumbel(u).view(torch.int32)])
    same = all(torch.equal(x, y.cpu()) for x, y in zip(*per_dev))
    checks["keys, draws, uniforms, Gumbel: card == CPU bits (256 keys x "
           "4099 draws)"] = same

    r = np.random.default_rng(11)
    b = 32
    logits = torch.tensor(r.standard_normal((b, vocab)) * 3,
                          dtype=torch.float32)
    logits[3, :2] = logits[3].max() + 0.25                  # a tie
    rows = [S.SamplingParams() if i % 4 == 0 else S.SamplingParams(
        temperature=float(r.choice([0.5, 0.8, 1.0, 1.5])),
        top_k=int(r.choice([0, 1, 50, 1000])),
        top_p=float(r.choice([1.0, 0.95, 0.5])),
        min_p=float(r.choice([0.0, 0.05])), seed=int(r.integers(0, 2**32)))
        for i in range(b)]
    flips, unexplained, n = 0, [], 0
    for step in range(2):
        position = torch.tensor(r.integers(0, 8192, b), dtype=torch.int32)
        bank = S.bank_of(rows, b)
        cpu = S.sample_tokens(logits, bank, position)
        gpu = S.sample_tokens(logits.cuda(), S.bank_of(rows, b, "cuda"),
                              position.cuda()).cpu()
        n += b
        for i in torch.nonzero(cpu != gpu).flatten().tolist():
            flips += 1
            t = max(float(bank["temperature"][i]), 0.0) or 1.0
            sc = S.apply_logits_masks(
                logits[i:i + 1] / t, bank["top_k"][i:i + 1],
                bank["top_p"][i:i + 1], bank["min_p"][i:i + 1])[0]
            g = S.gumbel(S.uniform(S.random_bits(S.slot_keys(
                bank["seed"][i:i + 1], position[i:i + 1]), vocab)))[0]
            z = sc + g
            a, c = int(cpu[i]), int(gpu[i])
            near = bool(torch.isinf(z[c])) or float(z[a] - z[c]) <= 1e-5 * (
                float(z[a].abs()) + 1.0)
            _log(f"[sampling] token flip, row {i} step {step}: cpu {a} "
                 f"card {c}, scores {float(z[a]):.7f} vs {float(z[c]):.7f} "
                 f"({'near-tie or mask edge' if near else 'NOT a near-tie'})")
            if not near:
                unexplained.append((i, step))
    checks[f"tokens card vs CPU: {flips} flips of {n} (all at near-ties)"] = (
        not unexplained)

    lg = logits[:8].cuda()
    pos8 = torch.arange(8, dtype=torch.int32, device="cuda") * 1000
    greedy, sampled = S.bank_init(8, "cuda"), S.bank_of(
        S.SamplingParams(**HOT, seed=5), 8, "cuda")
    ops = {}
    for name, bank in (("greedy", greedy), ("sampled", sampled)):
        n_ops, busy = _device_ops(lambda: S.sample_tokens(lg, bank, pos8))
        ms = _time_ms(lambda: S.sample_tokens(lg, bank, pos8),
                      torch.empty(1, device="cuda"), 20)
        ops[name] = (n_ops, busy, ms)
    _log(f"[sampling] epilogue over (8, {vocab}) logits: greedy "
         f"{ops['greedy'][0]} device ops, {ops['greedy'][1]:.3f} ms busy, "
         f"{ops['greedy'][2]:.3f} ms per call; sampled (temperature 0.8, "
         f"top-k 50, top-p 0.95, min-p 0.05) {ops['sampled'][0]} device ops, "
         f"{ops['sampled'][1]:.3f} ms busy, {ops['sampled'][2]:.3f} ms per "
         f"call (CUDA events, includes the host's one read of the bank's "
         f"temperatures)")
    for name, ok in checks.items():
        _log(f"[sampling] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("sampling checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


def _window_rows(lo_pos, hi_pos, kv_len, window):
    """Keys a query at each position in [lo_pos, hi_pos) sees, summed:
    rows < kv_len, causal, within ``window``."""
    return sum(min(p + 1, kv_len) - max(0, p - window + 1)
               for p in range(lo_pos, hi_pos))


def gemma2_kernel_phase(flush):
    """The four serving kernels at a gemma2-2b local layer's shapes (8 slots
    x 8192 rows, 8 heads, 4 KV heads, head_dim 256, window 4096, softcap 50;
    prefill chunk 512; page size 256): each against its plain version, the
    paged ones also bit for bit against the contiguous ones; times and
    bounds (the rows a window of 4096 leaves visible). Returns the rows of
    the result line."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref, consmax_decode_ref)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref, consmax_prefill_ref)

    gen = torch.Generator(device="cuda").manual_seed(40)
    b, L, H, hkv, dk, bk, c, ps, win = 8, 8192, 8, 4, 256, 256, 512, 256, 4096
    kw = dict(window=win, softcap=50.0, merged=True, scale=1.0)
    rows = {}
    lengths = torch.tensor([1, 300, 2348, 4096, 4097, 5000, 7016, 8192],
                           dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    err = _check("gemma2 decode dk=256 window=4096 softcap=50 b=8 L=8192",
                 consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk,
                                     **kw),
                 consmax_decode_ref(q.float(), k, v, lengths, beta, gamma,
                                    **kw),
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    live = sum(min(int(n), win) for n in lengths.tolist())
    io = 2 * b * H * dk * 2
    times = {
        "consmax_decode": (
            err, lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                             bk=bk, **kw),
            lambda: consmax_decode_ref(q, k, v, lengths, beta, gamma, **kw),
            live * hkv * dk * 2 * 2 + io, 4 * live * H * dk)}
    perr, (kp, vp, table) = _paged_decode_case(
        "gemma2 paged decode dk=256 window=4096 ps=256", q, k, v, lengths,
        beta, gamma, kw, bk=bk, ps=ps, num_pages=256)
    times["consmax_decode_paged"] = (
        perr, lambda: consmax_decode_paged_cuda(q, kp, vp, table, lengths,
                                                beta, gamma, bk=bk, **kw),
        lambda: consmax_decode_paged_ref(q, kp, vp, table, lengths, beta,
                                         gamma, **kw),
        live * hkv * dk * 2 * 2 + io + table.numel() * 4, 4 * live * H * dk)

    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[7:8].contiguous(), v[7:8].contiguous()
    errs, perrs = [], []
    for idx, n in [(0, 512), (3584, 512), (6144, 512), (7680, 512),
                   (4000, 200)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        errs.append(_check(
            f"gemma2 prefill dk=256 window=4096 c=512 index={idx} len={n}",
            consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                **kw)))
        e, pools = _paged_prefill_case(
            f"gemma2 paged prefill index={idx} len={n}", q1, k1, v1, ti, tn,
            beta, gamma, kw, ps=ps, num_pages=64)
        perrs.append(e)
        if idx == 6144:
            timed = (ti, tn, *pools)
    ti, tn, kp1, vp1, t1 = timed
    idx, n = 6144, 512
    pairs = _window_rows(idx, idx + n, idx + n, win)
    rows_read = idx + n - max(0, idx - win + 1)
    pbytes = rows_read * hkv * dk * 2 * 2 + 2 * c * H * dk * 2
    for name, (e, fn, plain, nbytes, flops) in times.items():
        bound, by = _bound_ms(nbytes, flops)
        rows[f"{name}[gemma2-2b]"] = dict(
            max_abs_err=e, ms=_time_ms(fn, flush, 50),
            plain_ms=_time_ms(plain, flush, 5), bound_ms=bound, bound_by=by)
    # both prefill kernels over the shard sweep (paged == contiguous bits
    # at every bk), timed at each
    ref = consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw)
    ref_absv = consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                   **kw)
    tag = f"gemma2 prefill dk=256 window=4096 c=512 index={idx}"
    for name, launch, e, nbytes, plain, same in (
            ("consmax_prefill",
             lambda bk, fb: consmax_prefill_cuda(
                 q1, k1, v1, ti, tn, beta, gamma, bk=bk, fill_bound=fb,
                 **kw), max(errs), pbytes,
             lambda: consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma,
                                         **kw), None),
            ("consmax_prefill_paged",
             lambda bk, fb: consmax_prefill_paged_cuda(
                 q1, kp1, vp1, t1, ti, tn, beta, gamma, bk=bk,
                 fill_bound=fb, **kw), max(perrs), pbytes + t1.numel() * 4,
             lambda: consmax_prefill_paged_ref(q1, kp1, vp1, t1, ti, tn,
                                               beta, gamma, **kw),
             lambda bk, out: _same_bits(
                 f"{tag} paged bk={bk}", out, consmax_prefill_cuda(
                     q1, k1, v1, ti, tn, beta, gamma, bk=bk, **kw)))):
        bound = _bound_ms(nbytes, 4 * pairs * H * dk)
        plain_ms = _time_ms(plain, flush, 5)
        sweep, e2 = _prefill_sweep(
            f"{tag} {name}", flush, launch, ref, ref_absv, k1.shape[1],
            same=same, bound=bound, plain_ms=plain_ms)
        rows[f"{name}[gemma2-2b]"] = dict(
            max_abs_err=max(e, e2), ms=sweep[SWEEP_BK[0]], plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1])
    return rows


WALK_KV = {"13__nv_bfloat16": ("bf16", 0), "a": ("int8", 1),
           "13__nv_fp8_e4m3": ("fp8_e4m3", 2)}
WALK_FORM = {"0": "Eq. 2", "1": "Eq. 3", "2": "softmax"}


def mainloop_report():
    """Each instantiation of the shared attention mainloop
    (``attn_walk_kernel``, csrc/attn_mainloop.cuh) in the three libraries
    that build it: registers (at launch, as ``ptxas -v`` reported them, and
    each role's after its setmaxnreg: the library's
    ``attn_walk_role_regs``), static and dynamic shared memory and spills.
    Fails on any spill, and on a two-consumer walk that does not start at
    the 168 registers its roles' setmaxnreg counts share."""
    import re

    from repro_torch.kernels import _build
    spills = []
    for lib_name in ("consmax_prefill", "consmax_attn", "softmax_attn"):
        lib = _build.load(lib_name)
        lib.attn_walk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.attn_walk_role_regs.argtypes = [ctypes.c_int] * 2
        rows = []
        for k in _build.ptxas_report(lib_name):
            m = re.search(r"attn_walk_kernelILi(\d+)ELi(\d)E(13__nv_bfloat16"
                          r"|a|13__nv_fp8_e4m3)\d+(Contig|Paged)RowsLi([12])E",
                          k["kernel"])
            if not m:
                continue
            dk, form, kv, rows_of, cons = m.groups()
            kv_name, kv_code = WALK_KV[kv]
            smem = lib.attn_walk_smem_bytes(int(dk), kv_code, int(cons))
            producer = lib.attn_walk_role_regs(int(cons), 1)
            consumer = lib.attn_walk_role_regs(int(cons), 0)
            name = (f"{lib_name} dk {dk} {WALK_FORM[form]} {kv_name} "
                    f"{rows_of}, {cons} consumer warpgroup"
                    f"{'s' if cons == '2' else ''}")
            roles = (f"producer {producer}, consumers {consumer}" if producer
                     else f"every role {k['registers']}")
            rows.append(
                f"{name}: {k['registers']} registers at launch ({roles}), "
                f"{smem} B dynamic + {k['smem']} B static shared memory, "
                f"spill stores/loads {k['spill_stores']}/"
                f"{k['spill_loads']} B")
            if k["spill_stores"] or k["spill_loads"]:
                spills.append(name)
            if producer and k["registers"] != 168:
                raise AssertionError(
                    f"{name}: {k['registers']} registers at launch, not the "
                    "168 that its roles' setmaxnreg counts share")
        if not rows:
            raise AssertionError(f"{lib_name}: no attn_walk_kernel in the "
                                 "ptxas report")
        log = _build.library_path(lib_name).with_suffix(".log").read_text()
        serial = log.count("wgmma.mma_async instructions are serialized")
        _log(f"[build] {lib_name} mainloop instantiations ({len(rows)}; "
             f"ptxas serialized the wgmmas of {serial}): " + "; ".join(rows))
    if spills:
        raise AssertionError("attention mainloop spills registers: "
                             + "; ".join(spills))


def decode_report():
    """Each instantiation of the decode kernel (``decode_partials``,
    consmax_decode.cu): registers, static and dynamic shared memory (at the
    engine's shard, bk 256) and spills, as ``ptxas -v`` reported them in
    this run's build."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.consmax_decode import ops as decode_ops
    lib = decode_ops._lib()
    rows = []
    for k in _build.ptxas_report("consmax_decode"):
        m = re.search(r"decode_partialsILi(\d+)ELb([01])E(13__nv_bfloat16|a|"
                      r"13__nv_fp8_e4m3)\d+(Contig|Paged)Rows", k["kernel"])
        if not m:
            continue
        dk, merged, kv, rows_of = m.groups()
        kv_name, kv_code = WALK_KV[kv]
        smem = lib.consmax_decode_smem_bytes(int(dk), kv_code,
                                             int(rows_of == "Paged"), 256)
        rows.append(f"dk {dk} {'Eq. 3' if merged == '1' else 'Eq. 2'} "
                    f"{kv_name} {rows_of}: {k['registers']} registers, "
                    f"{smem} B dynamic + {k['smem']} B static shared memory, "
                    f"spill stores/loads {k['spill_stores']}/"
                    f"{k['spill_loads']} B")
    if len(rows) != 60:
        raise AssertionError(f"consmax_decode: {len(rows)} decode_partials "
                             "instantiations in the ptxas report, not 60")
    _log(f"[build] consmax_decode decode_partials instantiations "
         f"({len(rows)}): " + "; ".join(rows))


F32_FORM = {"0": "Eq. 2", "1": "Eq. 3", "2": "softmax"}


def f32_report():
    """Each instantiation of the fp32 full-sequence kernel
    (``attn_f32_kernel``, csrc/attn_f32.cuh) in the two libraries that
    build it: registers, dynamic shared memory (the library's
    ``attn_f32_smem_bytes``, held equal to ``launch_plan.f32_layout``)
    and spills, as ``ptxas -v`` reported them in this run's build.
    Returns {(library, dk, form): report}."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import launch_plan as LP
    out = {}
    for lib_name in ("consmax_attn", "softmax_attn"):
        lib = _build.load(lib_name)
        lib.attn_f32_smem_bytes.argtypes = [ctypes.c_int]
        rows = []
        for k in _build.ptxas_report(lib_name):
            m = re.search(r"attn_f32_kernelILi(\d+)ELi(\d)E", k["kernel"])
            if not m:
                continue
            dk, form = int(m.group(1)), m.group(2)
            smem = lib.attn_f32_smem_bytes(dk)
            if smem != LP.f32_layout(dk)["smem"]:
                raise AssertionError(
                    f"{lib_name}: attn_f32 dk {dk}: the library's {smem} B "
                    f"!= the launch plan's {LP.f32_layout(dk)['smem']} B")
            out[(lib_name, dk, F32_FORM[form])] = dict(k, dyn_smem=smem)
            rows.append(f"dk {dk} {F32_FORM[form]}: {k['registers']} "
                        f"registers, {smem} B dynamic + {k['smem']} B static "
                        f"shared memory, spill stores/loads "
                        f"{k['spill_stores']}/{k['spill_loads']} B")
        if len(rows) != (10 if lib_name == "consmax_attn" else 5):
            raise AssertionError(f"{lib_name}: {len(rows)} attn_f32_kernel "
                                 "instantiations in the ptxas report")
        _log(f"[build] {lib_name} fp32 kernel instantiations ({len(rows)}): "
             + "; ".join(rows))
    return out


# ------------------------------------------------------------- training ----
# the paper's experiment (the port's examples/train_gpt2_consmax.py --paper)
GPT2_TRAIN = dict(global_batch=8, seq_len=256, lr=1e-3, warmup_steps=20,
                  total_steps=200, remat="none")
CARD_VS_CPU_RTOL = 1e-4
CARD_VS_CPU_NOTE = (
    "both sides run the same fp32 ops (TF32 off), summed in other orders "
    "by cuBLAS and the CPU BLAS: a dot product of K terms differs by up to "
    "~sqrt(K) u (u = 6e-8; K <= 2,048 tokens in a weight gradient) relative, "
    "~3e-6, and the loss, a mean over 2,048 tokens, by less; Adam's first "
    "steps are ~lr * sign(g) (lr <= 4.5e-4 in steps 0-9 of the warmup), so "
    "a component whose gradient sits at that noise level moves by ~1e-3 at "
    "most, which moves the loss by well under 1e-4 of itself; the CPU "
    "parity tests hold 8 steps to 1e-5 against the reference")
RESUME_RTOL = 1e-3          # only where an op has no deterministic kernel


def _hist_stats(hist, tokens, skip=5):
    """(mean ms per step past the first ``skip`` steps, tokens/s)."""
    sec = float(np.mean([h["sec"] for h in hist[skip:]]))
    return 1e3 * sec, tokens / sec


def _beta_gamma(model):
    sn = [blk.attn.score_norm for sup in model.blocks for blk in sup.values()]
    return (torch.cat([m.beta.detach().float() for m in sn]).cpu(),
            torch.cat([m.gamma.detach().float() for m in sn]).cpu())


def train_gpt2_phase(smi, *, steps=200):
    """15a: the paper's experiment on the card — gpt2-consmax at the
    paper's width (6 L, d 384, 6 heads, vocab 8,192), b 8 x s 256, bf16
    compute, trained with ConSmax and with Softmax for ``steps`` steps each
    through ``Trainer`` (weights from seed 0, the synthetic corpus of seed
    0). Gates: every loss finite, the last-10 mean below the first-10 mean
    for both. Printed: the ConSmax - Softmax gap beside the paper's, ms per
    step, tokens/s, how far beta and gamma moved. Returns the trained
    ConSmax ``LM``, its config and corpus."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    tcfg = TrainConfig(**GPT2_TRAIN)
    tokens = tcfg.global_batch * tcfg.seq_len
    last, keep = {}, None
    for norm in ("consmax", "softmax"):
        cfg = get_config("gpt2-consmax", score_norm=norm)
        tr = Trainer(cfg, tcfg, device="cuda", log_every=100)
        model = tr.state["params"]
        if norm == "consmax":
            beta0, gamma0 = _beta_gamma(model)
        t0 = time.perf_counter()
        hist = tr.run(steps)
        wall = time.perf_counter() - t0
        losses = np.array([h["loss"] for h in hist])
        first, last[norm] = losses[:10].mean(), losses[-10:].mean()
        ms, tps = _hist_stats(hist, tokens)
        ok = bool(np.isfinite(losses).all()) and last[norm] < first
        _log(f"[train] 15a gpt2-consmax ({norm}), b 8 x s 256, bf16, {steps} "
             f"steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first-10 "
             f"mean {first:.4f}, last-10 mean {last[norm]:.4f}); "
             f"{ms:.2f} ms/step, {tps:.0f} tokens/s (steps 5-{steps - 1}), "
             f"{wall:.1f} s wall; on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gpt2-consmax ({norm}) did not train")
        if norm == "consmax":
            beta1, gamma1 = _beta_gamma(model)
            db = (beta1 - beta0).abs()
            _log(f"[train] 15a learned ConSmax parameters, 36 heads: |beta "
                 f"- beta0| max {float(db.max()):.4f} mean "
                 f"{float(db.mean()):.4f} (beta0 in [{float(beta0.min()):.3f},"
                 f" {float(beta0.max()):.3f}]); gamma {float(gamma0.min()):.1f}"
                 f" -> [{float(gamma1.min()):.4f}, {float(gamma1.max()):.4f}]")
            keep = (model, cfg, tr.corpus)
        del tr
    gap = (last["consmax"] - last["softmax"]) / last["softmax"]
    _log(f"[train] 15a ConSmax - Softmax gap, last-10 means: "
         f"{last['consmax'] - last['softmax']:+.4f} ({100 * gap:+.2f} %) "
         f"after {steps} steps (paper: < 0.9 % after 10k iterations)")
    return keep


def card_vs_cpu_phase(smi, *, steps=10):
    """15a: the same ``steps`` training steps on the card and on the CPU —
    gpt2-consmax at the paper's width, fp32 compute (TF32 off), the same
    weights (drawn on the CPU from seed 0) and batches. Per-step loss
    within ``CARD_VS_CPU_RTOL`` relative."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.train.trainer import Trainer
    from repro_torch.weights import init_params

    cfg = get_config("gpt2-consmax", compute_dtype="float32")
    tcfg = TrainConfig(**GPT2_TRAIN)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    card_model = LM(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    out = {}
    for name, model in (("card", card_model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        out[name] = [h["loss"] for h in Trainer(
            cfg, tcfg, model=model, log_every=10 ** 9).run(steps)]
        _log(f"[train] 15a {steps} fp32 steps on the {name}: "
             f"{time.perf_counter() - t0:.1f} s (card: {smi})")
    rel = [abs(a - b) / abs(b) for a, b in zip(out["card"], out["cpu"])]
    ok = all(np.isfinite(out["card"])) and max(rel) <= CARD_VS_CPU_RTOL
    _log(f"[train] 15a card vs CPU, gpt2-consmax fp32, {steps} steps: "
         f"losses card {[round(x, 6) for x in out['card']]}, largest "
         f"relative difference {max(rel):.3e} at step {int(np.argmax(rel))} "
         f"(gate {CARD_VS_CPU_RTOL:g}: {CARD_VS_CPU_NOTE}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card and CPU training disagree")


def resume_child(*, k=5, n=5):
    """15b, run in its own process (``python3 chip_smoke.py
    --train-resume``) so that ``CUBLAS_WORKSPACE_CONFIG`` is set before
    CUDA starts and no other phase runs under deterministic algorithms:
    gpt2-consmax at the paper's width trains k + n steps straight; a
    second run trains k steps, saves, and a new ``Trainer`` on the same
    directory resumes at step k for n steps. Prints one JSON line: both
    runs' last n losses and the ops that warned that they have no
    deterministic implementation."""
    import tempfile
    import warnings

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = get_config("gpt2-consmax")
    tcfg = TrainConfig(**GPT2_TRAIN)
    kw = dict(device="cuda", log_every=10 ** 9)
    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory() as d:
        warnings.simplefilter("always")
        straight = [h["loss"] for h in Trainer(cfg, tcfg, **kw).run(k + n)]
        Trainer(cfg, tcfg, ckpt_dir=d, ckpt_every=k, **kw).run(k)
        tr = Trainer(cfg, tcfg, ckpt_dir=d, **kw)
        at = tr.step_index()
        resumed = [h["loss"] for h in tr.run(n)]
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    print(json.dumps({"resume": {"k": k, "at": at, "straight": straight[k:],
                                 "resumed": resumed, "warned": ops}}),
          flush=True)


def resume_phase():
    """15b: runs ``resume_child`` and holds its result: the new trainer
    resumed at step k, and its losses equal the uninterrupted run's bit for
    bit, or, if an op warned that it is not deterministic, within
    ``RESUME_RTOL`` relative (the op is named)."""
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--train-resume"], env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the resume run failed:\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["resume"]
    bits = res["resumed"] == res["straight"]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(res["resumed"], res["straight"]))
    ok = res["at"] == res["k"] and (bits or (res["warned"]
                                            and rel <= RESUME_RTOL))
    _log(f"[train] 15b resume (gpt2-consmax bf16, its own process, "
         f"use_deterministic_algorithms(True, warn_only=True), "
         f"CUBLAS_WORKSPACE_CONFIG=:4096:8): resumed at step {res['at']} "
         f"(saved at {res['k']}); next losses {res['resumed']} vs "
         f"uninterrupted {res['straight']}: bit-equal {bits}, largest "
         f"relative difference {rel:.3e}; ops without a deterministic "
         f"implementation: {res['warned'] or 'none'} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a resumed run differs from an uninterrupted "
                             "one")


def _op_device_ms(prof, names):
    total = 0.0
    for e in prof.key_averages():
        if e.key in names:
            total += getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
    return total / 1e3


def train_qwen2_phase(smi, *, steps=3):
    """15c: qwen2-1.5b at its published width, depth not cut (28 L, d 1536,
    vocab 151,936; random weights from seed 0), b 4 x s 2048, bf16 compute,
    ``steps`` steps with ``remat="full"``, one more under
    ``torch.profiler`` (device time of the bf16 projections ``aten::mm``,
    the fp32 attention einsums ``aten::bmm``, and the rest), then the same
    first step with ``remat="dots"``. Gates: finite losses; step-0 loss in
    [ln V + z, ln V + 1.5 + z] (logits of the tied head over the unit-RMS
    normed stream are ~N(0, 1), adding ~1/2 to ln V; z = 1e-4 (ln V)^2 is
    the z-loss); "full" and "dots" step-0 losses bit-equal."""
    import gc
    import math

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    cfg = get_config("qwen2-1.5b")
    b, s, V = 4, 2048, cfg.vocab_size
    tokens = b * s
    lo = math.log(V) + 1e-4 * math.log(V) ** 2
    hi = lo + 1.5
    step0 = {}
    for remat, n in (("full", steps), ("dots", 1)):
        tcfg = TrainConfig(global_batch=b, seq_len=s, remat=remat,
                           warmup_steps=2, total_steps=steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, tcfg, device="cuda", log_every=1)
        n_params = sum(p.numel() for p in tr.state["params"].parameters())
        hist = tr.run(n)
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in hist]
        step0[remat] = losses[0]
        secs = [h["sec"] for h in hist]
        sec = float(np.mean(secs[1:])) if n > 1 else secs[0]
        mfu = 6 * n_params * tokens / (sec * PEAK_BF16_FLOPS)
        reckon = 16 * n_params + b * s * V * 4
        _log(f"[train] 15c qwen2-1.5b, remat {remat!r}, b {b} x s {s}, "
             f"{n_params / 1e9:.4f} B parameters: losses "
             f"{[round(x, 5) for x in losses]}; step times "
             f"{[round(1e3 * t, 1) for t in secs]} ms; "
             f"{1e3 * sec:.1f} ms/step "
             f"({'steps 1-' + str(n - 1) if n > 1 else 'step 0'}), "
             f"{tokens / sec:.0f} tokens/s, model-FLOP share "
             f"6 N tokens / (t x 989 TFLOP/s) = {mfu:.4f}; peak memory "
             f"{peak / 1e9:.2f} GB (max_memory_allocated) vs the reckoning "
             f"16 B x N = {16 * n_params / 1e9:.2f} GB + fp32 logits "
             f"{b * s * V * 4 / 1e9:.2f} GB = {reckon / 1e9:.2f} GB; on {smi}")
        if not all(np.isfinite(losses)) or not lo <= losses[0] <= hi:
            raise AssertionError(f"qwen2-1.5b ({remat}) step-0 loss "
                                 f"{losses[0]} outside [{lo:.3f}, {hi:.3f}]")
        if remat == "full":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.run(1)
                wall = time.perf_counter() - t0
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            busy, end = 0.0, float("-inf")
            for e in sorted(dev, key=lambda e: e.time_range.start):
                busy += max(0.0, e.time_range.end - max(e.time_range.start,
                                                        end))
                end = max(end, e.time_range.end)
            busy /= 1e3
            total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
            mm = _op_device_ms(prof, ("aten::mm", "aten::addmm"))
            bmm = _op_device_ms(prof, ("aten::bmm", "aten::baddbmm"))
            _log(f"[train] 15c where a qwen2-1.5b step's device time goes "
                 f"(one more step under torch.profiler): wall "
                 f"{1e3 * wall:.1f} ms, device busy {busy:.1f} ms (idle share "
                 f"{1 - busy / (1e3 * wall):.3f}), {len(dev)} device ops; "
                 f"kernel time {total:.1f} ms: aten::mm (bf16 projections, "
                 f"unembed) {mm:.1f} ms, aten::bmm (fp32 score and p.v "
                 f"einsums of blockwise_attention) {bmm:.1f} ms, the rest "
                 f"(elementwise, reductions, copies) {total - mm - bmm:.1f} "
                 f"ms; on {smi}")
        del tr, hist
    ok = step0["full"] == step0["dots"]
    _log(f"[train] 15c step-0 loss band [{lo:.4f}, {hi:.4f}]: full "
         f"{step0['full']!r}, dots {step0['dots']!r}, bit-equal {ok} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("remat 'full' and 'dots' losses differ")
    gc.collect()
    torch.cuda.empty_cache()


def trained_serving_phase(model, cfg, corpus, *, new_tokens=16):
    """15d: the ConSmax model trained in 15a, the same ``LM`` object in
    place, served with both kernels: each kernel against its plain version
    on every layer's trained K/V and learned beta/gamma; the contiguous and
    the paged engine on held-out corpus prompts (paged == contiguous
    tokens, solo == batched, each run through its two kernels, counts set
    to 0 before each run and read after); the int8 / fp8 perplexity gate
    on a held-out corpus sequence. The engines run under ``no_grad``: no
    parameter gets a ``.grad`` and none is written."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousBatchingEngine

    params = list(model.parameters())
    versions = [p._version for p in params]
    grads = [p.grad for p in params]
    held = corpus.global_batch_arrays(10 ** 6)["tokens"]   # never trained on

    # ---- the kernels on the trained K/V: 8 corpus rows prefilled through
    # the plain walks, then each layer's cache against random queries
    gen = torch.Generator(device="cuda").manual_seed(9)
    fills = torch.tensor([1, 17, 64, 100, 128, 200, 255, 256],
                         dtype=torch.int32, device="cuda")
    caches = T.init_caches(cfg, 8, 1024, device="cuda")
    with torch.no_grad():
        T.lm_apply(model, cfg, caches=caches, prefill_append=fills,
                   tokens=torch.tensor(held, device="cuda"), merged=True)
    H, dk = cfg.n_heads, cfg.head_dim_
    for i, sup in enumerate(model.blocks):
        attn = caches[i]["b0"]["attn"]
        k, v = attn["k"], attn["v"]
        beta = sup["b0"].attn.score_norm.beta.detach()
        gamma = sup["b0"].attn.score_norm.gamma.detach()
        for merged in (True, False):
            kw = dict(window=0, softcap=0.0, merged=merged, scale=1.0)
            q = _rand(gen, (8, H, dk), dk ** -0.5)
            _check(f"15d layer {i} decode (trained K/V, merged={merged})",
                   consmax_decode_cuda(q, k, v, fills, beta, gamma, bk=256,
                                       **kw),
                   consmax_decode_ref(q.float(), k, v, fills, beta, gamma,
                                      **kw),
                   consmax_decode_ref(q.float(), k, v.abs(), fills, beta,
                                      gamma, **kw))
            q1 = _rand(gen, (1, 128, H, dk), dk ** -0.5)
            k1, v1 = k[7:8].contiguous(), v[7:8].contiguous()
            ti = torch.tensor([128], dtype=torch.int32, device="cuda")
            tn = torch.tensor([128], dtype=torch.int32, device="cuda")
            _check(f"15d layer {i} prefill (trained K/V, merged={merged})",
                   consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma,
                                        **kw),
                   consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
                   consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                       **kw))
    del caches

    # ---- both engines on held-out prompts
    lens = [20, 256, 131, 200, 64, 255]
    prompts = [held[i, :n].tolist() for i, n in enumerate(lens)]
    common = dict(max_slots=8, max_seq=1024, prefill_chunk=128,
                  decode_kernel=True, prefill_kernel=True,
                  score_norm=cfg.score_norm)
    cfgs = {"contiguous": ServeConfig(**common),
            "paged": ServeConfig(**common, paged_kv=True, page_size=128,
                                 num_pages=64)}
    ops = _serving_ops()

    def serve(scfg, batch):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        uids = [eng.submit(prompts[i], new_tokens) for i in batch]
        for op in ops.values():
            op.launches = 0
        results = eng.run()
        torch.cuda.synchronize()
        _graph_log(f"[train] 15d {'paged' if scfg.paged_kv else 'contiguous'}"
                   f" engine, {len(uids)} requests", eng)
        return ([results.get(u) for u in uids],
                {name: op.launches for name, op in ops.items()})

    toks, counts = {}, {}
    for kind, scfg in cfgs.items():
        toks[kind], counts[kind] = serve(scfg, range(len(prompts)))
    alone, _ = serve(cfgs["contiguous"], [2])
    # how often the trained model's greedy token follows the corpus's
    # affine bigram map (the learnable part of the synthetic corpus)
    follows = np.mean([(a * corpus.mult + corpus.add) % cfg.vocab_size == b_
                       for t in toks["contiguous"]
                       for a, b_ in zip(t[:-1], t[1:])])
    ppl = perplexity_phase(model=model, toks=held[0, :128],
                           what="trained 200 steps in 15a, a held-out "
                                "corpus row")
    checks = {
        "every request finished": all(
            t is not None and len(t) == new_tokens
            for t in toks["contiguous"] + toks["paged"]),
        "paged tokens == contiguous tokens":
            toks["paged"] == toks["contiguous"],
        "request 2 alone == served among the others":
            alone[0] == toks["contiguous"][2],
        "contiguous run: both contiguous kernels, no paged one": min(
            counts["contiguous"]["consmax_decode"],
            counts["contiguous"]["consmax_prefill"]) >= cfg.n_layers
            and not counts["contiguous"]["consmax_decode_paged"]
            and not counts["contiguous"]["consmax_prefill_paged"],
        "paged run: both paged kernels, no contiguous one": min(
            counts["paged"]["consmax_decode_paged"],
            counts["paged"]["consmax_prefill_paged"]) >= cfg.n_layers
            and not counts["paged"]["consmax_decode"]
            and not counts["paged"]["consmax_prefill"],
        "no parameter got a .grad or was written": all(
            p.grad is g for p, g in zip(params, grads)) and [
            p._version for p in params] == versions,
    }
    _log(f"[train] 15d trained gpt2-consmax served: kernel launches "
         f"{counts}; greedy tokens follow the corpus's bigram map "
         f"{follows:.3f} of the time (the corpus draws it with p 0.8); "
         f"perplexity bf16 {ppl['bfloat16']:.4f}, int8 {ppl['int8']:.4f}, "
         f"fp8_e4m3 {ppl['fp8_e4m3']:.4f}")
    for name, ok in checks.items():
        _log(f"[train] 15d check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("trained-model serving checks failed: " + ", "
                             .join(n for n, ok in checks.items() if not ok))


# ------------------------------------------------------------ phase 16 ----
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_DEPTH = 4           # of 32: weights and KV of 4 full-width layers fit
MUSICGEN_DEPTH = 8      # of 48
NEAR_TIE = 1e-6         # router k-th vs (k+1)-th probability gap counted
SMOKE_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "jamba-1.5-large-398b",
               "xlstm-1.3b", "musicgen-large", "phi-3-vision-4.2b")
SMOKE_WHOLE_TOL = 1e-4  # card vs CPU logits, fraction of the largest
SMOKE_CACHED_TOL = 1e-3
SMOKE_NOTE = ("fp32 compute, TF32 off, the same weights: the card and the "
              "CPU differ in summation order (cuBLAS tiling) and libm ulps "
              "only (the CPU tests measure <= 4.2e-6 between two such "
              "orders); through caches a K/V row on a bf16 rounding "
              "boundary of the cache may round the other way (<= 2.7e-5 "
              "there)")


def _serving_ops():
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_op, consmax_decode_paged_op)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_op, consmax_prefill_paged_op)
    return {"consmax_decode": consmax_decode_op,
            "consmax_prefill": consmax_prefill_op,
            "consmax_decode_paged": consmax_decode_paged_op,
            "consmax_prefill_paged": consmax_prefill_paged_op}


def moe_kernel_phase():
    """16a, kernels: the four serving kernels at the phi3.5-moe engine's
    shapes (16 slots x 8192 rows, 32 heads, 8 KV heads: GQA group 4,
    head_dim 128, bf16; prefill chunk 512; pages of 256) against their
    plain versions, the paged ones also bit for bit against the contiguous
    ones; times and bounds. Returns the ``[phi3.5-moe]`` rows of the result
    line."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref, consmax_decode_ref)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref, consmax_prefill_ref)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    b, L, H, hkv, dk, bk, c, ps = 16, 8192, 32, 8, 128, 256, 512, 256
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    lengths = torch.tensor([1, 300, 512, 513, 1024, 2048, 2049, 3000, 4096,
                            4097, 5000, 6000, 7000, 7500, 8191, 8192],
                           dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    err = _check("phi3.5-moe decode b=16 L=8192 H=32 hkv=8 dk=128",
                 consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk,
                                     **kw),
                 consmax_decode_ref(q.float(), k, v, lengths, beta, gamma,
                                    **kw),
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    fill = int(lengths.sum())
    io = 2 * b * H * dk * 2
    times = {"consmax_decode": (
        err, lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                         bk=bk, **kw),
        lambda: consmax_decode_ref(q, k, v, lengths, beta, gamma, **kw),
        fill * hkv * dk * 2 * 2 + io, 4 * fill * H * dk)}
    perr, (kp, vp, table) = _paged_decode_case(
        "phi3.5-moe paged decode ps=256", q, k, v, lengths, beta, gamma, kw,
        bk=bk, ps=ps, num_pages=b * L // ps)
    times["consmax_decode_paged"] = (
        perr, lambda: consmax_decode_paged_cuda(q, kp, vp, table, lengths,
                                                beta, gamma, bk=bk, **kw),
        lambda: consmax_decode_paged_ref(q, kp, vp, table, lengths, beta,
                                         gamma, **kw),
        fill * hkv * dk * 2 * 2 + io + table.numel() * 4, 4 * fill * H * dk)

    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[15:16].contiguous(), v[15:16].contiguous()
    errs, perrs = [], []
    for idx, n in [(0, 512), (3584, 512), (7680, 512), (4000, 200)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        errs.append(_check(
            f"phi3.5-moe prefill c=512 index={idx} len={n}",
            consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                **kw)))
        e, pools = _paged_prefill_case(
            f"phi3.5-moe paged prefill index={idx} len={n}", q1, k1, v1, ti,
            tn, beta, gamma, kw, ps=ps, num_pages=64)
        perrs.append(e)
        if idx == 3584:
            timed = (ti, tn, *pools)
    ti, tn, kp1, vp1, t1 = timed
    kvl = 3584 + c
    visible = sum(min(3584 + i + 1, kvl) for i in range(c))
    pbytes = kvl * hkv * dk * 2 * 2 + 2 * c * H * dk * 2
    times["consmax_prefill"] = (
        max(errs), lambda: consmax_prefill_cuda(q1, k1, v1, ti, tn, beta,
                                                gamma, **kw),
        lambda: consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
        pbytes, 4 * visible * H * dk)
    times["consmax_prefill_paged"] = (
        max(perrs), lambda: consmax_prefill_paged_cuda(
            q1, kp1, vp1, t1, ti, tn, beta, gamma, **kw),
        lambda: consmax_prefill_paged_ref(q1, kp1, vp1, t1, ti, tn, beta,
                                          gamma, **kw),
        pbytes + t1.numel() * 4, 4 * visible * H * dk)
    rows = {}
    for name, (e, fn, plain, nbytes, flops) in times.items():
        bound, by = _bound_ms(nbytes, flops)
        rows[f"{name}[phi3.5-moe]"] = dict(
            max_abs_err=e, ms=_time_ms(fn, flush, 50),
            plain_ms=_time_ms(plain, flush, 5), bound_ms=bound, bound_by=by)
    return rows


class _RouterTies:
    """Counts, on the device, router rows whose k-th and (k+1)-th
    probabilities lie within ``NEAR_TIE`` (a flip there moves a token's
    output by O(1)), while installed over ``models.moe.route``."""

    def __init__(self):
        from repro_torch.models import moe as MOE
        self.moe, self.route = MOE, MOE.route
        self.ties = torch.zeros((), dtype=torch.int64, device="cuda")
        self.rows = torch.zeros((), dtype=torch.int64, device="cuda")

    def __enter__(self):
        def counted(p, x, cfg):
            out = self.route(p, x, cfg)
            probs = torch.softmax(x.float() @ p.router, dim=-1)
            srt = probs.sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            self.ties += ((srt[..., k - 1] - srt[..., k]) < NEAR_TIE).sum()
            self.rows += srt[..., 0].numel()
            return out
        self.moe.route = counted
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def _moe_trace(eng, smi, *, skip):
    """One engine iteration (after ``skip``) under ``torch.profiler``, each
    MoE layer inside a ``moe_layer`` range: wall and device busy ms, idle
    share, device ops; the MoE layers' device ms split into the expert
    ``bmm``s, the router, the dispatch and the rest."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe as MOE

    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    apply = MOE.moe_apply

    def ranged(*a, **kw):
        with record_function("moe_layer"):
            return apply(*a, **kw)
    MOE.moe_apply = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        MOE.moe_apply = apply
    # the range also shows as a device-side annotation: not an op
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name != "moe_layer"]
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    busy /= 1e3
    groups = {"expert bmm": ("aten::bmm",),
              "router": ("aten::matmul", "aten::mm", "aten::softmax",
                         "aten::_softmax", "aten::exp", "aten::sum"),
              "dispatch": ("aten::sort", "aten::argsort", "aten::cumsum",
                           "aten::gather", "aten::one_hot",
                           "aten::index_put", "aten::index_put_",
                           "aten::index", "aten::scatter_",
                           "aten::floor_divide", "aten::where",
                           "aten::clamp", "aten::zeros")}
    split, by_op, layer = defaultdict(float), defaultdict(float), 0.0
    ranges = [e for e in prof.events() if e.name == "moe_layer"
              and e.device_type == DeviceType.CPU]
    for r in ranges:
        layer += r.device_time_total
        for ch in r.cpu_children:
            by_op[ch.name] += ch.device_time_total
            g = next((g for g, names in groups.items() if ch.name in names),
                     "rest (activation, gating, weighting, copies)")
            split[g] += ch.device_time_total
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    _log(f"[moe] one traced engine iteration (torch.profiler): wall "
         f"{wall:.1f} ms, device busy {busy:.2f} ms (idle share "
         f"{1 - busy / wall:.3f}), {len(dev)} device ops; {len(ranges)} MoE "
         f"layer calls, {layer / 1e3:.2f} ms device: "
         + ", ".join(f"{g} {t / 1e3:.3f} ms" for g, t in split.items())
         + "; by op: " + ", ".join(f"{n} {t / 1e3:.3f}" for n, t in top)
         + f"; on {smi}")
    if not ranges or layer <= 0:
        raise AssertionError("the trace saw no MoE layer on the device")


def moe_engine_phase(smi, *, seed=9, new_tokens=24):
    """16a: phi3.5-moe-42b-a6.6b at its published widths (d 4096, 32 heads,
    8 KV heads, 16 experts top-2 of ff 6400, vocab 32,064, layernorm,
    silu-GLU), depth cut from 32 to ``MOE_DEPTH`` layers, random weights
    from ``seed``; the continuous engine with both kernels and a bf16 KV
    cache: 16 slots x 8192 rows, chunk 512 (expert capacity 80 per chunk,
    2 per decode step). Eight requests of 512-2048 prompt tokens, four
    greedy and four sampled (each on its own seed), on the contiguous
    engine and on the paged one (pages of 256, a 160-page pool). Checked:
    every request finishes; paged == contiguous tokens; a greedy and a
    sampled request served alone == served among the others; one prefill
    and one decode signature per engine; the kernels each engine launched.
    Printed: wall ms per iteration, tok/s, the launches, router near-ties,
    one traced iteration (``_moe_trace``); then a short int8-KV run.
    Returns the launch counts of the contiguous run (rows 1-2) and of the
    paged run (rows 3-4)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import capacity
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    cfg = get_config(MOE_ARCH, n_layers=MOE_DEPTH)
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    m = cfg.moe
    c512, c1 = (capacity(s, m.top_k, m.n_experts, m.capacity_factor)
                for s in (512, 1))
    _log(f"[moe] {MOE_ARCH} at its published widths, {cfg.n_layers} of 32 "
         f"layers: {n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.2f}"
         f" GB fp32; the bf16 copies are made at first use), drawn in "
         f"{time.perf_counter() - t0:.1f} s; capacity per expert: {c512} for "
         f"a 512-token chunk, {c1} for a decode step")
    chunk, ps, npages = 512, 256, 160
    common = dict(max_slots=16, max_seq=8192, prefill_chunk=chunk,
                  decode_kernel=True, prefill_kernel=True,
                  score_norm=cfg.score_norm)
    cfgs = {"contiguous": ServeConfig(**common),
            "paged": ServeConfig(**common, paged_kv=True, page_size=ps,
                                 num_pages=npages)}
    ops = _serving_ops()
    r = np.random.default_rng(seed)
    reqs = [(r.integers(0, cfg.vocab_size, n).tolist(),
             None if i % 2 == 0 else SamplingParams(**HOT, seed=200 + i))
            for i, n in enumerate((512, 2048, 1000, 1536, 700, 1800, 600,
                                   1300))]

    def serve(scfg, items):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for op in ops.values():
            op.launches = 0
        uids = [eng.submit(p, new_tokens, sampling=sp) for p, sp in items]
        t0, iters = time.perf_counter(), 0
        while eng.scheduler.has_work():
            eng.step()
            iters += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: op.launches for name, op in ops.items()}
        _graph_log(f"[moe] {'paged' if scfg.paged_kv else 'contiguous'} "
                   f"{scfg.kv_cache_dtype} engine, {len(uids)} requests",
                   eng)
        return eng, [eng.results.get(u) for u in uids], wall, iters, counts

    out, counts, checks = {}, {}, {}
    for kind, scfg in cfgs.items():
        with _RouterTies() as ties:
            eng, out[kind], wall, iters, counts[kind] = serve(scfg, reqs)
        gen = sum(len(t or []) for t in out[kind])
        cold = sum(len(p) for p, _ in reqs)
        _log(f"[moe] {kind} engine: {len(reqs)} requests, {cold} prompt + "
             f"{gen} generated tokens in {wall:.3f} s, {iters} iterations: "
             f"{1e3 * wall / iters:.1f} ms/iteration, {gen / wall:.1f} "
             f"generated tok/s, {cold / wall:.1f} prompt tok/s, mean TTFT "
             f"{np.mean(list(eng.ttft.values())):.3f} s; prefill / decode "
             f"signatures {eng.prefill_cache_size} / "
             f"{eng.decode_cache_size}; kernel launches {counts[kind]}; "
             f"router rows {int(ties.rows)}, near-ties (gap < {NEAR_TIE:g}) "
             f"{int(ties.ties)}; allocated "
             f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; on {smi}")
        checks[f"{kind}: every request finished"] = all(
            t is not None and len(t) == new_tokens for t in out[kind])
        checks[f"{kind}: prefill_cache_size == decode_cache_size == 1"] = (
            eng.prefill_cache_size == eng.decode_cache_size == 1)
        del eng
        torch.cuda.empty_cache()
    c, pg = counts["contiguous"], counts["paged"]
    chunks = sum(-(-len(p) // chunk) for p, _ in reqs)
    checks[f"contiguous: prefill launches == {cfg.n_layers} x {chunks} "
           f"chunks, decode >= {cfg.n_layers}, no paged kernel"] = (
        c["consmax_prefill"] == cfg.n_layers * chunks
        and c["consmax_decode"] >= cfg.n_layers
        and not c["consmax_decode_paged"] and not c["consmax_prefill_paged"])
    checks["paged: paged kernels only"] = (
        pg["consmax_prefill_paged"] == cfg.n_layers * chunks
        and pg["consmax_decode_paged"] >= cfg.n_layers
        and not pg["consmax_decode"] and not pg["consmax_prefill"])
    checks["paged tokens == contiguous tokens"] = (
        out["paged"] == out["contiguous"])
    for i in (2, 1):                        # a greedy and a sampled request
        _, alone, _, _, _ = serve(cfgs["contiguous"], [reqs[i]])
        kind = "sampled" if reqs[i][1] else "greedy"
        checks[f"{kind} request {i} alone == served among the others"] = (
            alone[0] == out["contiguous"][i])

    # eager (cuda_graphs=False): the split reads each MoE op under its
    # range, which a graph replay does not dispatch
    eng = ContinuousBatchingEngine(cfg, cfgs["contiguous"], model,
                                   device="cuda", cuda_graphs=False)
    for p, sp in reqs:
        eng.submit(p, new_tokens, sampling=sp)
    _moe_trace(eng, smi, skip=6)
    del eng
    torch.cuda.empty_cache()

    scfg8 = ServeConfig(**common, kv_cache_dtype="int8")
    eng, toks8, wall, iters, c8 = serve(scfg8, reqs[:4])
    same = sum(a == b for a, b in zip(toks8, out["contiguous"][:4]))
    _log(f"[moe] int8 KV, contiguous: 4 requests in {wall:.3f} s, "
         f"{iters} iterations; launches {c8}; {same} of 4 token streams "
         f"equal the bf16 engine's (int8 K/V round differently; not gated)")
    checks["int8: every request finished, one signature each"] = (
        all(t is not None and len(t) == new_tokens for t in toks8)
        and eng.prefill_cache_size == eng.decode_cache_size == 1
        and c8["consmax_decode"] >= cfg.n_layers)
    del eng, model
    torch.cuda.empty_cache()
    for name, ok in checks.items():
        _log(f"[moe] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("phi3.5-moe engine checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))
    return {**{k: c[k] for k in ("consmax_decode", "consmax_prefill")},
            **{k: pg[k] for k in ("consmax_decode_paged",
                                  "consmax_prefill_paged")}}


# no warmup: the schedule's step-0 rate would be 0 and step 1 would repeat
# step 0's weights
MOE_TRAIN = dict(global_batch=2, seq_len=2048, warmup_steps=0, total_steps=2,
                 remat="full")


def moe_train_child(*, depth=2, steps=2):
    """16b, run in its own process (``python3 chip_smoke.py --train-moe``,
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts) under
    ``use_deterministic_algorithms(True, warn_only=True)``:
    phi3.5-moe-42b-a6.6b at full width and ``depth`` layers, ``steps``
    ``make_train_fns`` steps (b 2 x s 2048, bf16, remat "full"), twice from
    the same seed. Prints one JSON line: both runs' losses, ce and aux, ms
    per step, peak memory, the parameter count and the ops that warned."""
    import warnings

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.step import make_train_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = get_config(MOE_ARCH, n_layers=depth)
    tcfg = TrainConfig(**MOE_TRAIN)
    b, s = tcfg.global_batch, tcfg.seq_len
    r = np.random.default_rng(13)
    batch = {"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32, device="cuda"),
             "labels": torch.tensor(r.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32, device="cuda")}
    runs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            init_state, train_step = make_train_fns(cfg, tcfg, device="cuda")
            state = init_state()
            n_params = sum(p.numel() for p in state["params"].parameters())
            hist, secs = [], []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = train_step(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                hist.append({k: float(met[k]) for k in ("loss", "ce", "aux")})
            runs.append({"hist": hist, "ms": [1e3 * t for t in secs],
                         "peak": torch.cuda.max_memory_allocated()})
            del state, init_state, train_step
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    print(json.dumps({"moe_train": {"runs": runs, "n_params": n_params,
                                    "warned": ops}}), flush=True)


def moe_train_phase(smi):
    """16b: runs ``moe_train_child`` and holds its result: finite losses,
    the step-0 loss in the band of 15c, a non-zero aux in every step, the
    second run equal to the first bit for bit (or, where an op warned that
    it is not deterministic, within ``RESUME_RTOL``); peak memory beside
    the reckoning of 18 B per parameter (fp32 weights, gradients, two
    moments, the bf16 copies of the forward)."""
    import math
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--train-moe"], env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"the MoE training run failed:\n"
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["moe_train"]
    a, b = (run["hist"] for run in res["runs"])
    losses = [h["loss"] for h in a]
    V = 32064
    lo = math.log(V) + 1e-4 * math.log(V) ** 2
    bits = a == b
    rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
              for x, y in zip(a, b))
    n = res["n_params"]
    checks = {
        "finite losses, step 0 in its band": (
            all(np.isfinite(losses)) and lo <= losses[0] <= lo + 1.5),
        "aux > 0 in every step, loss == ce + aux": all(
            h["aux"] > 0 and abs(h["loss"] - h["ce"] - h["aux"])
            <= 1e-5 * h["loss"] for h in a),
        "second run == first": bits or (bool(res["warned"])
                                        and rel <= RESUME_RTOL)}
    run = res["runs"][0]
    _log(f"[moe-train] 16b {MOE_ARCH} full width, 2 of 32 layers, "
         f"{n / 1e9:.4f} B parameters, b {MOE_TRAIN['global_batch']} x s "
         f"{MOE_TRAIN['seq_len']}, bf16, remat full, deterministic "
         f"algorithms (its own process): steps {a} (second run bit-equal "
         f"{bits}, largest relative difference {rel:.3e}); step times "
         f"{[round(t, 1) for t in run['ms']]} ms; peak memory "
         f"{run['peak'] / 1e9:.2f} GB (max_memory_allocated) vs the "
         f"reckoning 18 B x N = {18 * n / 1e9:.2f} GB; ops without a "
         f"deterministic implementation: {res['warned'] or 'none'}; on {smi}")
    for name, ok in checks.items():
        _log(f"[moe-train] check {name}: {ok}")
    if not all(checks.values()):
        raise AssertionError("MoE training checks failed: " + ", ".join(
            n for n, ok in checks.items() if not ok))


XLSTM_LOGIT_TOL = 1e-3


def xlstm_phase(smi, *, seed=10, prompt=256, steps=32, held=8):
    """16c: xlstm-1.3b at full width, all 48 blocks (42 mLSTM, 6 sLSTM; d
    2048, 4 heads, vocab 50,304), random weights from ``seed``.
    ``ServeSession`` (host sampling: the arch has no attention cache, so
    its decode graph is the logits mode's) generates ``steps`` greedy
    tokens for 2 prompts of ``prompt`` tokens at bf16, graphed and with
    ``cuda_graphs=False``: the same tokens, ms per decode step of each.
    Then at fp32 compute (TF32 off) the decode steps'
    logits (``make_serve_fns``: whole-prompt prefill, ``held`` one-token
    steps on the generated tokens) are held against one whole-sequence
    ``lm_apply`` of the same tokens, within ``XLSTM_LOGIT_TOL`` of the
    largest logit: the chunkwise and the recurrent mLSTM are the same
    function, so only fp32 rounding separates them; and every greedy
    token equals the argmax of its decode step."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeSession, make_serve_fns
    from repro_torch.weights import init_params

    cfg = get_config("xlstm-1.3b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, prompt)), dtype=torch.int32, device="cuda")
    outs, ms = {}, {}
    for graphs in (True, False):
        sess = ServeSession(cfg, ServeConfig(max_seq=prompt + steps), model,
                            device="cuda", cuda_graphs=graphs)
        sess.generate(toks, steps=3)                   # warm-up
        outs[graphs], ms[graphs], tps = _session_ms(sess, toks, steps)
        _session_log(f"[xlstm] xlstm-1.3b session "
                     f"({'graphed' if graphs else 'cuda_graphs=False'})",
                     sess, graphed=graphs)
        _log(f"[xlstm] xlstm-1.3b full width, 48 blocks, "
             f"{n_params / 1e9:.3f} B parameters: ServeSession b 2 x "
             f"{prompt} prompt tokens, {steps} greedy tokens, "
             f"{'graphed' if graphs else 'cuda_graphs=False'}: "
             f"{ms[graphs]:.2f} ms per decode step ({tps:.1f} tok/s; "
             f"fused={sess.fused}); allocated "
             f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; on {smi}")
        del sess
    out = outs[True]
    same = torch.equal(outs[True], outs[False])
    _log(f"[xlstm] graphed {ms[True]:.2f} ms vs eager {ms[False]:.2f} ms "
         f"per decode step (x{ms[False] / ms[True]:.2f}); graphed tokens == "
         f"eager tokens: {same}")
    if not same:
        raise AssertionError("xlstm: graphed and eager session tokens "
                             "differ")

    f32 = cfg.replace(compute_dtype="float32")
    _, prefill, decode, _ = make_serve_fns(
        f32, ServeConfig(max_seq=prompt + steps, fused_sampling=False),
        device="cuda")
    caches = T.init_caches(f32, 2, prompt + steps, device="cuda")
    logits, caches = prefill(model, caches, {"tokens": toks})
    got = [logits]
    gen = out[:, :held].to(device="cuda", dtype=torch.int32)
    for t in range(held - 1):
        logits, caches = decode(model, caches, {"tokens": gen[:, t:t + 1]})
        got.append(logits)
    got = torch.stack(got, 1).float()
    with torch.no_grad():
        whole, _, _ = T.lm_apply(model, f32, tokens=torch.cat(
            [toks, gen[:, :held - 1]], 1))
    whole = whole[:, prompt - 1:].float()
    err = float((got - whole).abs().max() / whole.abs().max())
    f32_tokens = got.argmax(-1)
    agree = float((f32_tokens == gen).float().mean())
    ok = err <= XLSTM_LOGIT_TOL and bool(torch.isfinite(got).all())
    _log(f"[xlstm] fp32: {held} decode-step logits vs one whole-sequence "
         f"lm_apply: max |diff| / max |logit| {err:.3e} (gate "
         f"{XLSTM_LOGIT_TOL:g}) {'ok' if ok else 'FAIL'}; fp32 argmax == "
         f"the bf16 session's greedy tokens on {agree:.3f} of them "
         f"(printed, not gated: bf16 and fp32 round differently)")
    del model, caches
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("xlstm decode steps disagree with the whole "
                             "sequence")


MUSICGEN_TOL = 2.0 ** -4      # bf16 steps vs the whole pass
MUSICGEN_KERNEL_TOL = 2.0 ** -6


def musicgen_phase(smi, *, seed=11, prompt=512, steps=8):
    """16d: musicgen-large at full width (d 2048, 32 heads: head_dim 64,
    MHA, ff 8192, vocab 2048, 256 cond tokens, layernorm, gelu, sinusoidal
    positions, cross-attention), depth cut from 48 to ``MUSICGEN_DEPTH``,
    random weights from ``seed``, bf16. Frame embeddings and the cond
    stream are drawn from ``seed`` (the stub frontend takes precomputed
    embeddings). One whole-sequence ``lm_apply`` over prompt + steps frames;
    then a whole-prompt prefill and ``steps`` one-token decode steps with
    ``decode_kernel`` (row 1 at dk 64; cross-attention decodes through the
    plain walk over the cond K/V, as the reference does), and the same
    steps without the kernel on a copy of the caches. Gates: each kernel
    step's logits within ``MUSICGEN_TOL`` of the whole pass's (the whole
    pass attends unrounded K/V, the steps the bf16 cache) and within
    ``MUSICGEN_KERNEL_TOL`` of the plain steps; decode kernel launches ==
    steps x layers."""
    import copy

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params

    cfg = get_config("musicgen-large", n_layers=MUSICGEN_DEPTH)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn((2, prompt + steps, cfg.d_model), generator=gen,
                         device="cuda")
    cond = torch.randn((2, cfg.n_cond_tokens, cfg.d_model), generator=gen,
                       device="cuda")
    with torch.no_grad():
        whole, _, _ = T.lm_apply(model, cfg, embeds=frames, cond=cond)
        caches = T.init_caches(cfg, 2, prompt + steps, device="cuda")
        _, caches, _ = T.lm_apply(
            model, cfg, embeds=frames[:, :prompt], cond=cond, caches=caches,
            positions=torch.arange(prompt, device="cuda")[None],
            logits_index=prompt - 1)
        plain_caches = copy.deepcopy(caches)
        consmax_decode_op.launches = 0
        t0 = time.perf_counter()
        got = []
        for t in range(steps):
            idx = T.cache_index(caches)
            lg, caches, _ = T.lm_apply(
                model, cfg, embeds=frames[:, prompt + t:prompt + t + 1],
                cond=cond, caches=caches, positions=idx[:, None],
                merged=True, decode_kernel=True)
            got.append(lg[:, 0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = consmax_decode_op.launches
        plain = []
        for t in range(steps):
            idx = T.cache_index(plain_caches)
            lg, plain_caches, _ = T.lm_apply(
                model, cfg, embeds=frames[:, prompt + t:prompt + t + 1],
                cond=cond, caches=plain_caches, positions=idx[:, None],
                merged=True)
            plain.append(lg[:, 0])
    got, plain = torch.stack(got, 1).float(), torch.stack(plain, 1).float()
    ref = whole[:, prompt:].float()
    err = float((got - ref).abs().max() / ref.abs().max())
    kerr = float((got - plain).abs().max() / plain.abs().max())
    ok = (err <= MUSICGEN_TOL and kerr <= MUSICGEN_KERNEL_TOL
          and launches == steps * cfg.n_layers
          and bool(torch.isfinite(got).all()))
    _log(f"[musicgen] musicgen-large full width, {cfg.n_layers} of 48 "
         f"layers, frames b 2 x {prompt} + {steps} decode steps with the "
         f"decode kernel (dk 64) and cross-attention over "
         f"{cfg.n_cond_tokens} cond tokens: {1e3 * dt / steps:.1f} ms per "
         f"step; logits vs the whole pass {err:.3e} (gate "
         f"{MUSICGEN_TOL:g}), vs the plain decode walk {kerr:.3e} (gate "
         f"{MUSICGEN_KERNEL_TOL:g}); decode kernel launches {launches} "
         f"(expected {steps * cfg.n_layers}) {'ok' if ok else 'FAIL'}; "
         f"on {smi}")
    del model, caches, plain_caches
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("musicgen decode checks failed")


def smoke_archs_phase(*, seed=12, s=16, steps=4):
    """16e: the smoke config of every arch this slice ports, fp32 compute,
    the same weights on the card and the CPU (drawn on the CPU from
    ``seed``): whole-sequence logits over s + steps inputs, then a
    whole-prompt prefill of s and ``steps`` one-token steps through the
    caches, card vs CPU within ``SMOKE_WHOLE_TOL`` / ``SMOKE_CACHED_TOL``
    of the largest logit (``SMOKE_NOTE``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params

    bad = []
    for arch in SMOKE_ARCHS:
        cfg = get_config(arch, smoke=True, compute_dtype="float32")
        r = np.random.default_rng(seed)
        x = {}
        if cfg.frontend == "tokens":
            x["tokens"] = torch.tensor(r.integers(0, cfg.vocab_size,
                                                  (2, s + steps)),
                                       dtype=torch.int32)
        else:
            x["embeds"] = torch.tensor(r.standard_normal(
                (2, s + steps, cfg.d_model)), dtype=torch.float32)
        cond = (torch.tensor(r.standard_normal((2, cfg.n_cond_tokens,
                                                cfg.d_model)),
                             dtype=torch.float32) if cfg.cross_attn else None)
        res = {}
        for dev in ("cuda", "cpu"):
            model = init_params(cfg, torch.Generator().manual_seed(seed),
                                device=dev)
            xd = {k: v.to(dev) for k, v in x.items()}
            cd = None if cond is None else cond.to(dev)
            with torch.no_grad():
                whole, _, aux = T.lm_apply(model, cfg, cond=cd, **xd)
                caches = T.init_caches(cfg, 2, s + steps, device=dev)
                outs = []
                for t in range(steps + 1):
                    sl = slice(0, s) if t == 0 else slice(s + t - 1, s + t)
                    idx = T.cache_index(caches)
                    pos = (torch.arange(s, device=dev)[None] if t == 0 else
                           None if idx is None else idx[:, None])
                    lg, caches, _ = T.lm_apply(
                        model, cfg, cond=cd, caches=caches, positions=pos,
                        merged=True, **{k: v[:, sl] for k, v in xd.items()})
                    outs.append(lg[:, -1])
            res[dev] = (whole.cpu(), torch.stack(outs, 1).cpu(), float(aux))
        (wg, cg, ag), (wc, cc, ac) = res["cuda"], res["cpu"]
        ew = float((wg - wc).abs().max() / wc.abs().max())
        ec = float((cg - cc).abs().max() / cc.abs().max())
        ok = (ew <= SMOKE_WHOLE_TOL and ec <= SMOKE_CACHED_TOL
              and bool(torch.isfinite(wg).all() and torch.isfinite(cg).all())
              and abs(ag - ac) <= 1e-4 * max(abs(ac), 1e-30))
        _log(f"[smoke] {arch} (smoke, fp32): card vs CPU logits whole "
             f"{ew:.3e} (gate {SMOKE_WHOLE_TOL:g}), through caches {ec:.3e} "
             f"(gate {SMOKE_CACHED_TOL:g}); aux card {ag:.6g} CPU {ac:.6g} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(arch)
    _log(f"[smoke] tolerance: {SMOKE_NOTE}")
    if bad:
        raise AssertionError(f"card and CPU disagree on {bad}")


# ------------------------------------------------------------ 17: mesh ----
MESH_ARCH = "qwen2-1.5b"
MESH_SEED = 0                 # phase 5's weights
MESH_NEW = 16
MESH_LENS = [300, 1200, 2500, 700, 3000, 1800, 150, 3900]   # + 16 < 4096
MESH_SPILL = 4400             # + 16 rows > one seq block (4096 rows)
MESH_CONTIG = dict(max_slots=8, max_seq=8192, prefill_chunk=512,
                   decode_kernel=True, prefill_kernel=True)
MESH_PAGED = dict(max_slots=16, max_seq=8192, prefill_chunk=512,
                  paged_kv=True, page_size=256, decode_kernel=True,
                  prefill_kernel=True)
MESH_TRAIN = dict(global_batch=8, seq_len=256, lr=1e-3, warmup_steps=2,
                  total_steps=50, remat="none")
MESH_TRAIN_STEPS = 5
MESH_TRAIN_RTOL = 1e-4        # fp32, TF32 off: the ranks' gradient means
                              # regroup one card's sum (CARD_VS_CPU_RTOL)
MESH_CP_TOL = 1e-5            # fp32 context-parallel decode vs one rank
MESH_TIMEOUT = 400            # seconds for one world of ranks
MESH_KERNELS = ("consmax_decode", "consmax_prefill", "consmax_decode_paged",
                "consmax_prefill_paged")
# 17e: token identity past qwen2-1.5b's bf16 widths — chatglm3-6b at its
# published widths (d 4096, 32 heads, 2 KV heads), depth cut from 28 to 4
# layers so that two ranks (each the full fp32 model at construction) and
# the baseline fit the one card; and qwen2-1.5b at fp32 compute (the
# kernels take bf16 only, so the plain walks), depth cut to 8 layers
MESH_WIDE = (("chatglm3-6b", dict(n_layers=4), True),
             ("qwen2-1.5b", dict(n_layers=8, compute_dtype="float32"), False))
MESH_WIDE_LENS = [300, 1200, 700, 150]
MESH_WIDE_NEW = 8


def _mesh_traffic(vocab):
    """8 requests inside one seq block, greedy and sampled alternately; and
    one request that spills past it."""
    r = np.random.default_rng(17)
    prompts = [r.integers(0, vocab, n).tolist() for n in MESH_LENS]
    sampling = [None if i % 2 == 0 else
                dict(temperature=0.8, top_k=50, seed=100 + i)
                for i in range(len(prompts))]
    spill = r.integers(0, vocab, MESH_SPILL).tolist()
    return prompts, sampling, spill


def _kernel_ops():
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_op, consmax_decode_paged_op)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_op, consmax_prefill_paged_op)
    return dict(zip(MESH_KERNELS, (consmax_decode_op, consmax_prefill_op,
                                   consmax_decode_paged_op,
                                   consmax_prefill_paged_op)))


def _mesh_serve(cfg, scfg, model, prompts, sampling, spill=None,
                new=MESH_NEW):
    """Serve the traffic through a ``ContinuousBatchingEngine`` (on this
    process's rank of the mesh when ``scfg`` asks for one); returns the
    engine and what the run showed."""
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
    uids = [eng.submit(p, new, sampling=SamplingParams(**s)
                       if s else None) for p, s in zip(prompts, sampling)]
    ops = _kernel_ops()
    for op in ops.values():
        op.launches = 0
    torch.cuda.synchronize()
    t0, iters = time.perf_counter(), 0
    while eng.scheduler.has_work():
        eng.step()
        iters += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(tokens=[eng.results[u] for u in uids], iters=iters,
               wall=wall, launches={k: op.launches for k, op in ops.items()},
               signatures=[eng.prefill_cache_size, eng.decode_cache_size],
               collectives=json.loads(json.dumps(eng.collectives)),
               steps=eng.model_steps,
               kv_bytes=_cache_bytes(eng.caches))
    if spill is not None:
        uid = eng.submit(spill, MESH_NEW)
        eng.run()
        out["spill"] = eng.results[uid]
    return eng, out


def _param_bytes(model, dtype_bytes):
    return sum(p.numel() for p in model.parameters()) * dtype_bytes


def mesh_child(spec_path, rank):
    """One rank of phase 17 (``python3 chip_smoke.py --mesh-rank <spec>
    <rank>``), on the one card the ranks share (cuda:0 unless the spec
    gives each rank its own card) over the spec's backend: serve the traffic
    on its rank of the mesh; then, as the spec asks, the context-parallel
    decode over the whole world and FSDP training. Prints its result as one
    JSON line."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import ServeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import attention as A
    from repro_torch.core import context_parallel as CP
    from repro_torch.core.consmax import ConSmaxParams
    from repro_torch.distributed import comm as COMM
    from repro_torch.launch.mesh import init_distributed, train_mesh
    from repro_torch.train.trainer import Trainer
    from repro_torch.weights import init_params

    spec = json.loads(Path(spec_path).read_text())
    device = torch.device("cuda", rank if spec["own_cards"] else 0)
    init_distributed(spec["backend"], rank=rank, world_size=spec["world"],
                     init_method=f"file://{spec['store']}", device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}

    cfg = get_config(spec.get("arch", MESH_ARCH), **spec.get("over", {}))
    scfg = ServeConfig(**spec["serve"], tp=spec["tp"], seq_shards=spec["ns"],
                       score_norm=cfg.score_norm)
    torch.cuda.reset_peak_memory_stats(device)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(
        MESH_SEED), device=device)
    full_bytes = _param_bytes(model, 4)
    eng, res = _mesh_serve(cfg, scfg, model, spec["prompts"],
                           spec["sampling"], spec.get("spill"),
                           spec.get("new", MESH_NEW))
    out["serve"] = res
    out["peak"] = torch.cuda.max_memory_allocated(device)
    out["reckon"] = dict(full=full_bytes, local=_param_bytes(eng.params, 4),
                         bf16=_param_bytes(eng.params, 2),
                         kv=res["kv_bytes"])
    del model, eng
    torch.cuda.empty_cache()

    if spec.get("cp"):
        comm = COMM.Comm()
        b, L, H, hkv, dk = 8, 8192, 12, 2, 128
        gen = torch.Generator(device=device).manual_seed(7)
        q = torch.randn((b, 1, H, dk), generator=gen, device=device) * 0.1
        k = torch.randn((b, L, hkv, dk), generator=gen, device=device)
        v = torch.randn((b, L, hkv, dk), generator=gen, device=device)
        index = torch.randint(L // 2, L, (b,), generator=gen, device=device)
        params = ConSmaxParams(H, cfg.consmax, device=device)
        params.reset_parameters(gen)
        lo, hi = rank * L // comm.size, (rank + 1) * L // comm.size
        cp = {}
        for kind in ("consmax", "softmax"):
            fn = CP.make_cp_decode(comm, kind, params,
                                   merged=kind == "consmax")
            COMM.reset_counts()
            o = fn(q, k[:, lo:hi], v[:, lo:hi], index)
            counts = COMM.counts()
            ref = A.decode_attention(q, k, v, index, norm_kind=kind,
                                     norm_params=params,
                                     merged=kind == "consmax")
            err = float((o - ref).abs().max() / ref.abs().max())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn(q, k[:, lo:hi], v[:, lo:hi], index)
            torch.cuda.synchronize()
            cp[kind] = dict(err=err, counts=counts,
                            ms=(time.perf_counter() - t0) * 100)
        out["cp"] = cp
        del q, k, v

    if spec.get("train"):
        tcfg_model = get_config("gpt2-consmax", compute_dtype="float32")
        model = init_params(tcfg_model, torch.Generator(
            device=device).manual_seed(0), device=device)
        tr = Trainer(tcfg_model, TrainConfig(**MESH_TRAIN), model=model,
                     device=device, mesh=train_mesh(device=device),
                     log_every=10 ** 9)
        hist = tr.run(MESH_TRAIN_STEPS)
        out["train"] = dict(loss=[h["loss"] for h in hist],
                            ms=[h["sec"] * 1e3 for h in hist])
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def _run_world(tmp, name, world, **spec):
    from repro_torch.launch.mesh import run_ranks
    spec = dict(spec, world=world, store=str(tmp / f"{name}.store"))
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(spec))
    outs = run_ranks([[sys.executable, str(Path(__file__).resolve()),
                       "--mesh-rank", str(path), str(r)]
                      for r in range(world)], timeout=MESH_TIMEOUT)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _head_and_hole_checks():
    """The launch of a head slice gives the full launch's bits for those
    heads (no launch parameter follows the head count), and a request whose
    pages fill a whole seq block, with -1 holes on the other rank's
    localized table, sums (fp32) to the one-pool bits: decode and prefill,
    contiguous and paged, at qwen2-1.5b's shapes."""
    from repro_torch.kernels import cache_layout as CL
    ops = _kernel_ops()
    gen = torch.Generator(device="cuda").manual_seed(23)
    # the head slice's projections are column slices of the full GEMM: the
    # tokens stay single-device's only while cuBLAS gives those columns
    # the same bits (printed; the token gates below hold the consequence)
    same = {}
    for m in (1, 8, 16, 512):
        x = _rand(gen, (m, 1536))
        for n in (1536, 256):
            w = _rand(gen, (1536, n))
            full = x @ w
            same[(m, n)] = all(torch.equal(
                x @ w[:, r * n // 2:(r + 1) * n // 2].contiguous(),
                full[:, r * n // 2:(r + 1) * n // 2]) for r in range(2))
    _log(f"[mesh] 17a bf16 GEMM column halves == the full GEMM's columns "
         f"(rows, cols): {same}")
    b, L, H, hkv, dk, c, ps = 8, 8192, 12, 2, 128, 512, 256
    q = _rand(gen, (b, 1, H, dk))
    qc = _rand(gen, (b, c, H, dk))
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    idx = torch.tensor([4095, 4000, 100, 3000, 8191, 5000, 2047, 4096],
                       dtype=torch.int32, device="cuda")
    pidx = torch.tensor([3584, 0, 1024, 3000, 7000, 512, 2048, 4096],
                        dtype=torch.int32, device="cuda")
    lens = torch.full((b,), c, dtype=torch.int32, device="cuda")
    g = H // hkv
    full_d = ops["consmax_decode"](q, k, v, idx, beta, gamma)
    full_p = ops["consmax_prefill"](qc, k, v, pidx, lens, beta, gamma)
    for j in range(hkv):
        hs = slice(j * g, (j + 1) * g)
        ks = slice(j, j + 1)
        part_d = ops["consmax_decode"](
            q[:, :, hs].contiguous(), k[:, :, ks].contiguous(),
            v[:, :, ks].contiguous(), idx, beta[hs].contiguous(),
            gamma[hs].contiguous())
        part_p = ops["consmax_prefill"](
            qc[:, :, hs].contiguous(), k[:, :, ks].contiguous(),
            v[:, :, ks].contiguous(), pidx, lens, beta[hs].contiguous(),
            gamma[hs].contiguous())
        _same_bits(f"consmax_decode head slice {j}", part_d, full_d[:, :, hs],
                   "the 12-head launch")
        _same_bits(f"consmax_prefill head slice {j}", part_p,
                   full_p[:, :, hs], "the 12-head launch")
    # pages: slot s's logical page j on page s * 32 + j of a 256 + 256 pool;
    # the pool split in two seq blocks of 16 positions each (block map)
    npg, pps = L // ps, (b * (L // ps)) // 2
    table = torch.full((b, npg), -1, dtype=torch.int32, device="cuda")
    kp = torch.zeros((2 * pps + 1, ps, hkv, dk), dtype=k.dtype,
                     device="cuda")
    vp = torch.zeros_like(kp)
    nxt = [0, pps]
    for s in range(b):
        for j in range(npg):
            d = min(j // (npg // 2), 1)
            page = nxt[d]
            nxt[d] += 1
            table[s, j] = page
            kp[page] = k[s, j * ps:(j + 1) * ps]
            vp[page] = v[s, j * ps:(j + 1) * ps]
    one_d = ops["consmax_decode_paged"](q, kp, vp, table, idx + 1, beta,
                                        gamma)
    one_p = ops["consmax_prefill_paged"](qc, kp, vp, table, pidx, lens, beta,
                                         gamma)
    sum_d = sum_p = 0
    for d in range(2):
        lt = CL.localize_page_table(table, d, pps)
        kl = torch.cat([kp[d * pps:(d + 1) * pps], kp[-1:]])
        vl = torch.cat([vp[d * pps:(d + 1) * pps], vp[-1:]])
        sum_d = sum_d + ops["consmax_decode_paged"](
            q, kl, vl, lt, idx + 1, beta, gamma).float()
        sum_p = sum_p + ops["consmax_prefill_paged"](
            qc, kl, vl, lt, pidx, lens, beta, gamma).float()
    within = [s for s in range(b) if int(idx[s]) < L // 2]
    pwithin = [s for s in range(b) if int(pidx[s]) + c <= L // 2]
    _same_bits("consmax_decode_paged seq-sharded sum (slots within one "
               "block)", sum_d.to(one_d.dtype)[within], one_d[within],
               "one pool")
    _same_bits("consmax_prefill_paged seq-sharded sum (slots within one "
               "block)", sum_p.to(one_p.dtype)[pwithin], one_p[pwithin],
               "one pool")
    spill_d = float((sum_d.to(one_d.dtype).float() - one_d.float()).abs()
                    .max())
    _log(f"[mesh] 17a kernels: decode / prefill launches of a 6-head, 1 KV "
         f"head slice == the 12-head launch's bits for those heads; the "
         f"paged kernels summed over two seq blocks == one pool's bits for "
         f"the {len(within)} decode / {len(pwithin)} prefill slots within "
         f"one block (incl. a slot filling the whole block, fill 4096); "
         f"slots that spill: max |diff| {spill_d:.3e} (fp32 sums regroup)")


def mesh_phase(smi):
    """17: the device mesh on the card (see the module docstring)."""
    import tempfile

    from repro_torch.configs.base import ServeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer
    from repro_torch.weights import init_params

    t17 = time.perf_counter()
    _head_and_hole_checks()
    cfg = get_config(MESH_ARCH)
    prompts, sampling, spill = _mesh_traffic(cfg.vocab_size)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        MESH_SEED), device="cuda")
    single = {}
    for name, sc in (("contiguous", MESH_CONTIG), ("paged", MESH_PAGED)):
        scfg = ServeConfig(**sc, score_norm=cfg.score_norm)
        eng, single[name] = _mesh_serve(
            cfg, scfg, model, prompts, sampling,
            spill if name == "paged" else None)
        del eng
        torch.cuda.empty_cache()
    del model
    tcfg_model = get_config("gpt2-consmax", compute_dtype="float32")
    tr = Trainer(tcfg_model, TrainConfig(**MESH_TRAIN), device="cuda",
                 model=init_params(tcfg_model, torch.Generator(
                     device="cuda").manual_seed(0), device="cuda"),
                 log_every=10 ** 9)
    one_card = [h["loss"] for h in tr.run(MESH_TRAIN_STEPS)]
    del tr
    torch.cuda.empty_cache()
    _log(f"[mesh] 17 single-device baselines {time.perf_counter() - t17:.1f}"
         f" s; ranks below share this one card ({smi}) over gloo: every "
         "tensor and kernel stays on the card, the collectives' transport "
         "goes through gloo, so the times below measure correctness and "
         "collective counts, not multi-card speed")
    base = dict(backend="gloo", own_cards=False, prompts=prompts,
                sampling=sampling)
    n_chunks = sum(-(-n // MESH_CONTIG["prefill_chunk"]) for n in MESH_LENS)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        w2 = _run_world(tmp, "tp2", 2, tp=2, ns=1, serve=MESH_CONTIG,
                        cp=True, train=True, **base)
        _log(f"[mesh] 17 world of 2 ranks (tp 2, contiguous; cp over 2; "
             f"FSDP training) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        w4 = _run_world(tmp, "tp2xseq2", 4, tp=2, ns=2, serve=MESH_PAGED,
                        cp=True, spill=spill, **base)
        _log(f"[mesh] 17 world of 4 ranks (tp 2 x seq 2, paged; cp over 4) "
             f"{time.perf_counter() - t0:.1f} s")
        for label, ranks, name, kernels, tp, ns in (
                ("17a tp 2, contiguous", w2, "contiguous",
                 ("consmax_decode", "consmax_prefill"), 2, 1),
                ("17a tp 2 x seq 2, paged", w4, "paged",
                 ("consmax_decode_paged", "consmax_prefill_paged"), 2, 2)):
            _mesh_gates(label, ranks, single[name], kernels, tp, ns, cfg,
                        n_chunks)
        for r in w4:
            same = r["serve"]["spill"] == single["paged"]["spill"]
            _log(f"[mesh] 17a spill: a {MESH_SPILL}-token prompt + "
                 f"{MESH_NEW} new (18 pages: 16 on seq rank 0, 2 on seq "
                 f"rank 1) served on rank {r['rank']}: {r['serve']['spill']}"
                 f" (== single device: {same}; not gated)")
        for world, ranks in ((2, w2), (4, w4)):
            for r in ranks:
                cp = r["cp"]
                _log(f"[mesh] 17b context-parallel decode, {world} ranks, "
                     f"rank {r['rank']} (b 8, L 8192, 12 / 2 heads, dk 128, "
                     f"fp32): ConSmax err {cp['consmax']['err']:.2e} "
                     f"{cp['consmax']['counts']}, {cp['consmax']['ms']:.3f} "
                     f"ms; softmax err {cp['softmax']['err']:.2e} "
                     f"{cp['softmax']['counts']}, {cp['softmax']['ms']:.3f} "
                     f"ms (ranks sharing one card)")
                n_cs = sum(c["calls"] for c in cp["consmax"]["counts"]
                           .values())
                n_sm = sum(c["calls"] for c in cp["softmax"]["counts"]
                           .values())
                if (n_cs != 1 or n_sm != 3 or cp["consmax"]["err"] > MESH_CP_TOL
                        or cp["softmax"]["err"] > MESH_CP_TOL):
                    raise AssertionError(f"17b: rank {r['rank']} of {world}: "
                                         f"{cp}")
        for r in w2:
            got = r["train"]["loss"]
            rel = float(np.max(np.abs(np.array(got) / np.array(one_card)
                                      - 1)))
            _log(f"[mesh] 17c FSDP training, gpt2-consmax (6 L, d 384, fp32,"
                 f" b 8 x s 256), rank {r['rank']} of 2: losses {got} vs one "
                 f"card {one_card}: max rel diff {rel:.2e} (tol "
                 f"{MESH_TRAIN_RTOL}); ms/step {np.round(r['train']['ms'], 1)}"
                 f" (ranks sharing one card)")
            if rel > MESH_TRAIN_RTOL:
                raise AssertionError("17c: 2-rank FSDP training != one card")
        mesh_wide_phase(tmp)
        if torch.cuda.device_count() >= 2:
            t0 = time.perf_counter()
            wn = _run_world(tmp, "nccl", 2, tp=2, ns=1, serve=MESH_CONTIG,
                            **dict(base, backend="nccl", own_cards=True))
            _mesh_gates("17d tp 2 over NCCL, one card per rank", wn,
                        single["contiguous"],
                        ("consmax_decode", "consmax_prefill"), 2, 1, cfg,
                        n_chunks)
            _log(f"[mesh] 17d {time.perf_counter() - t0:.1f} s")
        else:
            _log(f"[mesh] 17d NCCL across cards: this machine has "
                 f"{torch.cuda.device_count()} card; it waits for a machine "
                 "with two (not run, not a failure)")
    _log(f"[mesh] phase 17 {time.perf_counter() - t17:.1f} s")


def _column_slice_probe():
    """Does cuBLAS give a column half of a GEMM the full GEMM's bits? At
    the widths 17e serves: chatglm3-6b's q projection (bf16, K 4096, N 4096
    -> 2048) and qwen2-1.5b's at fp32 (K 1536, N 1536 -> 768). Printed, not
    gated: the mesh takes its heads' columns of the whole GEMM instead
    (distributed/serve_mesh), which holds whatever this prints."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    same = {}
    for dtype, kdim in ((torch.bfloat16, 4096), (torch.float32, 1536)):
        for m in (1, 8, 16, 512):
            x = torch.randn((m, kdim), generator=gen, device="cuda").to(dtype)
            w = torch.randn((kdim, kdim), generator=gen,
                            device="cuda").to(dtype)
            full = x @ w
            h = kdim // 2
            same[(str(dtype).replace("torch.", ""), m, kdim)] = all(
                torch.equal(x @ w[:, r * h:(r + 1) * h].contiguous(),
                            full[:, r * h:(r + 1) * h]) for r in range(2))
    _log(f"[mesh] 17e GEMM column halves == the full GEMM's columns "
         f"(dtype, rows, K = N): {same} (not gated: the ranks take their "
         "heads' columns of the whole q/k/v GEMMs)")


def mesh_wide_phase(tmp):
    """17e: tp 2 tokens == one device's past qwen2-1.5b's bf16 widths:
    chatglm3-6b (d 4096, 4 of 28 layers, both kernels) and qwen2-1.5b at
    fp32 compute (8 of 28 layers, plain walks); 4 requests, greedy and
    sampled, on the contiguous engine; the gates of 17a."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.weights import init_params

    t0 = time.perf_counter()
    _column_slice_probe()
    for arch, over, kernels in MESH_WIDE:
        cfg = get_config(arch, **over)
        r = np.random.default_rng(31)
        prompts = [r.integers(0, cfg.vocab_size, n).tolist()
                   for n in MESH_WIDE_LENS]
        sampling = [None if i % 2 == 0 else
                    dict(temperature=0.8, top_k=50, seed=200 + i)
                    for i in range(len(prompts))]
        serve = dict(MESH_CONTIG, decode_kernel=kernels,
                     prefill_kernel=kernels)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            MESH_SEED), device="cuda")
        eng, single = _mesh_serve(cfg, ServeConfig(
            **serve, score_norm=cfg.score_norm), model, prompts, sampling,
            new=MESH_WIDE_NEW)
        del eng, model
        torch.cuda.empty_cache()
        ranks = _run_world(tmp, f"wide-{arch}", 2, tp=2, ns=1, serve=serve,
                           arch=arch, over=over, backend="gloo",
                           own_cards=False, prompts=prompts,
                           sampling=sampling, new=MESH_WIDE_NEW)
        n_chunks = sum(-(-n // MESH_CONTIG["prefill_chunk"])
                       for n in MESH_WIDE_LENS)
        _mesh_gates(f"17e {arch} {over} tp 2, contiguous", ranks, single,
                    ("consmax_decode", "consmax_prefill") if kernels else (),
                    2, 1, cfg, n_chunks)
    _log(f"[mesh] 17e {time.perf_counter() - t0:.1f} s")


def _mesh_gates(label, ranks, single, kernels, tp, ns, cfg, n_chunks):
    """Every rank: tokens == the single-device engine's, each of its
    kernels launched (prefill once per chunk and layer), one signature per
    step, the collectives' bytes == the reckoning from the shapes. Prints
    memory, collectives per step and wall ms per iteration. ``kernels``
    empty: a plain-walk engine (fp32 compute), no launch to count."""
    H, dk, L = cfg.n_heads, cfg.head_dim_, cfg.n_layers
    eb = torch.empty((), dtype=cfg.cdtype()).element_size()
    for r in ranks:
        s = r["serve"]
        n_dec = s["steps"] - n_chunks
        rows = n_chunks * MESH_CONTIG["prefill_chunk"] + n_dec * (
            MESH_PAGED["max_slots"] if ns > 1 else MESH_CONTIG["max_slots"])
        want = {"all_gather": (L * s["steps"] if tp > 1 else 0,
                               L * rows * H * dk * eb if tp > 1 else 0),
                "all_reduce": (L * s["steps"] if ns > 1 else 0,
                               L * rows * (H // tp) * dk * 4 if ns > 1
                               else 0),
                "all_to_all": (0, 0), "collective_permute": (0, 0)}
        got = {k: (c["calls"], c["bytes"]) for k, c in
               s["collectives"].items()}
        ok = (s["tokens"] == single["tokens"] and s["signatures"] == [1, 1]
              and got == want
              and all(s["launches"][k] > 0 for k in kernels)
              and (not kernels or s["launches"][kernels[1]] == n_chunks * L))
        rk = r["reckon"]
        _log(f"[mesh] {label}, rank {r['rank']}: tokens == single device "
             f"{s['tokens'] == single['tokens']}; launches "
             f"{ {k: s['launches'][k] for k in kernels} }; signatures "
             f"{s['signatures']}; per model step ({s['steps']} steps: "
             f"{n_chunks} prefill chunks of {MESH_CONTIG['prefill_chunk']}, "
             f"{n_dec} decode) "
             + ", ".join(f"{k} {c / s['steps']:.0f} calls / "
                         f"{b / s['steps'] / 2**20:.3f} MiB" for k, (c, b)
                         in got.items() if c)
             + f" (reckoning: all-gather rows x {H} x {dk} x {eb} B, seq "
               f"all-reduce rows x {H // tp} x {dk} x 4 B, per layer: "
               f"{'equal' if got == want else want}); peak "
             f"{r['peak'] / 2**30:.2f} GiB (reckoning: full fp32 model "
             f"{rk['full'] / 2**30:.2f} at construction + the rank's copy "
             f"(whole q/k/v/o, its heads' beta/gamma) "
             f"{rk['local'] / 2**30:.2f} + bf16 copies <= "
             f"{rk['bf16'] / 2**30:.2f} + local KV {rk['kv'] / 2**30:.3f}); "
             f"{1e3 * s['wall'] / s['iters']:.1f} ms / iteration vs "
             f"{1e3 * single['wall'] / single['iters']:.1f} single device "
             f"(ranks sharing one card) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: rank {r['rank']} failed its gates")


# ------------------------------------- 18: head_dim 96, fp32, the gate ----
PHI3V = "phi-3-vision-4.2b"
# its phi3 backbone on the token frontend: neither package's continuous
# engine serves the stub patch frontend
PHI3V_OVER = dict(frontend="tokens")
PHI3V_LENS = [300, 1200, 700, 2000, 150, 900]
F32_ATOL = 2e-5               # the reference's fp32 kernel tolerance


def dk96_kernel_phase(flush):
    """The six attention kernels at phi-3-vision-4.2b's head_dim 96 (32
    heads, 32 KV heads: MHA): decode 8 slots x 4096 rows (bk 256), prefill
    chunk 512 at fills 0-4096, page size 256; each against its plain
    version; bounded == capacity sweep, paged == contiguous, int8 ==
    dequantized bits; the full-sequence kernels at b 1 x s 4096 causal,
    consmax_attention == consmax_prefill bits. Times and bounds; the
    full-sequence kernels' launches are their calls here (the ``dk96``
    path). Returns the rows of the result line and those counts."""
    from repro_torch.kernels import cache_layout as CL
    from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
    from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_cuda, consmax_decode_paged_cuda)
    from repro_torch.kernels.consmax_decode.ref import (
        consmax_decode_paged_ref, consmax_decode_ref)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_cuda, consmax_prefill_paged_cuda)
    from repro_torch.kernels.consmax_prefill.ref import (
        consmax_prefill_paged_ref, consmax_prefill_ref)
    from repro_torch.kernels.softmax_attn.ops import softmax_attention_op
    from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(96)
    b, L, H, hkv, dk, bk, c, ps = 8, 4096, 32, 32, 96, 256, 512, 256
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    lengths = torch.tensor([1, 256, 257, 1000, 2048, 3000, 4095, 4096],
                           dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    got = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw)
    err = _check("phi-3-vision decode dk=96 b=8 L=4096", got,
                 consmax_decode_ref(q.float(), k, v, lengths, beta, gamma,
                                    **kw),
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    _same_bits("phi-3-vision decode dk=96 capacity sweep",
               consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk,
                                   fill_bound=False, **kw), got,
               "the fill-bounded launch")
    kq, ksc = CL.quantize_kv(k, torch.int8)
    vq, vsc = CL.quantize_kv(v, torch.int8)
    _same_bits("phi-3-vision decode dk=96 int8 codes",
               consmax_decode_cuda(q, kq, vq, lengths, beta, gamma, bk=bk,
                                   k_scale=ksc, v_scale=vsc, **kw),
               consmax_decode_cuda(q, CL.dequant_block(kq, ksc, q.dtype),
                                   CL.dequant_block(vq, vsc, q.dtype),
                                   lengths, beta, gamma, bk=bk, **kw),
               "the bf16 kernel on the dequantized cache")
    del kq, vq, ksc, vsc
    live = int(lengths.sum())
    io = 2 * b * H * dk * 2
    times = {"consmax_decode": (
        err, lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                         bk=bk, **kw),
        lambda: consmax_decode_ref(q, k, v, lengths, beta, gamma, **kw),
        live * hkv * dk * 2 * 2 + io, 4 * live * H * dk)}
    perr, (kp, vp, table) = _paged_decode_case(
        "phi-3-vision paged decode dk=96 ps=256", q, k, v, lengths, beta,
        gamma, kw, bk=bk, ps=ps, num_pages=128)
    times["consmax_decode_paged"] = (
        perr, lambda: consmax_decode_paged_cuda(q, kp, vp, table, lengths,
                                                beta, gamma, bk=bk, **kw),
        lambda: consmax_decode_paged_ref(q, kp, vp, table, lengths, beta,
                                         gamma, **kw),
        live * hkv * dk * 2 * 2 + io + table.numel() * 4, 4 * live * H * dk)
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[7:8].contiguous(), v[7:8].contiguous()
    errs, perrs = [], []
    for idx, n in [(0, 512), (1536, 512), (3584, 512), (3000, 200)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        errs.append(_check(
            f"phi-3-vision prefill dk=96 c=512 index={idx} len={n}",
            consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
            consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                **kw)))
        e, pools = _paged_prefill_case(
            f"phi-3-vision paged prefill dk=96 index={idx} len={n}", q1, k1,
            v1, ti, tn, beta, gamma, kw, ps=ps, num_pages=32)
        perrs.append(e)
        if idx == 1536:
            timed = (ti, tn, *pools)
    ti, tn, kp1, vp1, t1 = timed
    idx, n = 1536, 512
    kvl = idx + n
    pairs = sum(min(idx + i + 1, kvl) for i in range(c))
    pbytes = kvl * hkv * dk * 2 * 2 + 2 * c * H * dk * 2
    times["consmax_prefill"] = (
        max(errs), lambda: consmax_prefill_cuda(q1, k1, v1, ti, tn, beta,
                                                gamma, **kw),
        lambda: consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
        pbytes, 4 * pairs * H * dk)
    times["consmax_prefill_paged"] = (
        max(perrs), lambda: consmax_prefill_paged_cuda(
            q1, kp1, vp1, t1, ti, tn, beta, gamma, **kw),
        lambda: consmax_prefill_paged_ref(q1, kp1, vp1, t1, ti, tn, beta,
                                          gamma, **kw),
        pbytes + t1.numel() * 4, 4 * pairs * H * dk)
    rows = {}
    for name, (e, fn, plain, nbytes, flops) in times.items():
        bound, by = _bound_ms(nbytes, flops)
        rows[f"{name}[phi-3-vision]"] = dict(
            max_abs_err=e, ms=_time_ms(fn, flush, 50),
            plain_ms=_time_ms(plain, flush, 5), bound_ms=bound, bound_by=by)
    del k, v, kp, vp, k1, v1, kp1, vp1

    # the full-sequence kernels at dk 96: b 1 x s 4096, causal
    def T(x):
        return x.transpose(1, 2)

    shape = (1, 4096, 4096, H, hkv, dk)
    qa = _rand(gen, (1, 4096, H, dk))
    ka, va = _rand(gen, (1, 4096, hkv, dk)), _rand(gen, (1, 4096, hkv, dk))
    consmax_attention_op.launches = softmax_attention_op.launches = 0
    out_c = consmax_attention_op(qa, ka, va, beta, gamma)
    out_s = softmax_attention_op(qa, ka, va)
    torch.cuda.synchronize()
    counts = {"consmax_attention[dk96]": consmax_attention_op.launches,
              "softmax_attention[dk96]": softmax_attention_op.launches}
    ec = _check("consmax_attention dk=96 b=1 s=4096 causal", out_c,
                T(consmax_attention_ref(T(qa.float()), T(ka), T(va), beta,
                                        gamma)),
                T(consmax_attention_ref(T(qa.float()), T(ka), T(va.abs()),
                                        beta, gamma)))
    es = _check("softmax_attention dk=96 b=1 s=4096 causal", out_s,
                T(softmax_attention_ref(T(qa.float()), T(ka), T(va))),
                T(softmax_attention_ref(T(qa.float()), T(ka), T(va.abs()))))
    qs = (qa[:, :1024].float() * dk ** -0.5).to(torch.bfloat16)
    ks, vs = ka[:, :1024].contiguous(), va[:, :1024].contiguous()
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    _same_bits("consmax_attention dk=96 s=1024 merged scale=1",
               consmax_attention_op(qs, ks, vs, beta, gamma, merged=True,
                                    scale=1.0),
               consmax_prefill_cuda(qs, ks, vs, one, one + 1024, beta, gamma,
                                    merged=True, scale=1.0, bk=1024),
               "consmax_prefill (index 0, lengths s, one shard)")
    bound, by = _attn_bound(*shape, causal=True)
    rows["consmax_attention[dk96]"] = dict(
        max_abs_err=ec, ms=_time_ms(lambda: consmax_attention_op(
            qa, ka, va, beta, gamma), flush, 10),
        plain_ms=_time_ms(lambda: consmax_attention_ref(
            T(qa), T(ka), T(va), beta, gamma), flush, 3),
        bound_ms=bound, bound_by=by, library_ms=None)
    rows["softmax_attention[dk96]"] = dict(
        max_abs_err=es, ms=_time_ms(lambda: softmax_attention_op(qa, ka, va),
                                    flush, 10),
        plain_ms=_time_ms(lambda: softmax_attention_ref(T(qa), T(ka), T(va)),
                          flush, 3),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(lambda: torch.nn.functional.
                            scaled_dot_product_attention(
                                T(qa), T(ka), T(va), is_causal=True),
                            flush, 10))
    return rows, counts


def fp32_kernel_phase(flush, f32_ptxas, smi):
    """The full-sequence kernels on fp32 operands (the 3xTF32 tensor-core
    kernel of csrc/attn_f32.cuh) at the paper's qwen2-1.5b shape (b 2 x s
    4096, 12 heads, 2 KV heads, dk 128, causal), then windowed /
    softcapped, non-causal cross-length, unmerged and dk 96 cases: each
    within the reference's fp32 atol 2e-5 of its plain version (fp32, TF32
    off), the same bits on a second run. Times beside the plain versions
    and scaled_dot_product_attention at fp32; bounds at the fp32
    (non-tensor) peak, the row's ``bound_ms``, and at the three TF32
    products of 3xTF32; the dk 128 instantiations' registers and spills
    (``f32_ptxas``, from ``f32_report``). Launches: the calls of the
    checks (the ``fp32`` path)."""
    from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
    from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref
    from repro_torch.kernels.softmax_attn.ops import softmax_attention_op
    from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(32)

    def T(x):
        return x.transpose(1, 2)

    def inputs(b, sq, skv, H, hkv, dk):
        q = torch.randn((b, sq, H, dk), generator=gen, device="cuda")
        k = torch.randn((b, skv, hkv, dk), generator=gen, device="cuda")
        v = torch.randn((b, skv, hkv, dk), generator=gen, device="cuda")
        return (q, k, v, *_head_params(gen, H))

    def within(name, got, ref):
        err = float((got - ref).abs().max())
        ok = (got.dtype == torch.float32 and bool(torch.isfinite(got).all())
              and err <= F32_ATOL)
        _log(f"[fp32] {name}: max_abs_err {err:.3e} (atol {F32_ATOL}, max "
             f"|plain| {float(ref.abs().max()):.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: fp32 kernel disagrees with plain")
        return err

    cases = [("qwen2-1.5b b=2 s=4096 causal", (2, 4096, 4096, 12, 2, 128),
              {}),
             ("window 300 softcap 30 s=1024", (1, 1024, 1024, 12, 2, 128),
              dict(window=300, softcap=30.0)),
             ("non-causal sq=200 skv=700", (1, 200, 700, 8, 2, 64),
              dict(causal=False)),
             ("dk 96 MHA s=600", (1, 600, 600, 8, 8, 96), {}),
             ("dk 32 s=333 unmerged", (2, 333, 333, 4, 1, 32), {})]
    consmax_attention_op.launches = softmax_attention_op.launches = 0
    errs = {"consmax": [], "softmax": []}
    data = {}
    for name, shape, kw in cases:
        q, k, v, beta, gamma = data[name] = inputs(*shape)
        for merged in (False, True):
            outs = [consmax_attention_op(q, k, v, beta, gamma, merged=merged,
                                         **kw) for _ in range(2)]
            _same_bits(f"fp32 consmax_attention {name} merged={merged} "
                       "second run", outs[1], outs[0], "the first run")
            errs["consmax"].append(within(
                f"consmax_attention fp32 {name} merged={merged}", outs[0],
                T(consmax_attention_ref(T(q), T(k), T(v), beta, gamma,
                                        merged=merged, **kw))))
        errs["softmax"].append(within(
            f"softmax_attention fp32 {name}",
            softmax_attention_op(q, k, v, **kw),
            T(softmax_attention_ref(T(q), T(k), T(v), **kw))))
    torch.cuda.synchronize()
    counts = {"consmax_attention[fp32]": consmax_attention_op.launches,
              "softmax_attention[fp32]": softmax_attention_op.launches}
    name, shape, _ = cases[0]
    q, k, v, beta, gamma = data[name]
    b, sq, skv, H, hkv, dk = shape
    nbytes = 4 * (2 * b * sq * H * dk + 2 * b * skv * hkv * dk)
    bound, by = _bound_ms(nbytes, 4 * dk * H * b * _visible_pairs(
        sq, skv, causal=True), peak=PEAK_FP32_FLOPS)
    rows = {
        "consmax_attention[fp32]": dict(
            max_abs_err=max(errs["consmax"]),
            ms=_time_ms(lambda: consmax_attention_op(q, k, v, beta, gamma),
                        flush, 3),
            plain_ms=_time_ms(lambda: consmax_attention_ref(
                T(q), T(k), T(v), beta, gamma), flush, 3),
            bound_ms=bound, bound_by=by, library_ms=None),
        "softmax_attention[fp32]": dict(
            max_abs_err=max(errs["softmax"]),
            ms=_time_ms(lambda: softmax_attention_op(q, k, v), flush, 3),
            plain_ms=_time_ms(lambda: softmax_attention_ref(T(q), T(k), T(v)),
                              flush, 3),
            bound_ms=bound, bound_by=by,
            library_ms=_time_ms(lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    T(q), T(k), T(v), is_causal=True,
                                    enable_gqa=True), flush, 3))}
    tf32 = _bound_ms(nbytes, 3 * 4 * dk * H * b * _visible_pairs(
        sq, skv, causal=True), peak=PEAK_TF32_FLOPS)[0]
    ptx = {"consmax_attention[fp32]": [("consmax_attn", 128, "Eq. 2"),
                                       ("consmax_attn", 128, "Eq. 3")],
           "softmax_attention[fp32]": [("softmax_attn", 128, "softmax")]}
    for name, row in rows.items():
        regs = "; ".join(
            f"{form} {f32_ptxas[(lib, d, form)]['registers']} registers, "
            f"spills {f32_ptxas[(lib, d, form)]['spill_stores']}/"
            f"{f32_ptxas[(lib, d, form)]['spill_loads']} B"
            for lib, d, form in ptx[name])
        _log(f"[fp32] {name} at {cases[0][0]}: {row['ms']:.4f} ms "
             f"(plain {row['plain_ms']:.4f} ms"
             + (f", scaled_dot_product_attention fp32 "
                f"{row['library_ms']:.4f} ms" if row["library_ms"]
                else "") + f"); bound {row['bound_ms']:.4f} ms by "
             f"{row['bound_by']} at the fp32 peak (share "
             f"{row['bound_ms'] / row['ms']:.3f}), {tf32:.4f} ms for "
             f"3xTF32's three products at the TF32 peak (share "
             f"{tf32 / row['ms']:.3f}); dk 128 ptxas: {regs}; launches "
             f"{counts}; on {smi}")
    return rows, counts


class _SyncFreeSteps:
    """Run an engine's static steps (``_prefill_step``, ``_decode_step``:
    the fused prefill chunk and decode step, each graph's eager run and its
    capture) under ``torch.cuda.set_sync_debug_mode("error")``: a step that
    syncs the host with the card raises. The staging copies, the token
    drain and the page table's upload stay outside the step, as the op
    lint's step does."""

    def __init__(self, eng):
        self.eng, self.steps = eng, 0
        for step in ("prefill", "decode"):
            real = getattr(eng, f"_{step}_step")

            def run(draw, real=real):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return real(draw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    self.steps += 1
            setattr(eng, f"_{step}_step", run)


def phi3v_engine_phase(smi, *, seed=13, new_tokens=16):
    """phi-3-vision-4.2b at full width (32 layers, d 3072, 32 heads, dk 96,
    its phi3 backbone on tokens, random weights from ``seed``) through the
    continuous engine with both kernels, contiguous (8 slots x 4096 rows)
    and paged (64 pages of 256), chunk 512; six requests, two sampled:
    paged == contiguous tokens, a greedy and a sampled request served
    alone == batched, one signature per step, every fused step under
    ``set_sync_debug_mode("error")``. Returns the four kernels' launches
    (contiguous for rows 1-2, paged for 3-4)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    cfg = get_config(PHI3V, **PHI3V_OVER)
    assert cfg.head_dim_ == 96
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in PHI3V_LENS]
    sampling = [SamplingParams(temperature=0.8, top_k=40, seed=300 + i)
                if i in (1, 4) else None for i in range(len(prompts))]
    base = dict(max_slots=8, max_seq=4096, prefill_chunk=512,
                decode_kernel=True, prefill_kernel=True,
                score_norm=cfg.score_norm)
    ops = _kernel_ops()

    def serve(scfg, batch, guard=False):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        sync = _SyncFreeSteps(eng) if guard else None
        uids = [eng.submit(prompts[i], new_tokens, sampling=sampling[i])
                for i in batch]
        for op in ops.values():
            op.launches = 0
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kind = "paged" if scfg.paged_kv else "contiguous"
        _graph_log(f"[phi-3-vision] {kind} engine, {len(uids)} requests",
                   eng)
        out = dict(tokens=[res.get(u) for u in uids], wall=wall,
                   launches={k: op.launches for k, op in ops.items()},
                   sig=[eng.prefill_cache_size, eng.decode_cache_size],
                   steps=sync.steps if sync else 0, iters=eng.model_steps)
        del eng
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    everyone = range(len(prompts))
    cont = serve(ServeConfig(**base), everyone, guard=True)
    paged = serve(ServeConfig(**base, paged_kv=True, page_size=256,
                              num_pages=64), everyone, guard=True)
    solo = {i: serve(ServeConfig(**base), [i])["tokens"][0] for i in (4, 2)}
    chunks = sum(-(-n // 512) for n in PHI3V_LENS)
    ok = (all(t is not None and len(t) == new_tokens for t in cont["tokens"])
          and paged["tokens"] == cont["tokens"]
          and all(solo[i] == cont["tokens"][i] for i in solo)
          and cont["sig"] == paged["sig"] == [1, 1]
          and cont["launches"]["consmax_prefill"] == chunks * cfg.n_layers
          and paged["launches"]["consmax_prefill_paged"]
          == chunks * cfg.n_layers
          and cont["launches"]["consmax_decode"] > 0
          and paged["launches"]["consmax_decode_paged"] > 0
          and cont["steps"] > 0 and paged["steps"] > 0)
    gen = sum(len(t) for t in cont["tokens"])
    _log(f"[phi-3-vision] full width ({cfg.n_layers} layers, d "
         f"{cfg.d_model}, {cfg.n_heads} heads, dk {cfg.head_dim_}), "
         f"{len(prompts)} requests ({sum(PHI3V_LENS)} prompt tokens, 2 "
         f"sampled): paged == contiguous {paged['tokens'] == cont['tokens']};"
         f" solo == batched {[solo[i] == cont['tokens'][i] for i in solo]};"
         f" signatures {cont['sig']} / {paged['sig']}; launches contiguous "
         f"{cont['launches']}, paged {paged['launches']}; "
         f"{cont['steps'] + paged['steps']} fused steps under "
         f"set_sync_debug_mode('error'), none synced; contiguous "
         f"{gen / cont['wall']:.1f} generated tok/s, "
         f"{1e3 * cont['wall'] / cont['iters']:.1f} ms per model step "
         f"({smi}); {time.perf_counter() - t0:.1f} s "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phi-3-vision engine gates failed")
    del model
    torch.cuda.empty_cache()
    return {f"{k}[phi-3-vision]": (cont if "paged" not in k else paged)
            ["launches"][k] for k in ops}


# (b, sq, skv, H, hkv, dk): the fp32 phase's cases and a dk 256 one
F32_PLAN_SHAPES = [(2, 4096, 4096, 12, 2, 128), (1, 1024, 1024, 12, 2, 128),
                   (1, 200, 700, 8, 2, 64), (1, 600, 600, 8, 8, 96),
                   (2, 333, 333, 4, 1, 32), (1, 700, 700, 8, 2, 256)]


def analysis_phase():
    """The port's analysis gate on the card: ``repro_torch.launch.analyze
    --device cuda --kv-dtype bfloat16 int8 fp8_e4m3`` (the qwen2-1.5b smoke
    matrix, trace guard on) must report 0 violations, and ``--self-test``
    must exit 1 with every rule fired. Every launch plan the gate captured,
    and every instantiation of the decode kernel and the mainloop, has the
    shared memory the library itself computes; so do the fp32 kernel's
    plans at ``F32_PLAN_SHAPES``, which also pass every launch contract."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import launch_plan as LP
    from repro_torch.kernels.consmax_decode import ops as decode_ops
    from repro_torch.launch import analyze

    t0 = time.perf_counter()
    out = Path(__file__).resolve().parent / "build" / "analysis"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "ANALYSIS_torch.json"
    rc = analyze.run(json_out=str(path), device="cuda",
                     kv_dtypes=("bfloat16", "int8", "fp8_e4m3"))
    gate_s = time.perf_counter() - t0
    report = json.loads(path.read_text())
    st = out / "ANALYSIS_torch_selftest.json"
    st_rc = analyze.main(["--self-test", "--device", "cuda", "--json-out",
                          str(st)])
    seeded = json.loads(st.read_text())
    all_fired = {f["rule"] for f in seeded["findings"]} == set(
        seeded["rules"])
    dec = decode_ops._lib()
    walk = _build.load("consmax_prefill")
    walk.attn_walk_smem_bytes.argtypes = [ctypes.c_int] * 3
    mismatch, checked = [], 0
    for label, entry in report["configs"].items():
        for kname, plan in entry["kernels"].items():
            lay = plan["layout"]
            lib_b = (dec.consmax_decode_smem_bytes(lay["dk"], lay["kv_type"],
                                                   lay["paged"], lay["bk"])
                     if plan["kernel"] == "decode_partials" else
                     walk.attn_walk_smem_bytes(lay["dk"], lay["kv_type"],
                                               lay["consumers"]))
            checked += 1
            if lib_b != plan["smem_bytes"]:
                mismatch.append((label, kname, plan["smem_bytes"], lib_b))
    for dk in _build.HEAD_DIMS:
        for kv in (0, 1, 2):
            for paged in (0, 1):
                for bk in (64, 128, 256, 512):
                    checked += 1
                    want = decode_ops.decode_smem_bytes(dk, kv != 0,
                                                        bool(paged), bk)
                    got = dec.consmax_decode_smem_bytes(dk, kv, paged, bk)
                    if got != want:
                        mismatch.append(("decode", dk, kv, paged, bk, want,
                                         got))
            for cons in ((1, 2) if dk <= 128 else (1,)):
                checked += 1
                want = LP.walk_smem_bytes(dk, kv != 0, cons)
                got = walk.attn_walk_smem_bytes(dk, kv, cons)
                if got != want:
                    mismatch.append(("walk", dk, kv, cons, want, got))
    # the fp32 kernel's plans at the fp32 phase's shapes (and dk 256):
    # every launch contract, and the library's shared memory
    from repro_torch.analysis.kernel_contracts import check_launch
    from repro_torch.kernels.consmax_attn.ops import (
        attention_plan as consmax_plan)
    from repro_torch.kernels.softmax_attn.ops import (
        attention_plan as softmax_plan)
    f32_libs = [_build.load(n) for n in ("consmax_attn", "softmax_attn")]
    f32_findings, f32_plans = [], 0
    for b, sq, skv, H, hkv, dk in F32_PLAN_SHAPES:
        q = torch.zeros((b, sq, H, dk), device="cuda")
        kv = torch.zeros((b, skv, hkv, dk), device="cuda")
        ones = torch.ones(H, device="cuda")
        for plan in (consmax_plan(q, kv, kv, ones, ones)[0],
                     softmax_plan(q, kv, kv)):
            f32_plans += 1
            f32_findings += check_launch(plan)
            for lib in f32_libs:
                lib.attn_f32_smem_bytes.argtypes = [ctypes.c_int]
                if lib.attn_f32_smem_bytes(dk) != plan.smem:
                    mismatch.append(("f32", dk, plan.smem,
                                     lib.attn_f32_smem_bytes(dk)))
        del q, kv
    checked += f32_plans
    _log(f"[analysis] fp32 kernel plans at {len(F32_PLAN_SHAPES)} shapes x "
         f"2 kernels: {len(f32_findings)} launch-contract violations "
         f"{[f.rule for f in f32_findings][:4]}")
    ok = (rc == 0 and report["violations"] == 0 and report["device"] ==
          "cuda" and st_rc == 1 and all_fired and not mismatch
          and not f32_findings)
    _log(f"[analysis] repro_torch.launch.analyze --device cuda --kv-dtype "
         f"bfloat16 int8 fp8_e4m3: {len(report['configs'])} configs, "
         f"{report['violations']} violations, exit {rc}, {gate_s:.1f} s; "
         f"--self-test exit {st_rc}, all {len(seeded['rules'])} rules fired "
         f"{all_fired}; shared memory of {checked} plans / instantiations "
         f"== the library's: {not mismatch} {mismatch[:4]} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 18: the analysis gate failed on the card")
    return gate_s


# ------------------------------------------------------------ phase 19 ----
# 19a: the dry run of the production (16, 16) mesh on the card's host, for
# the cells whose traces are short: the decode cells and jamba's long_500k
# (5-8 s of tracing each). The prefill and training cells of the same
# archs trace for 95-260 s each on that host; the CPU's `--all` sweep
# covers them (ROADMAP section 3)
DRY_CELLS = [("phi3.5-moe-42b-a6.6b", "decode_32k"), ("gemma2-2b", "decode_32k"),
             ("qwen2-1.5b", "decode_32k"), ("jamba-1.5-large-398b", "long_500k")]
# 19b: cells on one H100 (a (1, 1) mesh), only the batch cut:
# (arch, shape, batch, microbatch)
DRY_HOST = [("qwen2-1.5b", "decode_32k", 16, 4),
            ("qwen2-1.5b", "prefill_32k", 1, 4),
            ("gpt2-consmax", "train_4k", 16, 4)]
# 19c: fake against real collectives on a (2, 2) data x model mesh of four
# gloo ranks. Their shards live on the host's CPU: DTensor issues
# functional collectives, and the installed torch's gloo segfaults in
# wait_tensor on a functional all_gather_into_tensor of CUDA tensors (a
# probe on the card found it; its all_reduce works), so the fake trace
# takes the same CPU mesh. At fp32: at bf16 the row-parallel products'
# partial sums are rounded to bf16 before their all-reduce, and the 6-layer
# logits then differ from one device's by ~1.3e-2 row relative L2 (on the
# CPU), beyond any per-op bound; at fp32 the gate is 1e-5
DRY_MESH_CELL = dict(arch="gpt2-consmax", shape="decode_32k", batch=8,
                     mesh=[2, 2], device="cpu",
                     overrides=dict(param_dtype="float32",
                                    compute_dtype="float32"))
DRY_MESH_REL = 1e-5
# a whole model's logits, kernels against plain walks: phase 4's bound
# (bf16 rounds at other places in the two paths, over 28 layers); 19b holds
# each layer's decode kernel call to REL_L2_BOUND on the step's own inputs
MODEL_REL_L2 = 2.0 ** -4
F32 = dict(param_dtype="float32", compute_dtype="float32")
DRY_WORKERS = 4
DRY_TIMEOUT = 400            # seconds for one phase-19 child process
DRY_RANK_TIMEOUT = 240       # seconds for one world of phase-19 ranks
PIPE_STAGES, PIPE_MICRO, PIPE_SHAPE = 4, 6, (2, 512, 1536)


def _dryrun_jobs(tmp: Path) -> list:
    """(key, argv): 19b / 19c's fake traces and 19a's cells through
    ``repro_torch.launch.dryrun --device cuda``, niced, the longest first."""
    root = Path(__file__).resolve().parent
    nice = ["nice", "-n", "19", sys.executable]
    jobs = [(f"host:{a}:{s}", nice + [str(root / "chip_smoke.py"),
                                      "--dryrun-host", a, s, str(b), str(m),
                                      str(tmp / f"host-{a}-{s}.json")])
            for a, s, b, m in DRY_HOST[1:] + DRY_HOST[:1]]
    jobs.append(("mesh-fake", nice + [str(root / "chip_smoke.py"),
                                      "--dryrun-meshfake",
                                      str(tmp / "mesh-fake.json")]))
    jobs += [(f"{a}:{s}", nice + ["-m", "repro_torch.launch.dryrun",
                                  "--device", "cuda", "--arch", a,
                                  "--shape", s, "--out",
                                  str(tmp / "dryrun_torch")])
             for a, s in DRY_CELLS]
    return jobs


def _child(argv) -> tuple:
    """(exit code, stdout, stderr's tail, seconds) of one phase-19 child
    process, killed after DRY_TIMEOUT (exit code None)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root / "src"))
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              cwd=root, timeout=DRY_TIMEOUT)
    except subprocess.TimeoutExpired:
        return None, "", f"killed after {DRY_TIMEOUT} s", time.monotonic() - t0
    return (proc.returncode, proc.stdout, proc.stderr[-3000:],
            time.monotonic() - t0)


def dryrun_host_child(arch, shape, batch, micro, out):
    """``chip_smoke.py --dryrun-host``: the fake trace of one 19b cell on
    a (1, 1) mesh, its roofline record written to ``out``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_cell
    mesh = make_host_mesh(device="cuda")
    cell = make_cell(arch, shape, mesh, global_batch=int(batch),
                     microbatch=int(micro), device="cuda")
    traced = D.trace_cell(cell)
    rec = dict(D.roofline(cell, traced, 1), meta=cell.meta,
               trace_sec=traced["trace_sec"])
    Path(out).write_text(json.dumps(rec))


def dryrun_meshfake_child(out):
    """``chip_smoke.py --dryrun-meshfake``: 19c's cell traced for one
    device of a fake (2, 2) mesh; its collective records to ``out``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import _fake_mesh
    from repro_torch.launch.specs import make_cell
    c = DRY_MESH_CELL
    mesh = _fake_mesh(tuple(c["mesh"]), ("data", "model"), c["device"])
    cell = make_cell(c["arch"], c["shape"], mesh, global_batch=c["batch"],
                     overrides=c["overrides"], device=c["device"])
    traced = D.trace_cell(cell)
    Path(out).write_text(json.dumps(dict(records=traced["records"],
                                         trace_sec=traced["trace_sec"])))


def _median_ms(fn, reps=5, warm=2):
    """Median device time of ``fn`` over ``reps`` calls after ``warm``
    (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def _row_rel_l2(got, ref):
    g, r = got.float(), ref.float()
    return float(((g - r).norm(dim=-1) / r.norm(dim=-1).clamp(min=1e-30))
                 .max())


def dryrun_real_child(kinds):
    """``chip_smoke.py --dryrun-real KINDS``: 19b's cells of the comma-
    joined kinds (decode, prefill, train) run for real on the
    card on the same arguments' shapes (a seeded ``materialize``): device
    ms (median of 5 after 2 warm-ups) and the step's peak memory above its
    arguments; the decode cell also through the decode kernel, on fresh
    arguments of the same seed, its logits held to a fresh plain step's.
    Prints one JSON line."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import ServeConfig
    from repro_torch.distributed import op_analysis as OA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_cell, materialize, run
    from repro_torch.serve import engine as SE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(device="cuda")
    out = {}
    for arch, shape, batch, micro in DRY_HOST:
        if shape.split("_")[0] not in kinds.split(","):
            continue
        cell = make_cell(arch, shape, mesh, global_batch=batch,
                         microbatch=micro, device="cuda")
        box = {"args": materialize(cell, seed=0, device="cuda")}
        arg_bytes = sum(n for _, n in OA._storages(box["args"]).values())

        def step():
            box["out"] = run(cell, box["args"])

        ms, times = _median_ms(step)
        box.pop("out")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step()
        torch.cuda.synchronize()
        delta = torch.cuda.max_memory_allocated() - before
        row = dict(ms=ms, times=times, arg_bytes=arg_bytes, delta=delta)
        box.clear()
        torch.cuda.empty_cache()
        if cell.kind == "decode":
            box["args"] = materialize(cell, seed=0, device="cuda")
            plain = run(cell, box["args"])[0].float().clone()
            scfg = ServeConfig(max_seq=cell.meta["seq_len"],
                               fused_sampling=False, decode_kernel=True)
            _, _, kstep, _ = SE.make_serve_fns(cell.cfg, scfg, device="cuda")

            def kernel_step():
                box["out"] = kstep(*box["args"])

            box["args"] = materialize(cell, seed=0, device="cuda")
            with _each_decode_call() as calls:
                kernel_step()
            kernel = box["out"][0].float().clone()
            row["layers"], row["n_layers"] = calls, cell.cfg.n_layers
            row["kernel_rel_l2"] = _row_rel_l2(kernel, plain)
            row["kernel_ms"], row["kernel_times"] = _median_ms(kernel_step)
            row["kernel_profile"] = _device_profile(kernel_step)
            row.update(_decode_at_cell_shape(box["args"]))
            box.clear()
            torch.cuda.empty_cache()
            exact = _exact_logits(cell, mesh, batch, micro)
            row["plain_vs_f32"] = _row_rel_l2(plain, exact)
            row["kernel_vs_f32"] = _row_rel_l2(kernel, exact)
            del exact
            torch.cuda.empty_cache()
            box["args"] = materialize(cell, seed=0, device="cuda")
            row["profile"] = _device_profile(step)
            box.clear()
            torch.cuda.empty_cache()
        out[f"{arch}:{shape}"] = row
    print(json.dumps(out), flush=True)


@contextlib.contextmanager
def _each_decode_call():
    """Every ``consmax_decode_op`` call inside, its kernel's output held to
    its plain version on the call's own inputs (q, the layer's cache after
    this step's write, lengths, beta, gamma): a list of ``_kernel_err``'s
    (ok, max_abs_err, max row relative L2), one per call."""
    from repro_torch.kernels.consmax_decode import ops
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    orig, seen = ops.consmax_decode_op, []

    def checked(q, k, v, index, beta, gamma, **kw):
        out = orig(q, k, v, index, beta, gamma, **kw)
        plain_kw = {n: kw[n] for n in ("window", "softcap", "merged", "scale",
                                       "k_scale", "v_scale") if n in kw}
        ref, ref_absv = (consmax_decode_ref(q[:, 0], k, vv, index + 1, beta,
                                            gamma, **plain_kw)
                         for vv in (v, v.abs()))
        seen.append(_kernel_err(out[:, 0], ref, ref_absv))
        return out

    checked.launches = orig.launches          # the wrapper counts launches
    ops.consmax_decode_op = checked           # on the name it is bound to
    try:
        yield seen
    finally:
        ops.consmax_decode_op, orig.launches = orig, checked.launches


def _f32(tree):
    """``tree`` (a module, dicts, lists, tensors) with every floating tensor
    cast up to fp32, in place where it can be: a bf16 value is exact in
    fp32."""
    if isinstance(tree, torch.nn.Module):
        return tree.float()
    if isinstance(tree, dict):
        for key, val in tree.items():
            tree[key] = _f32(val)
        return tree
    if isinstance(tree, list):
        for i, val in enumerate(tree):
            tree[i] = _f32(val)
        return tree
    if isinstance(tree, tuple):
        return tuple(_f32(val) for val in tree)
    return tree.float() if tree.is_floating_point() else tree


def _exact_logits(cell, mesh, batch, micro):
    """The decode cell's plain step at fp32 (weights, cache and compute) on
    the bf16 arguments' values: the model both bf16 steps approximate."""
    from repro_torch.launch.specs import make_cell, materialize, run
    c32 = make_cell(cell.arch_id, cell.shape_name, mesh, global_batch=batch,
                    microbatch=micro, overrides=F32, device="cuda")
    args = _f32(materialize(cell, seed=0, device="cuda"))
    return run(c32, args)[0].float()


def _device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy ms (the
    union of the device events) and the four kernels taking most time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by = 0.0, float("-inf"), defaultdict(float)
    for e in sorted(dev, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        by[e.name[:48]] += e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    return dict(busy_ms=busy / 1e3, ops=len(dev),
                top=[[n, round(t, 3)] for n, t in top])


def _decode_at_cell_shape(args) -> dict:
    """Row 1 (``consmax_decode``) on layer 0's cache of the decode cell
    (b 16 x L 32,768, 2 KV heads, every row live) against its plain
    version, the repo's kernel bound (``_check``), and its time beside its
    byte bound."""
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    _, caches, _ = args
    k, v = caches[0]["b0"]["attn"]["k"], caches[0]["b0"]["attn"]["v"]
    b, L, hkv, dk = k.shape
    H = 12
    gen = torch.Generator(device="cuda").manual_seed(191)
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    beta, gamma = _head_params(gen, H)
    lengths = torch.full((b,), L, dtype=torch.int32, device="cuda")
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=256, **kw)
    err = _check(f"decode b={b} L={L} every row live", got,
                 consmax_decode_ref(q.float(), k, v, lengths, beta, gamma,
                                    **kw),
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = _time_ms(lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                              bk=256, **kw), flush, 20)
    bound, _ = _bound_ms(b * L * hkv * dk * 2 * 2 + 2 * b * H * dk * 2,
                         4 * b * L * H * dk)
    return dict(layer_err=err, layer_ms=ms, layer_bound_ms=bound)


def dry_rank_child(spec_path, rank):
    """``chip_smoke.py --dry-rank``: one rank of 19c (the mesh cell on its
    real shards, its collectives recorded, its logits beside one device's)
    or 19d (GPipe over qwen2-1.5b's blocks, on the one card) over gloo."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import init_distributed
    spec = json.loads(Path(spec_path).read_text())
    on_card = spec["job"] == "pipe" or DRY_MESH_CELL["device"] == "cuda"
    init_distributed("gloo", rank=rank, world_size=spec["world"],
                     init_method=f"file://{spec['store']}",
                     device=torch.device("cuda", 0) if on_card else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = (_dry_cell_rank(spec) if spec["job"] == "cell"
           else _dry_pipe_rank(spec))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(dict(out, rank=rank)), flush=True)


def _dry_cell_rank(spec):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.op_analysis import record_collectives
    from repro_torch.launch.specs import make_cell, materialize, run
    c = DRY_MESH_CELL
    dev = c["device"]
    if dev == "cpu":
        torch.set_num_threads(1)          # four ranks share the host
    mesh = init_device_mesh(dev, tuple(c["mesh"]),
                            mesh_dim_names=("data", "model"))
    cell = make_cell(c["arch"], c["shape"], mesh, global_batch=c["batch"],
                     overrides=c["overrides"], device=dev)
    args = materialize(cell, seed=0, device=dev)
    with record_collectives() as rec:
        logits, _ = run(cell, args)
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    logits = logits.float().cpu()
    del args
    out = dict(records=rec.records, finite=bool(torch.isfinite(logits).all()),
               shape=list(logits.shape),
               digest=hashlib.sha256(logits.numpy().tobytes()).hexdigest())
    if torch.distributed.get_rank() == 0:
        # every rank's gathered logits have rank 0's bits (the digests), so
        # one whole-model run on one device serves all four
        one, _ = run(cell, materialize(cell, seed=0, device=dev, whole=True))
        out["rel_l2"] = _row_rel_l2(logits, one.cpu())
    return out


def _dry_pipe_rank(spec):
    """GPipe: rank s runs blocks [7s, 7s + 7) of qwen2-1.5b (bf16 weights
    from a seed, the same on every rank); 6 microbatches of (2, 512, 1536)
    bf16 hidden states. Rank 0 also runs the 28 blocks in order, one
    microbatch at a time, on one device."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import comm as COMM
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params
    cfg = get_config("qwen2-1.5b", param_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(19)
    model = T.cast_param_dtype(init_params(cfg, gen, device="cuda"), cfg)
    blocks = [sup["b0"] for sup in model.blocks]
    per = cfg.n_layers // PIPE_STAGES
    xs = torch.randn((PIPE_MICRO,) + PIPE_SHAPE, generator=gen,
                     device="cuda").to(torch.bfloat16)
    pos = torch.arange(PIPE_SHAPE[1], device="cuda")[None, :]

    @torch.no_grad()
    def stage_fn(blks, x):
        for blk in blks:
            x, _, _ = blk(x, cfg, positions=pos)
        return x

    comm = COMM.Comm()
    mine = blocks[comm.rank * per:(comm.rank + 1) * per]
    COMM.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = gpipe(stage_fn, mine, xs, comm=comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = COMM.calls()
    res = dict(calls=[(c["kind"], c["bytes"]) for c in calls], wall_s=wall)
    if comm.rank == 0:
        seq = torch.stack([stage_fn(blocks, xs[m])
                           for m in range(PIPE_MICRO)])
        res.update(equal=bool(torch.equal(outs, seq)),
                   max_abs=float((outs.float() - seq.float()).abs().max()),
                   finite=bool(torch.isfinite(outs.float()).all()))
    return res


def _dry_world(tmp, job, world):
    from repro_torch.launch.mesh import run_ranks
    path = tmp / f"dry-{job}.json"
    path.write_text(json.dumps(dict(job=job, world=world,
                                    store=str(tmp / f"dry-{job}.store"))))
    # 19c's ranks run on the CPU beside the card's steps: niced
    nice = ["nice", "-n", "10"] if job == "cell" else []
    outs = run_ranks([nice + [sys.executable, str(Path(__file__).resolve()),
                              "--dry-rank", str(path), str(r)]
                      for r in range(world)], timeout=DRY_RANK_TIMEOUT)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def dryrun_phase(smi, tmp: Path):
    """19: the dry run on the card's host (19a), against one H100 (19b),
    its collectives against real ranks (19c), GPipe on the card (19d) and
    the three examples (19e). 19b's decode steps run first, beside the
    longest fake trace only; the other traces then run DRY_WORKERS at a
    time beside the rest, and 19c's CPU ranks beside the card's steps."""
    t19 = time.perf_counter()
    failed = []

    def attempt(label, fn):
        """``fn()``, its seconds logged; a failure is recorded (the phase
        raises at its end, after printing what did run)."""
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — reported, then raised below
            failed.append(f"{label}: {type(e).__name__}: {str(e)[-2000:]}")
            _log(f"[dryrun] {label} FAIL: {type(e).__name__}: "
                 f"{str(e)[-2000:]}")
            return None
        finally:
            _log(f"[dryrun] {label} {time.perf_counter() - t0:.1f} s")

    def real_steps(kinds):
        rc, out, err, _ = _child([sys.executable,
                                  str(Path(__file__).resolve()),
                                  "--dryrun-real", kinds])
        if rc != 0:
            raise AssertionError(f"exit {rc}: {err}")
        return json.loads(out.strip().splitlines()[-1])

    # the decode cell's kernel step is host-bound: it runs beside one niced
    # process only, the longest trace (19b's prefill cell); the prefill and
    # training steps are device-bound, and run beside the other traces and
    # 19c's CPU ranks
    jobs = _dryrun_jobs(tmp)
    with ThreadPoolExecutor(DRY_WORKERS) as pool, \
            ThreadPoolExecutor(1) as side:
        traces = {jobs[0][0]: pool.submit(_child, jobs[0][1])}
        real = attempt("19b real decode steps",
                       lambda: real_steps("decode")) or {}
        traces.update({key: pool.submit(_child, argv)
                       for key, argv in jobs[1:]})
        cell_world = side.submit(attempt, "19c mesh-cell world",
                                 lambda: _dry_world(tmp, "cell", 4))
        real.update(attempt("19b real prefill / train steps",
                            lambda: real_steps("prefill,train")) or {})
        pipe = attempt("19d GPipe world", lambda: _dry_world(
            tmp, "pipe", PIPE_STAGES)) or []
        examples = attempt("19e examples", _run_examples) or {}
        ranks = cell_world.result() or []
        results = attempt("waiting for the fake traces", lambda: {
            key: f.result() for key, f in traces.items()}) or {}

    # ---- 19a
    for a, s in DRY_CELLS:
        rc, _, err, secs = results.get(f"{a}:{s}", (None, "", "not run", 0))
        path = tmp / "dryrun_torch" / f"{a}--{s}--single_pod.json"
        rec = json.loads(path.read_text()) if path.exists() else {
            "status": f"no record (exit {rc}): {err[-500:]}"}
        if rec["status"] != "ok":
            failed.append(f"19a {a} x {s}: {rec.get('error', rec['status'])}")
            _log(f"[dryrun] 19a {a} x {s}: {rec['status']} "
                 f"{rec.get('error', '')[:300]} FAIL")
            continue
        r, h, c = rec["roofline"], rec["hbm"], rec["collectives"]
        _log(f"[dryrun] 19a {a} x {s} (16 x 16): ok, dominant "
             f"{r['dominant']}, roofline_fraction "
             f"{r['roofline_fraction']:.4f}, bound {r['bound_sec']:.4e} s, "
             f"ideal {r['ideal_sec']:.4e} s, peak "
             f"{h['peak_bytes_per_device'] / 2**30:.2f} GiB, fits_80GB "
             f"{h['fits_80GB']}, collective bytes {c['bytes_by_kind']}, "
             f"trace_sec {rec['trace_sec']:.1f} (process {secs:.1f} s), "
             f"fallbacks {len(rec['fallbacks'])}")

    # ---- 19b
    for a, s, b, m in DRY_HOST:
        rc, _, err, secs = results.get(f"host:{a}:{s}",
                                       (None, "", "not run", 0))
        path = tmp / f"host-{a}-{s}.json"
        if rc != 0 or not path.exists() or f"{a}:{s}" not in real:
            failed.append(f"19b {a} x {s}: trace exit {rc}: {err[-800:]}")
            continue
        rec = json.loads(path.read_text())
        row = real[f"{a}:{s}"]
        r = rec["roofline"]
        bound_ms, ideal_ms = 1e3 * r["bound_sec"], 1e3 * r["ideal_sec"]
        dry_peak = rec["hbm"]["peak_bytes_per_device"]
        peak = rec["memory"]["argument_bytes"] + row["delta"]
        ok_t = row["ms"] >= 0.95 * bound_ms
        ok_m = abs(peak - dry_peak) <= 0.10 * dry_peak
        ok_args = row["arg_bytes"] == rec["memory"]["argument_bytes"]
        _log(f"[dryrun] 19b {a} x {s} (batch {b}, 1 x 1): measured "
             f"{row['ms']:.3f} ms (median of {len(row['times'])}: "
             f"{[round(t, 3) for t in row['times']]}), dry-run bound "
             f"{bound_ms:.3f} ms ({r['dominant']}: compute "
             f"{1e3 * r['compute_sec']:.3f}, memory "
             f"{1e3 * r['memory_sec']:.3f} ms from "
             f"{rec['cost']['bytes'] / 1e9:.2f} GB, "
             f"{rec['cost']['flops'] / 1e12:.2f} TFLOP), measured / bound "
             f"{row['ms'] / bound_ms:.3f} {'ok' if ok_t else 'FAIL'}; "
             f"ideal {ideal_ms:.3f} ms, ideal / measured "
             f"{ideal_ms / row['ms']:.4f}; peak {peak / 1e9:.3f} GB "
             f"(arguments {rec['memory']['argument_bytes'] / 1e9:.3f} + "
             f"step {row['delta'] / 1e9:.3f}) vs dry run "
             f"{dry_peak / 1e9:.3f} GB ({peak / dry_peak:.3f}) "
             f"{'ok' if ok_m else 'FAIL'}; arguments equal "
             f"{ok_args}; trace {rec['trace_sec']:.1f} s; on {smi}")
        if not (ok_t and ok_m and ok_args):
            failed.append(f"19b {a} x {s}")
        if "kernel_ms" in row:
            layers = row["layers"]
            ok_l = (len(layers) == row["n_layers"]
                    and all(ok for ok, _, _ in layers))
            ok_k = (row["kernel_rel_l2"] <= MODEL_REL_L2
                    and row["kernel_vs_f32"] <= MODEL_REL_L2 and ok_l)
            _log(f"[dryrun] 19b {a} x {s} through the decode kernel "
                 f"(b {b} x L {rec['meta']['seq_len']}, every row live): "
                 f"{row['kernel_ms']:.3f} ms (median of 5: "
                 f"{[round(t, 3) for t in row['kernel_times']]}); row 1 "
                 f"alone on layer 0's cache {row['layer_ms']:.4f} ms vs "
                 f"its byte bound {row['layer_bound_ms']:.4f} ms; each of "
                 f"the step's {len(layers)} decode kernel calls vs its plain "
                 f"version on the same inputs: max row relative L2 per layer "
                 f"{[float(f'{r:.3e}') for _, _, r in layers]}, largest "
                 f"{max((r for _, _, r in layers), default=float('nan')):.3e}"
                 f", max_abs_err {max((e for _, e, _ in layers), default=0):.3e}"
                 f" (the kernel bound: relative L2 per row <= "
                 f"{REL_L2_BOUND:.3e} and elementwise) "
                 f"{'ok' if ok_l else 'FAIL'}; the step's logits, row "
                 f"relative L2: kernel vs plain {row['kernel_rel_l2']:.3e}, "
                 f"against the fp32 step on the same values: plain bf16 "
                 f"{row['plain_vs_f32']:.3e}, kernel {row['kernel_vs_f32']:.3e}"
                 f" (the model-level bound {MODEL_REL_L2:.3e} of phase 4) "
                 f"{'ok' if ok_k else 'FAIL'}; ideal / measured: plain "
                 f"{ideal_ms / row['ms']:.4f}, kernel "
                 f"{ideal_ms / row['kernel_ms']:.4f}; one step under "
                 f"torch.profiler: plain busy {row['profile']['busy_ms']:.2f} "
                 f"ms over {row['profile']['ops']} device ops, top "
                 f"{row['profile']['top']}; kernel busy "
                 f"{row['kernel_profile']['busy_ms']:.2f} ms over "
                 f"{row['kernel_profile']['ops']} ops, top "
                 f"{row['kernel_profile']['top']}; on {smi}")
            if not ok_k:
                failed.append(f"19b {a} x {s} decode kernel")

    # ---- 19c
    rc, _, err, _ = results.get("mesh-fake", (None, "", "not run", 0))
    if rc != 0 or not ranks:
        failed.append(f"19c fake trace exit {rc}: {err[-800:]}")
    else:
        fake = json.loads((tmp / "mesh-fake.json").read_text())["records"]
        same = [res["records"] == fake for res in ranks]
        r0 = next(res for res in ranks if res["rank"] == 0)
        rel, bits = r0["rel_l2"], [res["digest"] == r0["digest"]
                                   for res in ranks]
        ok = (all(same) and rel <= DRY_MESH_REL and all(bits)
              and all(res["finite"] for res in ranks) and len(fake) > 0)
        by = {}
        for rr in fake:
            by[rr["kind"]] = by.get(rr["kind"], 0) + rr["bytes"]
        _log(f"[dryrun] 19c {DRY_MESH_CELL['arch']} x "
             f"{DRY_MESH_CELL['shape']} batch {DRY_MESH_CELL['batch']} on "
             f"(2, 2), 4 ranks over gloo, shards on "
             f"{DRY_MESH_CELL['device']}: {len(fake)} "
             f"collectives {by}; each rank's records == the dry run's "
             f"{same}; every rank's gathered logits have rank 0's bits "
             f"{bits}; fp32 logits row relative L2 vs one device {rel:.3e} "
             f"(bound {DRY_MESH_REL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append("19c")

    # ---- 19d
    r0 = next((res for res in pipe if res["rank"] == 0),
              dict(equal=False, finite=False, max_abs=float("nan")))
    hop = np.prod(PIPE_SHAPE) * 2
    want = ([["collective_permute", int(hop)]] * (PIPE_MICRO + PIPE_STAGES - 1)
            + [["all_reduce", int(hop * PIPE_MICRO)]])
    calls_ok = bool(pipe) and all(
        [list(c) for c in res["calls"]] == want for res in pipe)
    ok = r0["equal"] and r0["finite"] and calls_ok
    _log(f"[dryrun] 19d GPipe: qwen2-1.5b's 28 blocks over {PIPE_STAGES} "
         f"stages, {PIPE_MICRO} microbatches of {PIPE_SHAPE} bf16: outputs "
         f"== the sequential forward bit for bit {r0['equal']} (max |diff| "
         f"{r0['max_abs']:.3e}); every rank {PIPE_MICRO + PIPE_STAGES - 1} "
         f"permutes of {int(hop)} B + 1 all-reduce of "
         f"{int(hop * PIPE_MICRO)} B: {calls_ok}; wall "
         f"{[round(res['wall_s'], 3) for res in pipe]} s "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("19d")

    # ---- 19e
    for name, (rc, tail) in examples.items():
        _log(f"[dryrun] 19e examples/{name} --device cuda: exit {rc} "
             f"{'ok' if rc == 0 else 'FAIL'}: {tail}")
        if rc != 0:
            failed.append(f"19e {name}")
    _log(f"[dryrun] phase 19 {time.perf_counter() - t19:.1f} s")
    if failed:
        raise AssertionError(f"phase 19 failed: {failed}")


def _run_examples() -> dict:
    """The three root examples of the port with ``--device cuda``, at once;
    {name: (exit code, last line)}."""
    import os
    import tempfile
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    ckpt = tempfile.mkdtemp(dir=root / "build")
    argv = {"quickstart": [], "serve_batched": [],
            "elastic_restart": ["--ckpt", str(Path(ckpt) / "elastic")]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cuda", *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=root) for name, extra in argv.items()}
    out = {}
    for name, p in procs.items():
        try:
            text, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        lines = text.strip().splitlines()
        out[name] = (p.returncode, " | ".join(lines[-3:])[-600:])
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _log(smi)
    _log(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("[header] TF32 off for fp32 matmuls and cuDNN convolutions")

    t0 = time.perf_counter()
    built = _build.build()
    _log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s "
         f"(one nvcc per source, in parallel)")
    mainloop_report()
    decode_report()
    f32_ptxas = f32_report()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    rows = kernel_phase(flush)
    _log(f"[kernels] contiguous phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows.update(paged_kernel_phase(flush))
    _log(f"[kernels] paged phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paper_rows, paper_counts = paper_kernel_phase(flush)
    rows.update(paper_rows)
    _log(f"[paper] paper kernel phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows.update(quantized_kernel_phase(flush))
    _log(f"[quantized] quantized kernel phase "
         f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows.update(gemma2_kernel_phase(flush))
    _log(f"[kernels] gemma2-2b (dk 256) phase {time.perf_counter() - t0:.1f} "
         f"s")
    torch.cuda.empty_cache()
    del flush
    for name, row in rows.items():
        lib = row.get("library_ms")
        _log(f"[kernels] {name}: {row['ms'] * 1e3:.1f} us (plain "
             f"{row['plain_ms'] * 1e3:.1f} us), bound "
             f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']} (share "
             f"{row['bound_ms'] / row['ms']:.3f})"
             + (f", scaled_dot_product_attention {lib * 1e3:.1f} us"
                if lib else "") + f"; on {smi}")
    _log(f"[kernels] largest row relative L2 error of all checks "
         f"{_worst_rel[0]:.3e} (bound {REL_L2_BOUND:.3e})")
    _log(f"[kernels] tolerance: {TOL_NOTE}; with normalized p for "
         f"softmax; the LUT bit-equal to its plain version and within "
         f"relative 1e-5 of C*exp(scale*s). No single PyTorch call computes "
         f"ConSmax attention or the LUT, so their library_ms is null; the "
         f"softmax kernel's is scaled_dot_product_attention (timed only)")

    t0 = time.perf_counter()
    model_phase()
    _log(f"[model] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lens = np.linspace(200, 6000, 12).astype(int)
    counts = engine_phase("qwen2-1.5b", max_seq=8192, chunk=512,
                          prompt_lens=list(np.random.default_rng(2)
                                           .permutation(lens)),
                          new_tokens=32, seed=0, trace=True)
    _log(f"[engine] qwen2-1.5b phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_phase("gpt2-consmax", max_seq=1024, chunk=128,
                 prompt_lens=[20, 700, 131, 256, 999, 64], new_tokens=16,
                 seed=3, kv_block=64)
    _log(f"[engine] gpt2-consmax phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graph_phase(smi)
    _log(f"[graph] phase 5b {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts.update(paged_engine_phase()[0])
    _log(f"[paged] qwen2-1.5b paged phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paged8, cont8 = paged_engine_phase(kv_dtype="int8")
    counts.update({f"{k}[int8]": n for k, n in {**paged8, **cont8}.items()})
    _log(f"[paged int8] qwen2-1.5b int8 paged + contiguous phase "
         f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp8 = gpt2_fp8_engine_phase()
    counts.update({f"{k}[fp8_e4m3]": fp8[run][k] for run, names in (
        ("contiguous", ("consmax_decode", "consmax_prefill")),
        ("paged", ("consmax_decode_paged", "consmax_prefill_paged")))
        for k in names})
    _log(f"[fp8] gpt2-consmax fp8 phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    perplexity_phase(what="random weights from seed 5")
    _log(f"[ppl] perplexity phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sampling_phase()
    _log(f"[sampling] sampling phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update({f"{k}[gemma2-2b]": n
                   for k, n in gemma2_engine_phase().items()})
    _log(f"[gemma2] gemma2-2b engine phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    session_phase()
    _log(f"[session] ServeSession phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    session_graph_phase(smi)
    _log(f"[session-graph] phase 13b {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    walk_graph_phase(smi)
    _log(f"[walk] bounded-walk replays {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    softmax_engine_phase(smi)
    _log(f"[softmax] softmax / softermax phase "
         f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain_engine_phase(smi)
    _log(f"[plain] phase 14b {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t15 = t0 = time.perf_counter()
    model, cfg, corpus = train_gpt2_phase(smi)
    card_vs_cpu_phase(smi)
    _log(f"[train] 15a {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resume_phase()
    _log(f"[train] 15b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_qwen2_phase(smi)
    _log(f"[train] 15c {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained_serving_phase(model, cfg, corpus)
    _log(f"[train] 15d {time.perf_counter() - t0:.1f} s")
    _log(f"[train] phase 15 {time.perf_counter() - t15:.1f} s")

    t16 = t0 = time.perf_counter()
    moe_rows = moe_kernel_phase()
    rows.update(moe_rows)
    for name, row in moe_rows.items():
        _log(f"[moe] {name}: {row['ms'] * 1e3:.1f} us (plain "
             f"{row['plain_ms'] * 1e3:.1f} us), bound "
             f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']} (share "
             f"{row['bound_ms'] / row['ms']:.3f}); on {smi}")
    torch.cuda.empty_cache()
    counts.update({f"{k}[phi3.5-moe]": n
                   for k, n in moe_engine_phase(smi).items()})
    _log(f"[moe] 16a {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_train_phase(smi)
    _log(f"[moe-train] 16b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xlstm_phase(smi)
    _log(f"[xlstm] 16c {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    musicgen_phase(smi)
    _log(f"[musicgen] 16d {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    smoke_archs_phase()
    _log(f"[smoke] 16e {time.perf_counter() - t0:.1f} s")
    _log(f"[moe] phase 16 {time.perf_counter() - t16:.1f} s")

    torch.cuda.empty_cache()
    mesh_phase(smi)

    torch.cuda.empty_cache()
    t18 = t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    new_rows, dk96_counts = dk96_kernel_phase(flush)
    _log(f"[dk96] 18a kernels at head_dim 96 {time.perf_counter() - t0:.1f} "
         "s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32_rows, f32_counts = fp32_kernel_phase(flush, f32_ptxas, smi)
    new_rows.update(f32_rows)
    _log(f"[fp32] 18b fp32 kernels {time.perf_counter() - t0:.1f} s")
    del flush
    torch.cuda.empty_cache()
    rows.update(new_rows)
    counts.update({**dk96_counts, **f32_counts})
    for name, row in new_rows.items():
        lib = row.get("library_ms")
        _log(f"[kernels] {name}: {row['ms'] * 1e3:.1f} us (plain "
             f"{row['plain_ms'] * 1e3:.1f} us), bound "
             f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']} (share "
             f"{row['bound_ms'] / row['ms']:.3f})"
             + (f", scaled_dot_product_attention {lib * 1e3:.1f} us"
                if lib else "") + f"; on {smi}")
    t0 = time.perf_counter()
    counts.update(phi3v_engine_phase(smi))
    _log(f"[phi-3-vision] 18c {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    analysis_phase()
    _log(f"[analysis] 18d {time.perf_counter() - t0:.1f} s")
    _log(f"[done] phase 18 {time.perf_counter() - t18:.1f} s")
    torch.cuda.empty_cache()
    import tempfile
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    dryrun_phase(smi, Path(tempfile.mkdtemp(prefix="dryrun-", dir=build_dir)))

    dec = "src/repro_torch/kernels/consmax_decode/csrc/consmax_decode.cu"
    pre = "src/repro_torch/kernels/consmax_prefill/csrc/consmax_prefill.cu"
    ref_dec = "src/repro/kernels/consmax_decode/kernel.py"
    ref_pre = "src/repro/kernels/consmax_prefill/kernel.py"
    port, ref = ("src/repro_torch/kernels/{0}/csrc/{0}.cu",
                 "src/repro/kernels/{0}/kernel.py:{1}")
    src = {"consmax_decode": (dec, f"{ref_dec}:171"),
           "consmax_prefill": (pre, f"{ref_pre}:128"),
           "consmax_decode_paged": (dec, f"{ref_dec}:340"),
           "consmax_prefill_paged": (pre, f"{ref_pre}:276"),
           "consmax_attention": (port.format("consmax_attn"),
                                 ref.format("consmax_attn", 78)),
           "softmax_attention": (port.format("softmax_attn"),
                                 ref.format("softmax_attn", 75)),
           "consmax_lut": (port.format("consmax_lut"),
                           ref.format("consmax_lut", 47))}
    for name in ("consmax_decode", "consmax_prefill", "consmax_decode_paged",
                 "consmax_prefill_paged"):
        # the same kernels: on K/V codes, or at gemma2's / phi3.5-moe's /
        # phi-3-vision's (head_dim 96) shapes
        for dt in (*QDTYPES, "gemma2-2b", "phi3.5-moe", "phi-3-vision"):
            src[f"{name}[{dt}]"] = src[name]
    for name in ("consmax_attention", "softmax_attention"):
        # head_dim 96 on the mainloop; fp32 operands on the 3xTF32 kernel
        src[f"{name}[dk96]"] = src[name]
        src[f"{name}[fp32]"] = ("src/repro_torch/kernels/csrc/attn_f32.cuh",
                                src[name][1])
    counts.update(paper_counts)
    kernels = [dict(name=name, route="cuda", source=src[name][0],
                    replaces=src[name][1], launches=counts[name],
                    **{"library_ms": None, **rows[name]}) for name in src]
    _log(f"[done] {time.perf_counter() - t_start:.1f} s")
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-resume"]:
        resume_child()
    elif sys.argv[1:] == ["--train-moe"]:
        moe_train_child()
    elif sys.argv[1:2] == ["--mesh-rank"]:
        mesh_child(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--dryrun-host"]:
        dryrun_host_child(*sys.argv[2:7])
    elif sys.argv[1:2] == ["--dryrun-meshfake"]:
        dryrun_meshfake_child(sys.argv[2])
    elif sys.argv[1:2] == ["--dryrun-real"]:
        dryrun_real_child(sys.argv[2])
    elif sys.argv[1:2] == ["--dry-rank"]:
        dry_rank_child(sys.argv[2], int(sys.argv[3]))
    else:
        main()
