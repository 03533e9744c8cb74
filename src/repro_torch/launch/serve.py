"""Serving launcher CLI of the port, on random weights, on the CUDA card by
default.

    PYTHONPATH=src python -m repro_torch.launch.serve --steps 16 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --requests 12 --max-slots 4 --decode-kernel --prefill-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --temperature 0.8 --top-k 50 --top-p 0.95 --seed 7
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --engine continuous --paged --page-size 4 --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --kv-dtype int8 --decode-kernel --prefill-kernel
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --engine continuous --tp 2 --seq-shards 2 --paged --kv-heads 4 \
        --device cpu --dist-backend gloo

Serves the smoke config of ``--arch`` (``--kv-heads`` overrides its KV
heads) on random weights (``chip_smoke.py`` serves the published widths):
the dense and MoE archs on either engine, the recurrent ones (jamba,
xlstm) on the static engine only, as in the reference; the stub-frontend
archs (phi-3-vision, musicgen) take embeddings and are not served here.
``--engine static`` (the default) runs the lockstep ``ServeSession`` over
``--batch`` prompts; ``--engine continuous`` runs the slot-recycling
``ContinuousBatchingEngine`` over ``--requests`` prompts of random lengths.
The weights come from seed 0 and the prompts from seed 1, whatever the
flags; ``--seed`` is the sampling seed: row / request i draws from
``--seed + i``, so greedy runs (``--temperature 0``, the default) give the
same tokens for every ``--seed``.

Sampling (``--temperature`` / ``--top-k`` / ``--top-p`` / ``--min-p``) runs
fused in the steps; ``--host-sampling`` takes the logits out of each step
and samples after it, with the same streams.
``--decode-kernel`` / ``--prefill-kernel`` route attention through the
ConSmax CUDA kernels (their plain versions on ``--device cpu``); they raise
on a softmax / softermax config. ``--prefill-kv-block`` (default 512) sizes
the prefill kernel's KV shards, on both engines.
``--paged`` (continuous engine) serves from a shared page pool with the
prefix cache on (a stats line reports its hits; the CLI's prompts are
random, so they rarely share a prefix). ``--kv-dtype int8`` / ``fp8_e4m3``
stores the KV cache as codes with one fp32 scale per row and KV head (a
stats line reports the cache's bytes).

On one card both engines replay their steps as CUDA graphs (the static
engine its decode step, the continuous engine its prefill-chunk and decode
steps), whatever the score norm and kernel flags; each report line says
``graphed`` and counts the replays. On the CPU and on a mesh they run
eagerly.

``--tp`` / ``--seq-shards`` (or ``--mesh TPxNS``) serve the continuous
engine on a ``(tp, seq_shards)`` mesh (``distributed/serve_mesh``), one
process per rank under ``torchrun --nproc-per-node tp*seq_shards``, over
the process-group backend ``--dist-backend`` names (required: ``nccl`` for
ranks with a card each, ``gloo`` on the CPU or for ranks that share one
card). A rank on
cuda takes card ``LOCAL_RANK`` modulo the cards there are. Every rank
serves the same requests and samples the same tokens; rank 0 prints the
report, and a line of the collectives per model step.
"""
from __future__ import annotations

import argparse
import time

WEIGHT_SEED, PROMPT_SEED = 0, 1


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments; ``--mesh TPxNS`` sets ``--tp`` and
    ``--seq-shards`` (the reference's shorthand)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="override n_kv_heads (0 = the arch's)")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="rows of the static engine's batch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    # sampling knobs -> per-request SamplingParams
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with the masks below")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest-score tokens (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass cutoff in (0, 1] (1 = disabled)")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min prob relative to the max, [0, 1) "
                         "(0 = disabled)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed; row / request i draws from "
                         "seed + i")
    ap.add_argument("--host-sampling", action="store_true",
                    help="sample on the logits after each step instead of "
                         "in the step's epilogue")
    # continuous-engine knobs
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="append-at-index prefill chunk (ONE shape)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens per engine iteration "
                         "(0 = one chunk)")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="split-KV consmax_decode kernel (consmax archs "
                         "only; errors otherwise)")
    ap.add_argument("--prefill-kernel", action="store_true",
                    help="consmax_prefill kernel for prompt chunks (consmax "
                         "archs only; errors otherwise)")
    ap.add_argument("--prefill-kv-block", type=int, default=512,
                    help="KV shard size of the prefill kernel's grid "
                         "(rounded up to whole 64-row tiles)")
    ap.add_argument("--no-fill-bound", action="store_true",
                    help="disable fill-bounded kernel walks (capacity-swept "
                         "baseline)")
    ap.add_argument("--paged", action="store_true",
                    help="shared page-pool KV cache (continuous engine): "
                         "slots map rows onto pool pages instead of owning "
                         "max_seq rows")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV rows per pool page (must divide "
                         "--prefill-chunk)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool capacity; 0 = max_slots * "
                         "ceil(max_seq / page_size), i.e. no sharing gain")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the prefix-sharing page cache (paged "
                         "engine only)")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8", "fp8_e4m3"),
                    default="bfloat16",
                    help="KV cache storage: bf16, or int8 / fp8_e4m3 codes "
                         "with per-row fp32 scales (quantized at write, "
                         "dequantized per block at read)")
    ap.add_argument("--prefix-evict", choices=("lru", "fifo"), default="lru",
                    help="reclaim order of refcount-0 cached pages when the "
                         "free list runs dry: lru = release order, fifo = "
                         "registration order")
    ap.add_argument("--mesh", default="",
                    help="mesh as TPxNS, e.g. 2x2 = --tp 2 --seq-shards 2 "
                         "(shorthand for --tp / --seq-shards)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: attention heads split "
                         "over the mesh's 'model' axis")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="sequence-sharded ranks: the page pool split over "
                         "the mesh's 'seq' axis (needs --paged)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="process-group backend of a mesh run (required "
                         "when --tp * --seq-shards > 1)")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            args.tp, args.seq_shards = map(int, args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh must be TPxNS, got {args.mesh!r}")
    return args


def main(argv=None):
    args = parse_args(argv)
    mesh = args.tp * args.seq_shards > 1
    if mesh and (args.engine != "continuous" or not args.dist_backend):
        raise SystemExit("--tp / --seq-shards need --engine continuous and "
                         "an explicit --dist-backend, under torchrun "
                         "--nproc-per-node tp*seq_shards")
    if args.paged and args.engine != "continuous":
        raise SystemExit("--paged needs --engine continuous (the static "
                         "session is the contiguous baseline)")

    import dataclasses

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeSession
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.weights import init_params

    device = resolve_device(args.device)
    rank = 0
    if mesh:
        import os

        from repro_torch.launch.mesh import init_distributed
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        init_distributed(args.dist_backend, device=device)
        rank = torch.distributed.get_rank()
    cfg = get_config(args.arch, smoke=True,
                     **({"n_kv_heads": args.kv_heads} if args.kv_heads
                        else {}))
    if cfg.frontend != "tokens":
        raise SystemExit(f"{args.arch}: the stub vlm / audio frontends take "
                         "precomputed embeddings, which this demo does not "
                         "make (chip_smoke.py drives them through lm_apply)")
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    params = init_params(cfg, gen, device=device)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, min_p=args.min_p, seed=args.seed)
    fused = not args.host_sampling
    rng = np.random.default_rng(PROMPT_SEED)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    kernels = dict(decode_kernel=args.decode_kernel,
                   prefill_kernel=args.prefill_kernel,
                   prefill_kv_block=args.prefill_kv_block,
                   fill_bound=not args.no_fill_bound,
                   kv_cache_dtype=args.kv_dtype, fused_sampling=fused,
                   score_norm=cfg.score_norm)

    if args.engine == "static":
        sess = ServeSession(cfg, ServeConfig(
            max_seq=args.prompt_len + args.steps + 8, **kernels), params,
            device=device)
        prompts = torch.tensor(rng.integers(0, cfg.vocab_size,
                                            (args.batch, args.prompt_len)),
                               dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        out = sess.generate(prompts, steps=args.steps, sampling=sp)
        out = out.cpu()
        dt = time.perf_counter() - t0
        n = args.batch * args.steps
        # the session's own mode: an arch without attention samples on the
        # host whatever --host-sampling says
        print(f"[serve] {cfg.arch_id} (smoke) on {where}: {n} tokens in "
              f"{dt:.2f}s ({n / dt:.1f} tok/s), sampling={sp}, "
              f"fused={sess.fused}, graphed={sess.graphed} "
              f"({sess.decode_graphs} decode graphs, {sess.graph_replays} "
              f"graph replays)")
        print("[serve] sample:", out[0].tolist())
        return

    paged = dict(paged_kv=True, page_size=args.page_size,
                 num_pages=args.num_pages,
                 prefix_cache=not args.no_prefix_cache,
                 prefix_evict=args.prefix_evict) if args.paged else {}
    scfg = ServeConfig(max_seq=2 * (args.prompt_len + args.steps) + 8,
                       prefill_chunk=args.prefill_chunk,
                       prefill_budget=args.prefill_budget,
                       max_slots=args.max_slots, tp=args.tp,
                       seq_shards=args.seq_shards, **kernels, **paged)
    eng = ContinuousBatchingEngine(cfg, scfg, params, device=device)
    uids = []
    for i in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        steps = int(rng.integers(1, args.steps + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        # per-request stream: seed + i, reproducible under any scheduling
        uids.append(eng.submit(prompt, steps, sampling=dataclasses.replace(
            sp, seed=(args.seed + i) % 2**32)))
    t0 = time.perf_counter()
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if rank:
        torch.distributed.destroy_process_group()
        return
    n = sum(len(v) for v in results.values())
    print(f"[serve/continuous] {cfg.arch_id} (smoke) on {where}: "
          f"{len(results)} requests, {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s) with {args.max_slots} slots, "
          f"decode_kernel={args.decode_kernel}, "
          f"prefill_kernel={args.prefill_kernel}, paged={args.paged}, "
          f"kv_dtype={args.kv_dtype}, fused_sampling={fused}, "
          f"graphed={eng.graphed} ({eng.graph_replays} graph replays)")
    if args.temperature > 0:
        print(f"[serve/continuous] sampling: temperature={args.temperature} "
              f"top_k={args.top_k} top_p={args.top_p} min_p={args.min_p} "
              f"seeds={args.seed}..{args.seed + args.requests - 1}")
    kv_bytes = sum(t.numel() * t.element_size() for sup in eng.caches
                   for blk in sup.values() for key, t in blk["attn"].items()
                   if key != "index")
    print(f"[serve/continuous] KV cache: {kv_bytes / 2**20:.3f} MiB "
          f"({args.kv_dtype})")
    if args.paged:
        print(f"[serve/continuous] page pool: {scfg.num_pages} pages x "
              f"{scfg.page_size} rows (peak in use {eng.pool.peak_in_use}) "
              f"vs {args.max_slots} x {scfg.max_seq} contiguous rows")
        if scfg.prefix_cache:
            print(f"[serve/continuous] prefix cache ({scfg.prefix_evict}): "
                  f"{eng.pool.prefix_hit_rows} prompt rows served from "
                  f"cached pages, {eng.pool.cow_copies} cow copies, "
                  f"{eng.pool.evictions} evictions")
    if mesh:
        per = {k: (c["calls"] / eng.model_steps, c["bytes"] / eng.model_steps)
               for k, c in eng.collectives.items() if c["calls"]}
        print(f"[serve/continuous] mesh tp={args.tp} x seq_shards="
              f"{args.seq_shards} over {args.dist_backend}: per model step "
              + ", ".join(f"{k} {c:.1f} calls / {b:.0f} bytes"
                          for k, (c, b) in per.items()))
    if uids:
        print("[serve/continuous] sample:", results[uids[0]])
    if mesh:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
