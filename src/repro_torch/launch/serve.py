"""Serving launcher CLI of the port: the continuous-batching engine on random
weights, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --requests 12 --max-slots 4 --decode-kernel --prefill-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --paged --page-size 4 --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --kv-dtype int8 \
        --decode-kernel --prefill-kernel

Serves the smoke config of ``--arch`` on random weights (``chip_smoke.py``
serves the published widths). Requests are greedy (sampled streams are not
ported yet).
``--decode-kernel`` / ``--prefill-kernel`` route attention through the
ConSmax CUDA kernels (their plain versions on ``--device cpu``).
``--paged`` serves from a shared page pool with the prefix cache on (a
stats line reports its hits; the CLI's prompts are random, so they rarely
share a prefix). ``--kv-dtype int8`` / ``fp8_e4m3`` stores the KV cache as
codes with one fp32 scale per row and KV head (the stats line reports the
cache's bytes).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--engine", choices=("continuous",),
                    default="continuous",
                    help="only the continuous-batching engine is ported")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
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
    ap.add_argument("--no-fill-bound", action="store_true",
                    help="disable fill-bounded kernel walks (capacity-swept "
                         "baseline)")
    ap.add_argument("--paged", action="store_true",
                    help="shared page-pool KV cache: slots map rows onto "
                         "pool pages instead of owning max_seq rows")
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
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.weights import init_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    paged = dict(paged_kv=True, page_size=args.page_size,
                 num_pages=args.num_pages,
                 prefix_cache=not args.no_prefix_cache,
                 prefix_evict=args.prefix_evict) if args.paged else {}
    scfg = ServeConfig(max_seq=2 * (args.prompt_len + args.steps) + 8,
                       prefill_chunk=args.prefill_chunk,
                       prefill_budget=args.prefill_budget,
                       max_slots=args.max_slots,
                       decode_kernel=args.decode_kernel,
                       prefill_kernel=args.prefill_kernel,
                       fill_bound=not args.no_fill_bound,
                       kv_cache_dtype=args.kv_dtype,
                       score_norm=cfg.score_norm, **paged)
    eng = ContinuousBatchingEngine(cfg, scfg, params, device=device)
    rng = np.random.default_rng(args.seed + 1)
    uids = []
    for _ in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        steps = int(rng.integers(1, args.steps + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        uids.append(eng.submit(prompt, steps))
    t0 = time.perf_counter()
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = sum(len(v) for v in results.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve/continuous] {cfg.arch_id} (smoke) on {where}: "
          f"{len(results)} requests, {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s) with {args.max_slots} slots, "
          f"decode_kernel={args.decode_kernel}, "
          f"prefill_kernel={args.prefill_kernel}, paged={args.paged}, "
          f"kv_dtype={args.kv_dtype}")
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
    if uids:
        print("[serve/continuous] sample:", results[uids[0]])


if __name__ == "__main__":
    main()
