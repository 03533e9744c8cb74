"""Batched serving: prefill a batch of prompts, stream decode steps with
the merged ConSmax constant — sampling fused into the steps — and report
per-token latency and tokens/sec. The counterpart of the reference's
``examples/serve_batched.py`` (its arch, sizes and sampling). Runs on the
CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --batch 8 \\
        --steps 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ServeSession
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)       # reduced config
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(cfg, gen, device=args.device)
    sess = ServeSession(cfg, ServeConfig(
        max_seq=args.prompt_len + args.steps + 8), params, device=args.device)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=args.device,
                            dtype=torch.int32)

    t0 = time.perf_counter()
    out = sess.generate(prompts, steps=args.steps,
                        sampling=SamplingParams(temperature=0.8, top_k=50,
                                                seed=args.seed))
    if params.device.type == "cuda":
        torch.cuda.synchronize(params.device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.steps
    print(f"arch={args.arch} (smoke) batch={args.batch} "
          f"prompt={args.prompt_len} steps={args.steps}")
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {1e3 * dt / args.steps:.1f} ms/step incl. "
          f"first-call warm-up)")
    print("sample:", out[0].tolist())
    assert tuple(out.shape) == (args.batch, args.steps)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    return out


if __name__ == "__main__":
    main()
