"""The paper's experiment on the port: a GPT-2-style LM trained with
ConSmax and with Softmax from the same seed, with periodic checkpoints and
a side-by-side summary — the counterpart of the reference's
``examples/train_gpt2_consmax.py``.

Defaults are CPU-sized (4 L, d 128, vocab 1024, seq 128); ``--paper`` uses
the paper's 6 L / 6 H / d 384 / seq 256. Runs on the CUDA card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_gpt2_consmax --paper
    PYTHONPATH=src python -m repro_torch.examples.train_gpt2_consmax \
        --device cpu --steps 100
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer


def train_one(score_norm: str, args) -> list:
    if args.paper:
        cfg = get_config("gpt2-consmax", score_norm=score_norm)
        seq = 256
    else:
        cfg = get_config("gpt2-consmax", score_norm=score_norm,
                         vocab_size=1024, n_layers=4, d_model=128,
                         n_heads=4, n_kv_heads=4, d_ff=512)
        seq = 128
    tcfg = TrainConfig(global_batch=args.batch, seq_len=seq, lr=1e-3,
                       warmup_steps=20, total_steps=args.steps, remat="none")
    ckpt = os.path.join(args.out, f"ckpt-{score_norm}")
    tr = Trainer(cfg, tcfg, ckpt_dir=ckpt, ckpt_every=100, log_every=25,
                 device=args.device)
    hist = tr.run(args.steps)
    return [h["loss"] for h in hist]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--paper", action="store_true",
                    help="exact paper config (6L/6H/384d/seq256)")
    ap.add_argument("--out", default="artifacts/examples-torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    curves = {}
    for norm in ("consmax", "softmax"):
        print(f"=== training {norm} ===")
        curves[norm] = train_one(norm, args)
    with open(os.path.join(args.out, "gpt2_consmax_curves.json"), "w") as f:
        json.dump(curves, f)

    for norm, c in curves.items():
        print(f"{norm:9s} loss {np.mean(c[:5]):.4f} -> {np.mean(c[-5:]):.4f} "
              f"(ppl {np.exp(min(np.mean(c[-5:]), 20)):.1f})")
    gap = (np.mean(curves['consmax'][-5:]) - np.mean(curves['softmax'][-5:]))
    print(f"final consmax-softmax gap: {gap:+.4f} "
          f"({100*gap/np.mean(curves['softmax'][-5:]):+.2f}% — paper: <0.9% "
          f"after 10k iters)")
    return curves


if __name__ == "__main__":
    main()
