"""Training launcher CLI of the port, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

The reference's flags (``launch/train.py``) but ``--distributed`` (mesh
training is not ported yet), plus ``--device``. ``gpt2-consmax`` trains
at the paper's width unless ``--smoke``; every other arch trains its smoke
config. Weights come from ``TrainConfig.seed`` (0),
batches from the synthetic corpus.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-consmax")
    ap.add_argument("--score-norm", default="consmax")
    ap.add_argument("--smoke", action="store_true", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain CPU path)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    smoke = True if args.smoke is None and args.arch != "gpt2-consmax" \
        else bool(args.smoke)
    cfg = get_config(args.arch, smoke=smoke, score_norm=args.score_norm)
    tcfg = TrainConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                       lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps, remat=args.remat,
                       microbatch=args.microbatch,
                       grad_compression=args.grad_compression)
    trainer = Trainer(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=10,
                      device=device)
    hist = trainer.run(args.steps)
    print(f"[train] done on {device}: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} | stragglers flagged: "
          f"{trainer.monitor.flagged}")
    return hist


if __name__ == "__main__":
    main()
