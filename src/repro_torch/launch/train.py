"""Training launcher CLI of the port, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --steps 20 --distributed --dist-backend gloo

The reference's flags (``launch/train.py``), plus ``--device`` and
``--dist-backend``. ``--distributed`` trains data-parallel over every
process of a ``torchrun`` launch (the process group from its environment,
on the backend ``--dist-backend`` names: ``nccl`` for ranks with a card
each, ``gloo`` on the CPU or for ranks sharing one card; a rank on cuda
takes card ``LOCAL_RANK`` modulo the cards there are), with FSDP2
sharding (``TrainConfig.fsdp``); rank 0 logs. ``gpt2-consmax`` trains at
the paper's width unless ``--smoke``; every other arch trains its smoke
config. Weights come from ``TrainConfig.seed`` (0), batches from the
synthetic corpus.
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
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel over the ranks of a torchrun launch")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="process-group backend (required with "
                         "--distributed)")
    args = ap.parse_args(argv)
    if args.distributed and not args.dist_backend:
        raise SystemExit("--distributed needs an explicit --dist-backend")

    from repro_torch import resolve_device
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    mesh = None
    if args.distributed:
        import os

        import torch

        from repro_torch.launch.mesh import init_distributed, train_mesh
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        init_distributed(args.dist_backend, device=device)
        mesh = train_mesh(device=device)
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
                      device=device, mesh=mesh)
    hist = trainer.run(args.steps)
    if trainer.rank == 0:
        where = f"{device} x {trainer.ranks} ranks" if mesh else f"{device}"
        print(f"[train] done on {where}: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f} | stragglers flagged: "
              f"{trainer.monitor.flagged}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
