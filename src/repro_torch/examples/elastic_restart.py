"""Fault tolerance: train, hard-stop mid-run (a simulated preemption),
restart from the checkpoint, and check that the loss trajectory continues
— the data pipeline regenerates step N's batch deterministically, so no
progress or data is lost. The counterpart of the reference's
``examples/elastic_restart.py`` (its config, steps and 5 % check). Runs on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
"""
from __future__ import annotations

import argparse
import shutil

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="artifacts/examples-torch/elastic-ckpt")
    args = ap.parse_args(argv)
    ckpt = args.ckpt
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("gpt2-consmax", vocab_size=512, n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=256)
    tcfg = TrainConfig(global_batch=8, seq_len=64, lr=1e-3, warmup_steps=5,
                       total_steps=120, remat="none")

    # ---- run A: train 60 steps, checkpointing every 20 ----
    tr = Trainer(cfg, tcfg, ckpt_dir=ckpt, ckpt_every=20, log_every=20,
                 device=args.device)
    tr.run(60)
    tr.ckpt.wait()
    print(f"[A] stopped at step {tr.step_index()} "
          f"(checkpoint: {tr.ckpt.latest_step()})")

    # ---- simulated preemption: process dies; a NEW trainer resumes ----
    tr2 = Trainer(cfg, tcfg, ckpt_dir=ckpt, ckpt_every=20, log_every=20,
                  device=args.device)
    assert tr2.step_index() == 60, tr2.step_index()
    hist_b = tr2.run(40)
    print(f"[B] resumed at 60, now at {tr2.step_index()}")

    # ---- reference: uninterrupted run to the same step ----
    shutil.rmtree(ckpt, ignore_errors=True)
    tr3 = Trainer(cfg, tcfg, log_every=10**9, device=args.device)
    hist_c = tr3.run(100)

    resumed = hist_b[-1]["loss"]
    straight = hist_c[-1]["loss"]
    print(f"resumed-run loss @100:      {resumed:.4f}")
    print(f"uninterrupted loss @100:    {straight:.4f}")
    assert abs(resumed - straight) / straight < 0.05, "trajectory diverged"
    print("OK: restart is trajectory-preserving (deterministic data + state)")
    return resumed, straight


if __name__ == "__main__":
    main()
