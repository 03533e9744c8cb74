"""Quickstart: build a ConSmax LM, train briefly, generate text — the
port's public API in one page, the counterpart of the reference's
``examples/quickstart.py`` (its config, sizes and steps). Runs on the CUDA
card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ServeSession
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a model config: the paper's GPT-2-style benchmark, shrunk for CPU.
    cfg = get_config("gpt2-consmax", vocab_size=512, n_layers=2, d_model=128,
                     n_heads=4, n_kv_heads=4, d_ff=512)
    print(f"arch={cfg.arch_id} score_norm={cfg.score_norm} "
          f"(beta~U[{cfg.consmax.beta_init_lo},{cfg.consmax.beta_init_hi}], "
          f"gamma={cfg.consmax.gamma_init})")

    # 2. train on the synthetic corpus (deterministic, resumable).
    tcfg = TrainConfig(global_batch=8, seq_len=64, lr=1e-3, warmup_steps=5,
                       total_steps=60, remat="none")
    trainer = Trainer(cfg, tcfg, log_every=20, device=args.device)
    history = trainer.run(60)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first, "training did not lower the loss"

    # 3. inspect the learned normalizer (paper Fig. 7: beta moves, gamma
    # doesn't).
    model = trainer.state["params"]
    sn = model.blocks[0]["b0"].attn.score_norm
    print("beta per head:", [round(v, 3) for v in sn.beta.tolist()])
    print("gamma per head:", [round(v, 2) for v in sn.gamma.tolist()])

    # 4. serve: batched greedy generation with the merged constant
    # C = e^-beta / gamma.
    model.requires_grad_(False)
    sess = ServeSession(cfg, ServeConfig(max_seq=128), model,
                        device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                            device=model.device, dtype=torch.int32)
    out = sess.generate(prompts, steps=8)
    print("generated:", out.tolist())
    assert tuple(out.shape) == (4, 8)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    return history, out


if __name__ == "__main__":
    main()
