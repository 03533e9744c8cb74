"""Trainer loop — the reference's ``train/trainer.py``: periodic
asynchronous checkpoints, save-and-exit on SIGTERM, resume from the latest
checkpoint with deterministic data, a straggler monitor, and data-parallel
training on a mesh.

Data is a pure function of (seed, step, shard), so a resumed run sees the
batches an uninterrupted one would, and checkpoints hold no data state.
Checkpoints hold the reference's state tree, so the reference's trainer
resumes from the port's and the reverse.

``mesh``: a ``("data",)`` DeviceMesh (``launch/mesh.train_mesh``), one
process per rank. Every rank builds the same starting model (the same
seed) and takes its rows of the global batch of the step (the reference's
trainer feeds that same global batch to its sharded ``jit``), so the
global batch does not depend on the world size: a restart on another
number of ranks sees the same batches. ``TrainConfig.fsdp`` shards the
parameters and optimizer state with FSDP2 or keeps them replicated
(``train/step.py``); the logged metrics are the global means. Checkpoints
are gathered whole and written by rank 0, and restore on any world size.
"""
from __future__ import annotations

import signal
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.transformer import LM
from repro_torch.train import step as S


class StragglerMonitor:
    def __init__(self, factor: float = 2.5, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []
        self.flagged = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = float(np.median(self.times[-50:]))
        slow = dt > self.factor * med
        self.flagged += int(slow)
        return slow


class Trainer:
    """``model``: a starting ``LM`` (trained in place, on its own device);
    by default one is drawn from a generator seeded with ``tcfg.seed`` on
    ``device`` (default cuda)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 mesh=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 200, log_every: int = 10,
                 seed: Optional[int] = None, device=None,
                 model: Optional[LM] = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.rank, self.ranks = 0, 1
        if mesh is not None:
            comm = S.data_comm(mesh)
            self.rank, self.ranks = comm.rank, comm.size
            if tcfg.global_batch % self.ranks:
                raise ValueError(f"global_batch {tcfg.global_batch} over "
                                 f"{self.ranks} data ranks")
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []
        self._preempted = False

        self.corpus = SyntheticCorpus(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch,
            seed=tcfg.seed if seed is None else seed))
        if model is not None and device is not None and (
                model.device != resolve_device(device)):
            raise ValueError(f"model on {model.device}, device {device}")
        self.device = model.device if model is not None else (
            resolve_device(device))
        init_state, self._train_step = S.make_train_fns(
            cfg, tcfg, device=self.device, mesh=mesh)
        self.state = init_state(model)

        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        if self.ckpt is not None:
            last = self.ckpt.latest_step()
            if last is not None:
                S.load_state_tree(self.state, self.ckpt.restore(last), cfg)
                print(f"[trainer] resumed from step {last}")

    # --------------------------------------------------------------- run ----
    def _install_preemption_hook(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def step_index(self) -> int:
        return int(self.state["step"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, step: int) -> dict:
        """This rank's rows of the step's global batch, on the device."""
        rows = self.tcfg.global_batch // self.ranks
        lo = self.rank * rows
        return {k: torch.from_numpy(v[lo:lo + rows]).to(self.device)
                for k, v in self.corpus.global_batch_arrays(step).items()}

    def _save(self, step: int, blocking: bool):
        tree = S.state_tree(self.state, self.cfg)     # every rank gathers
        if self.rank == 0:
            self.ckpt.save(tree, step, blocking=blocking)

    def run(self, num_steps: int):
        self._install_preemption_hook()
        start = self.step_index()
        for step in range(start, start + num_steps):
            batch = self._batch(step)
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics = self._train_step(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            metrics = {k: float(v) for k, v in metrics.items()}
            slow = self.monitor.record(dt)
            metrics.update(step=step, sec=dt)
            self.history.append(metrics)
            if (step % self.log_every == 0 or slow) and self.rank == 0:
                flag = " [straggler]" if slow else ""
                print(f"[trainer] step={step} loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e} gnorm={metrics['grad_norm']:.2f} "
                      f"{dt*1e3:.0f}ms{flag}")
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                self._save(step + 1, blocking=False)
            if self._preempted:
                print("[trainer] preemption signal — saving and exiting")
                if self.ckpt:
                    self._save(step + 1, blocking=True)
                break
        if self.ckpt:
            self.ckpt.wait()
        return self.history
