"""Process groups and device meshes — the counterpart of the reference's
``launch/mesh.py``. Functions, never module-level state, so importing this
module touches no device and no process group.

* ``init_distributed``: the default process group, with an explicit
  backend (``nccl`` for ranks on cards of their own, ``gloo`` on the CPU
  and for ranks that share one card); rank and world size from the
  arguments or from ``torchrun``'s environment;
* ``serve_mesh`` / ``train_mesh``: the serving ``("model", "seq")`` and
  the training ``("data",)`` DeviceMesh over that group;
* ``host_mesh``: a degenerate one-rank training mesh for smoke use;
* ``run_ranks``: start one process per rank, wait for all of them within
  a time limit, kill the rest when one fails or the limit passes, and
  raise unless every rank exited 0;
* ``make_production_mesh`` / ``make_host_mesh``: the dry run's meshes
  (``launch/dryrun.py``): the reference's ``(16, 16)`` ("data", "model")
  single pod or ``(2, 16, 16)`` ("pod", "data", "model") pair of pods, and
  a ``(1, 1)`` host mesh, each over a fake process group of that many
  ranks in this one process (this process is rank 0; its collectives
  move nothing, and no device is touched). The fake group becomes the
  process's default group, so a process that runs these runs no real
  collectives;
* the H100 constants of the dry run's roofline, in place of the
  reference's TPU v5e ones: ``PEAK_FLOPS`` (bf16 dense, H100 SXM data
  sheet, the figure ``chip_smoke.py``'s bounds use), ``HBM_BW`` (HBM3, the
  same sheet), ``LINK_BW`` (NVLink 4: 18 links x 25 GB/s per direction)
  and ``HBM_PER_CHIP``. As in the reference, one ring bandwidth costs
  every collective; a group that crosses the 8-card NVLink domain (the
  16-wide ``model`` axis) runs partly over the slower inter-node network,
  which this single rate understates.
"""
from __future__ import annotations

import math
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_distributed(backend: str, *, rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None, device=None):
    """Initialize the default process group on ``backend`` and make
    ``device`` (a CUDA device, or None) this process's current card.
    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` (set by
    ``torchrun``), ``init_method`` to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); tests pass ``file://<path>``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)


def _device_type(device) -> str:
    return "cpu" if device is None else torch.device(device).type


def serve_mesh(tp: int, seq_shards: int, *, device=None):
    """The ``(tp, seq_shards)`` serving mesh named ("model", "seq") over the
    default process group; ``device`` names the mesh's device type (None:
    the CPU)."""
    return init_device_mesh(_device_type(device), (tp, seq_shards),
                            mesh_dim_names=("model", "seq"))


def train_mesh(n: int | None = None, *, device=None):
    """The data-parallel training mesh named ("data",) over ``n`` ranks
    (default: the whole world)."""
    n = dist.get_world_size() if n is None else n
    return init_device_mesh(_device_type(device), (n,),
                            mesh_dim_names=("data",))


def host_mesh():
    """A one-rank ("data",) mesh on the CPU for smoke use: initializes a
    one-process gloo group over an in-memory store when none exists."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return train_mesh(1)


def run_ranks(argvs: list, *, timeout: float, env: dict | None = None,
              cwd=None) -> list:
    """Run ``argvs[r]`` as rank r's process, all at once; returns their
    stdout texts. Raises RuntimeError (with every rank's stderr tail),
    after killing every process still running, when a rank exits non-zero
    or the ranks are not all done within ``timeout`` seconds. Output goes
    through temporary files, so a chatty rank cannot block on a full
    pipe."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in argvs]
    procs = [subprocess.Popen(a, stdout=o, stderr=e, text=True, env=env,
                              cwd=cwd) for a, (o, e) in zip(argvs, files)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"ranks not all done within {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for o, e in files:
        o.seek(0)
        e.seek(0)
        texts.append((o.read(), e.read()))
        o.close()
        e.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        tails = "\n".join(f"rank {r} (exit {p.returncode}): "
                          f"{texts[r][1][-3000:]}"
                          for r, p in enumerate(procs))
        raise RuntimeError(f"{failed or f'rank {bad[0]} failed'}\n{tails}")
    return [t[0] for t in texts]


PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card (H100 SXM)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
LINK_BW = 450e9              # bytes/s per card and direction (NVLink 4)
HBM_PER_CHIP = 80e9          # bytes of device memory per card


def _fake_world(n: int):
    """Make a fake process group of ``n`` ranks (this process rank 0) the
    default group, replacing an earlier fake group of another size; a real
    default group is left alone and refused."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry-run mesh needs the process to itself: "
                               "a real process group is initialized")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake_mesh(shape: tuple, names: tuple, device):
    _fake_world(math.prod(shape))
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 256 cards (16, 16) data x model. Multi-pod: 2 pods x
    256 = 512 cards (2, 16, 16) pod x data x model. Over a fake process
    group; ``device`` is the mesh's device type (its tensors are fake)."""
    if multi_pod:
        return _fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _fake_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device="cuda"):
    """The degenerate one-card (1, 1) data x model mesh."""
    return _fake_mesh((1, 1), ("data", "model"), device)
