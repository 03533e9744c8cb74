"""GPipe-style pipeline parallelism (an opt-in demo) — the reference's
``distributed/pipeline.py``, over ``torch.distributed``.

Stage s (rank s of ``comm``'s group) holds layers [s·L/S, (s+1)·L/S);
microbatches stream through with one ``Comm.permute`` hop per tick;
microbatch m enters stage 0 at tick m and leaves stage S-1 at tick
m + S - 1, so the run takes M + S - 1 ticks, and the bubble is the
standard (S-1)/(S-1+M) fraction. As in the reference every stage runs
``stage_fn`` on every tick (on zeros before its first microbatch
arrives), and one all-reduce at the end broadcasts the last stage's
outputs (summed against zeros) to every stage.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.comm import Comm


def gpipe(stage_fn, params_stage, microbatches: torch.Tensor, *,
          comm: Comm) -> torch.Tensor:
    """``params_stage``: this rank's stage; microbatches: (M, b, ...),
    the same on every rank (stage 0 reads them). Returns (M, b, ...) =
    stage_{S-1}(... stage_0(x) ...) on every rank."""
    n_stage, idx = comm.size, comm.rank
    n_micro = microbatches.shape[0]
    perm = [(i, (i + 1) % n_stage) for i in range(n_stage)]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stage - 1):
        # stage 0 ingests microbatch t (if any), the others take the hop
        x_in = microbatches[t] if idx == 0 and t < n_micro else buf
        y = stage_fn(params_stage, x_in)
        # the last stage records its finished microbatch m = t - (S-1)
        m = t - (n_stage - 1)
        if idx == n_stage - 1 and m >= 0:
            outs[m] = y
        buf = comm.permute(y, perm)
    # broadcast the last stage's outputs to all stages (sum of one-hot)
    return comm.all_reduce(outs if idx == n_stage - 1
                           else torch.zeros_like(outs))
