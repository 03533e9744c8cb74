"""``nn/scan.scan``, the recurrence walk of the port's xLSTM cells, and the
dry run's counting of repeated work, on the CPU.

* The sLSTM through ``scan`` gives the bits of a plain step loop (one
  ``_slstm_step`` per token, the outputs stacked), forward and every
  gradient, under both stabilizers, for a sequence that is a chunk
  multiple and one with a short last chunk. Its parity with the
  reference's ``slstm_apply`` (whole sequences, a padded last chunk,
  prefill then decode) is ``tests/test_torch_ssm.py``'s.
* Under the dry run's counting modes on fake tensors, ``scan`` traces the
  repeated steps once and counts them with their trip count, and the
  training step the repeated microbatches: for xLSTM smoke cells (prefill
  through an mLSTM and an sLSTM block, train through an sLSTM block; s 64
  and 96) on a fake (2, 4) mesh, and gpt2's over four microbatches, the
  counted trace's FLOPs, bytes, transcendentals and collective bytes by
  kind equal those of the trace that walks every step and microbatch
  (``scan.walked``),
  and its peak memory is within 1 % of the walk's. One subprocess, a
  120 s limit.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import XLSTMConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import xlstm as XL
from repro_torch.nn import layers as L

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402


def _step_loop(p, x, cfg):
    """The sLSTM as one ``_slstm_step`` per token, outputs stacked."""
    b, s, d = x.shape
    cdt = cfg.cdtype()
    mu = p.mu if cfg.xlstm.stabilizer == "consmax" else None
    gx = (x.to(cdt) @ L.cast(p.w, cdt).reshape(d, 4 * d)).unflatten(
        -1, (4, d)).float() + p.b
    zero = torch.zeros((b, d))
    carry, hs = (zero,) * 4, []
    for t in range(s):
        carry = XL._slstm_step(carry, gx[:, t], p.r.float(), mu)
        hs.append(carry[0])
    y = XL._head_rms(torch.stack(hs, 1).unflatten(-1, (cfg.n_heads, -1)),
                     p.out_scale)
    return y.flatten(-2).to(cdt)


@pytest.mark.parametrize("stabilizer", ["max", "consmax"])
@pytest.mark.parametrize("s", [37, 64])
def test_slstm_scan_equals_the_step_loop(stabilizer, s):
    cfg = get_config("xlstm-1.3b", smoke=True, compute_dtype="float32",
                     xlstm=XLSTMConfig(chunk=16, stabilizer=stabilizer))
    p = XL.SLSTM(cfg)
    gen = torch.Generator().manual_seed(s)
    p.reset_parameters(gen)
    if stabilizer == "consmax":
        with torch.no_grad():
            p.mu.uniform_(0.5, 1.5, generator=gen)
    params = list(p.parameters())
    for q in params:
        q.requires_grad_(True)
    x = torch.randn((2, s, cfg.d_model), generator=gen, requires_grad=True)
    w = torch.randn((2, s, cfg.d_model), generator=gen)
    runs = []
    for fn in (lambda: _step_loop(p, x, cfg),
               lambda: XL.slstm_apply(p, x, cfg)[0]):
        y = fn()
        grads = torch.autograd.grad((y * w).sum(), [x, *params])
        runs.append([y.detach(), *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# prefill: an mLSTM and an sLSTM block; train: the sLSTM block alone (the
# walk of a train step is the slow trace)
BLOCKS = {"prefill_32k": ["mlstm", "slstm"], "train_4k": ["slstm"]}
SLSTM_CELLS = [
    dict(name=f"xlstm-{shape}-{seq}", arch="xlstm-1.3b", shape=shape,
         seq=seq, batch=8, mesh=[2, 4], microbatch=1,
         overrides=dict(n_layers=len(BLOCKS[shape]),
                        block_pattern=BLOCKS[shape]))
    for shape in ("prefill_32k", "train_4k") for seq in (64, 96)]
COUNT_CELLS = SLSTM_CELLS + [
    dict(name="gpt2-train-4-microbatches", arch="gpt2-consmax",
         shape="train_4k", seq=32, batch=8, mesh=[2, 4], microbatch=4)]


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    return W.spawn("count", 1, dict(cells=COUNT_CELLS),
                   tmp_path_factory.mktemp("count"))[0]


@pytest.mark.parametrize("name", [c["name"] for c in COUNT_CELLS])
def test_counted_trace_equals_the_walk(counts, name):
    walk, count = counts[name]["walk"], counts[name]["count"]
    assert walk["cost"]["flops"] > 0 and walk["collectives"]
    assert count["cost"] == walk["cost"]
    assert count["collectives"] == walk["collectives"]
    assert abs(count["peak"] - walk["peak"]) <= 0.01 * walk["peak"]
