"""On the card: each cell's run is correct, and its control (at every
served position the token the reference puts first on fp8 operands, judged
in the program's place) is not. Each runs the command itself, at the cell's
own size, for a short window. (The port's own fp8 KV cache is no control at
these sizes: the check does not catch it, see the limits files.) Also on
the card: the trace reading leaves the host ranges' mirrors out of the
device's busy time."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SECONDS = "10"


def _run(cell, seed, *extra):
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", SECONDS, "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell, card):
    r = _run(cell, 2**31 + 101)
    assert r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    r = _run(cell, 2**31 + 102, "--control", "fp8-operands")
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_slice_busy_leaves_out_the_host_ranges(card):
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import harness as H
    x = torch.randn(2048, 2048, device=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("perfbench.slice"):
            with record_function("perfbench.step"):
                for _ in range(4):
                    x = (x @ x).tanh()
                torch.cuda.synchronize(card)
            with record_function("perfbench.observe"):
                time.sleep(0.2)
    sl = H.read_slice(prof, "perfbench.slice")
    assert 0 < sl["busy_s"] < 0.5 * sl["seconds"], sl
    assert not any(n.startswith("perfbench.") for n in sl["kernel_s"])
    assert sl["idle_by_host"].get("perfbench.observe", 0) > 0.15
