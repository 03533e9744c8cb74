"""The port's GPipe demo (``distributed/pipeline.gpipe``) on 4 gloo ranks:
S 4 stages of ``tanh(x @ w_s)``, M 6 microbatches of (2, 16), inputs from a
numpy seed.

* Every rank's output is within 1e-5 (the reference's bound) of the
  sequential forward, and of the reference's ``gpipe`` on the same inputs
  (a subprocess with 8 host devices, the reference test's mesh).
* Each rank logs M + S - 1 = 9 permutes and one all-reduce, each the size
  of one microbatch (the all-reduce: all of them).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402

S, M, B, D = 4, 6, 2, 16

REF = r"""
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import json, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
import numpy as np
from repro.distributed.pipeline import gpipe
args = json.loads(sys.argv[1])
ws = jnp.asarray(np.array(args["ws"], np.float32))
xs = jnp.asarray(np.array(args["xs"], np.float32))
mesh = jax.make_mesh((4,), ("stage",))
with jax.set_mesh(mesh):
    out = jax.jit(lambda ws, xs: gpipe(lambda w, x: jnp.tanh(x @ w), ws, xs,
                                       mesh=mesh))(ws, xs)
print(json.dumps({"out": np.asarray(out).tolist()}))
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) / D ** 0.5).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return ws, xs


def _sequential(ws, xs):
    out = xs
    for s in range(S):
        out = np.tanh(out @ ws[s])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws, xs = _inputs()
    args = dict(ws=ws.tolist(), xs=xs.tolist())
    # one thread each: the suite's workers share the machine's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, json.dumps(args)],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = W.spawn("pipe", S, args, tmp_path_factory.mktemp("pipe"))
        out, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return ranks, np.array(json.loads(out.strip().splitlines()[-1])["out"])


def test_gpipe_equals_sequential(runs):
    ws, xs = _inputs()
    want = _sequential(ws, xs)
    for res in runs[0]:
        assert np.abs(np.array(res["out"]) - want).max() < 1e-5


def test_gpipe_equals_reference_gpipe(runs):
    ranks, ref = runs
    assert ref.shape == (M, B, D)
    for res in ranks:
        assert np.abs(np.array(res["out"]) - ref).max() < 1e-5


def test_gpipe_collectives(runs):
    for res in runs[0]:
        kinds = [c["kind"] for c in res["calls"]]
        assert kinds == ["collective_permute"] * (M + S - 1) + ["all_reduce"]
        assert all(c["bytes"] == B * D * 4 for c in res["calls"][:-1])
        assert res["calls"][-1]["bytes"] == M * B * D * 4
