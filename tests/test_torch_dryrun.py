"""The port's dry run (``launch/specs``, ``launch/dryrun``) against the
reference's, and its fake trace against real ranks.

* The reference's smoke cell (``tests/test_dryrun_smoke.py``: granite
  smoke, d 128, 4 heads, vocab 512, train, batch 8, seq 32, microbatch 2)
  on a fake (2, 4) mesh: FLOPs, bytes and collective bytes > 0, and at
  least one all-gather, all-reduce or reduce-scatter.
* ``meta`` (``n_params``, ``n_active_params``, ``model_flops``,
  ``useful_bytes_per_device``, ``state_bytes_per_device_actual``) and the
  fallback count equal the reference's ``make_cell`` for every arch of
  ``ARCH_IDS`` x {train_4k, prefill_32k, decode_32k} on (2, 4) and
  (2, 2, 2) meshes; ``cell_supported`` gives the same verdicts, every
  ``long_500k`` skip included. The reference runs in a subprocess with 8
  host devices (its ``make_cell`` compiles nothing).
* Matmul FLOPs: the port's count for gpt2-consmax smoke decode_32k and
  prefill_32k on one device equals the summed ``dot_flops_by_comp`` of the
  reference's ``hlo_cost`` on its compiled step, within 1 % (they are
  equal). The reference's step is compiled without the cell's shardings:
  its prefill cell does not lower on the installed jax
  (``ShardingTypeError`` at the cache's dynamic_update_slice), and on one
  device the shardings change no op.
* Fake against real: the gpt2 smoke decode cell (batch 8, seq 64, fp32) on
  a (2, 2) mesh. Each of 4 gloo ranks runs it on real shards; its
  collective records (kind, shape, dtype, group size, bytes, in order)
  equal the dry run's over a fake group, and its logits equal one
  device's within 1e-5.
Every subprocess and world has a 120 s limit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = [[2, 4], [2, 2, 2]]
FLOP_SHAPES = ["decode_32k", "prefill_32k"]

REF = r"""
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false")
import dataclasses, json, sys
sys.path.insert(0, "src")
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import ARCH_IDS, get_config
from repro.distributed.hlo_cost import hlo_cost
from repro.launch.specs import cell_supported, make_cell
from repro.serve import engine as SE
args = json.loads(sys.argv[1])
keys = ("n_params", "n_active_params", "model_flops",
        "useful_bytes_per_device", "state_bytes_per_device_actual")
names = {2: ("data", "model"), 3: ("pod", "data", "model")}
meta = {}
for shape in args["meshes"]:
    mesh = jax.make_mesh(tuple(shape), names[len(shape)])
    for arch in ARCH_IDS:
        for sh in args["shapes"]:
            cell = make_cell(arch, sh, mesh)
            meta[f"{arch}|{sh}|{shape}"] = dict(
                {k: cell.meta[k] for k in keys},
                fallbacks=len(cell.fallbacks))
supported = {f"{a}|{s}": list(cell_supported(a, s))
             for a in ARCH_IDS for s in SHAPES}
full = get_config("gpt2-consmax")
smoke = get_config("gpt2-consmax", smoke=True)
over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
        if getattr(smoke, f.name) != getattr(full, f.name)}
host = jax.make_mesh((1, 1), ("data", "model"))
flops = {}
for sh in args["flop_shapes"]:
    cell = make_cell("gpt2-consmax", sh, host, overrides=over)
    step, scfg = SE.make_decode_for_dryrun(cell.cfg, cell.meta["seq_len"])
    if cell.meta["kind"] == "prefill":
        _, step, _, _ = SE.make_serve_fns(cell.cfg, scfg)
    hlo = jax.jit(step).lower(*cell.args).compile().as_text()
    flops[sh] = sum(hlo_cost(hlo).dot_flops_by_comp.values())
print(json.dumps(dict(meta=meta, supported=supported, flops=flops)))
"""


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The reference's numbers (a subprocess, 8 host devices) and the
    port's (a subprocess over fake groups), computed side by side."""
    root = Path(__file__).resolve().parents[1]
    args = dict(meshes=MESHES, shapes=SHAPES, flop_shapes=FLOP_SHAPES)
    # one thread each: the suite's workers share the machine's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF, json.dumps(args)],
                           cwd=root, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = W.spawn("report", 8, args, tmp_path_factory.mktemp("report"))
        out, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), port[0]


def test_smoke_cell_roofline(reports):
    rec = reports[1]["smoke"]
    assert rec["cost"]["flops"] > 0
    assert rec["cost"]["bytes"] > 0
    # FSDP + TP must produce collectives (all-gathers of params at least)
    assert rec["collectives"]["total_bytes"] > 0, rec["collectives"]
    assert any(k in rec["collectives"]["count_by_kind"]
               for k in ("all-gather", "all-reduce", "reduce-scatter"))
    r = rec["roofline"]
    assert r["bound_sec"] == max(r["compute_sec"], r["memory_sec"],
                                 r["collective_sec"]) > 0
    assert rec["hbm"]["peak_bytes_per_device"] > rec["memory"][
        "argument_bytes"] > 0


@pytest.mark.parametrize("mesh", [str(m) for m in MESHES])
@pytest.mark.parametrize("shape", SHAPES)
def test_meta_equals_reference(reports, shape, mesh):
    ref, port = reports[0]["meta"], reports[1]["meta"]
    keys = [k for k in ref if k.split("|")[1] == shape
            and k.split("|")[2] == mesh]
    assert len(keys) == 10
    for key in keys:
        assert port[key] == ref[key], key


def test_cell_supported_equals_reference(reports):
    ref, port = reports[0]["supported"], reports[1]["supported"]
    assert port == ref
    skipped = {k for k, (ok, _) in port.items() if not ok}
    assert skipped and all(k.endswith("|long_500k") for k in skipped)


@pytest.mark.parametrize("shape", FLOP_SHAPES)
def test_matmul_flops_equal_reference(reports, shape):
    want = reports[0]["flops"][shape]
    got = reports[1]["flops"][shape]["total"]
    assert want > 0
    assert abs(got - want) <= 0.01 * want, (got, want)


@pytest.fixture(scope="module")
def fake_and_real(tmp_path_factory):
    args = dict(arch="gpt2-consmax", shape="decode_32k", batch=8, seq=64,
                mesh=[2, 2], overrides={"param_dtype": "float32",
                                        "compute_dtype": "float32"})
    tmp = tmp_path_factory.mktemp("cells")
    return W.spawn("fake", 4, args, tmp)[0], W.spawn("cell", 4, args, tmp)


def test_fake_collectives_equal_real_ranks(fake_and_real):
    fake, ranks = fake_and_real
    assert fake["records"]
    assert {r["kind"] for r in fake["records"]} <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    for res in ranks:
        assert res["records"] == fake["records"]


def test_sharded_logits_equal_one_device(fake_and_real):
    for res in fake_and_real[1]:
        assert res["shape"] == [8, 512]
        assert res["err"] <= 1e-5 * max(res["scale"], 1.0), res
