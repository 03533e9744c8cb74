"""One rank of the dry-run and pipeline tests, and the launcher that starts
them.

    python tests/torch_dryrun_worker.py <spec.json> <rank>

runs the spec's job on rank ``rank`` of a gloo world over a ``FileStore``
(no port, no network), or, for the ``fake`` job, alone over a fake process
group, and writes its JSON result to ``<out>.<rank>``. ``spawn`` starts
every rank of one world, joins them within a time limit (killing them all
and failing on expiry or on any rank's failure) and returns their
results. The worker imports the port only, never JAX.

Jobs: ``pipe`` (``distributed/pipeline.gpipe``, tests/test_torch_pipeline
.py), ``cell`` (one cell of ``launch/specs`` run on real shards, its
collectives recorded, its logits beside one device's) and ``cells``
(several, in one world), ``fake`` (the same cell traced by the dry run
over a fake group) and ``report`` (the cells' ``meta``, FLOPs and a smoke
record over fake groups; tests/test_torch_dryrun.py), ``sites`` (cells'
``op:`` fallbacks over fake groups; tests/test_torch_sharding_rules.py)
and ``count`` (cells traced walking every recurrence step and counting
the repeated ones; tests/test_torch_scan.py).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120           # seconds for one world, the slowest rank included


def spawn(job: str, world: int, args: dict, tmp_path) -> list:
    """Run ``job`` on ``world`` ranks (one process for ``fake``); returns
    each rank's result."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import run_ranks
    tmp = Path(tmp_path)
    spec = tmp / f"{job}-{world}.json"
    out = tmp / f"{job}-{world}.out"
    spec.write_text(json.dumps(dict(job=job, world=world, args=args,
                                    store=str(tmp / f"{job}-{world}.store"),
                                    out=str(out))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    n = 1 if job in ALONE else world
    run_ranks([[sys.executable, __file__, str(spec), str(r)]
               for r in range(n)], timeout=TIMEOUT, env=env)
    return [json.loads(Path(f"{out}.{r}").read_text()) for r in range(n)]


# ------------------------------------------------------------------ jobs ----
def job_pipe(rank: int, args: dict) -> dict:
    """gpipe of ``tanh(x @ w_s)`` stages over the world, ``ws`` (S, d, d)
    and microbatches ``xs`` (M, b, d) given."""
    import torch
    from repro_torch.distributed import comm as COMM
    from repro_torch.distributed.pipeline import gpipe
    ws = torch.tensor(args["ws"], dtype=torch.float32)
    xs = torch.tensor(args["xs"], dtype=torch.float32)
    comm = COMM.Comm()
    COMM.reset_counts()
    out = gpipe(lambda w, x: torch.tanh(x @ w), ws[comm.rank], xs,
                comm=comm)
    return dict(out=out.tolist(), calls=COMM.calls())


def _cell(mesh, args: dict):
    from repro_torch.launch.specs import make_cell
    return make_cell(args["arch"], args["shape"], mesh, smoke=True,
                     global_batch=args["batch"], seq_len=args["seq"],
                     overrides=_overrides(args), device="cpu")


def _overrides(args: dict):
    """A cell's config overrides from JSON (lists back to tuples)."""
    over = args.get("overrides")
    return over and {k: tuple(v) if isinstance(v, list) else v
                     for k, v in over.items()}


def job_cell(rank: int, args: dict) -> dict:
    """The cell on this rank's real shards of a ``(2, 2)`` mesh: its
    collectives, its logits whole, and one device's logits."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.op_analysis import record_collectives
    from repro_torch.launch.specs import materialize, run
    mesh = init_device_mesh("cpu", tuple(args["mesh"]),
                            mesh_dim_names=("data", "model"))
    cell = _cell(mesh, args)
    with record_collectives() as rec:
        logits, _ = run(cell, materialize(cell, seed=0, device="cpu"))
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    one, _ = run(cell, materialize(cell, seed=0, device="cpu", whole=True))
    err = (logits.float() - one.float()).abs().max().item()
    scale = one.float().abs().max().item()
    return dict(records=rec.records, err=err, scale=scale,
                shape=list(logits.shape))


def job_cells(rank: int, args: dict) -> dict:
    """``job_cell`` for each cell of ``args["cells"]`` in one world."""
    return {c["name"]: job_cell(rank, c) for c in args["cells"]}


def job_sites(rank: int, args: dict) -> dict:
    """Alone over fake groups: each listed cell's dry-run trace, its
    ``op:`` fallbacks and collective bytes by kind."""
    from repro_torch.distributed import op_analysis as OA
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.specs import make_cell
    out = {}
    for c in args["cells"]:
        mesh = M._fake_mesh(tuple(c["mesh"]), _NAMES[len(c["mesh"])], "cpu")
        cell = make_cell(c["arch"], c["shape"], mesh, smoke=True,
                         global_batch=c["batch"], seq_len=c["seq"],
                         microbatch=1, overrides=_overrides(c),
                         device="cpu")
        traced = trace_cell(cell)
        st = OA.collective_stats(traced["records"], link_bw=1.0,
                                 num_devices=mesh.size())
        out[c["name"]] = dict(
            op_fallbacks=[[list(s), lg, d] for s, lg, d in cell.op_fallbacks],
            collectives=dict(st.bytes_by_kind))
    return out


def job_count(rank: int, args: dict) -> dict:
    """Alone over fake groups: each listed cell traced twice, once walking
    every step (``nn/scan.walked``) and once counting the repeated steps
    and microbatches; their FLOPs, bytes, transcendentals, collective
    bytes by kind and peaks. A first trace warms the process up: some
    ops run only on the first trace of a process."""
    from repro_torch.distributed import op_analysis as OA
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.specs import make_cell
    from repro_torch.nn.scan import walked
    out = {}
    for c in [args["cells"][0]] + args["cells"]:
        mesh = M._fake_mesh(tuple(c["mesh"]), _NAMES[len(c["mesh"])], "cpu")
        res = {}
        for mode in ("walk", "count"):
            cell = make_cell(c["arch"], c["shape"], mesh, smoke=True,
                             global_batch=c["batch"], seq_len=c["seq"],
                             microbatch=c["microbatch"], remat="none",
                             overrides=_overrides(c), device="cpu")
            if mode == "walk":
                with walked():
                    traced = trace_cell(cell)
            else:
                traced = trace_cell(cell)
            st = OA.collective_stats(traced["records"], link_bw=1.0,
                                     num_devices=mesh.size())
            res[mode] = dict(cost=traced["cost"].summary(),
                             collectives=dict(st.bytes_by_kind),
                             peak=OA.peak_bytes(traced["memory"]),
                             sec=traced["trace_sec"])
        out[c["name"]] = res
    return out


_NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def job_fake(rank: int, args: dict) -> dict:
    """The dry run of the same cell for one device of the mesh."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import trace_cell
    mesh = M._fake_mesh(tuple(args["mesh"]), ("data", "model"), "cpu")
    traced = trace_cell(_cell(mesh, args))
    return dict(records=traced["records"])


def job_report(rank: int, args: dict) -> dict:
    """Alone over fake groups: ``meta`` and the fallback count of every
    listed cell on every listed mesh, ``cell_supported``'s verdicts, the
    matmul FLOPs of the listed one-device cells, and the smoke cell's
    roofline record on a (2, 4) mesh."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import roofline, trace_cell
    from repro_torch.launch.specs import cell_supported, make_cell
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    meta = {}
    for shape in args["meshes"]:
        mesh = M._fake_mesh(tuple(shape), names[len(shape)], "cpu")
        for arch in ARCH_IDS:
            for sh in args["shapes"]:
                cell = make_cell(arch, sh, mesh, device="cpu")
                meta[f"{arch}|{sh}|{shape}"] = dict(
                    {k: cell.meta[k] for k in META_KEYS},
                    fallbacks=len(cell.fallbacks))
    supported = {f"{a}|{s}": list(cell_supported(a, s))
                 for a in ARCH_IDS for s in SHAPES}
    host = M.make_host_mesh(device="cpu")
    flops = {}
    for sh in args["flop_shapes"]:
        traced = trace_cell(make_cell("gpt2-consmax", sh, host, smoke=True,
                                      device="cpu"))
        flops[sh] = dict(traced["matmul_by_op"],
                         total=traced["cost"].matmul_flops)
    mesh = M._fake_mesh((2, 4), names[2], "cpu")
    cell = make_cell("granite-3-2b", "train_4k", mesh, smoke=True,
                     overrides=dict(d_model=128, n_heads=4, n_kv_heads=4,
                                    vocab_size=512),
                     global_batch=8, seq_len=32, microbatch=2, device="cpu")
    smoke = roofline(cell, trace_cell(cell), mesh.size())
    return dict(meta=meta, supported=supported, flops=flops, smoke=smoke)


META_KEYS = ("n_params", "n_active_params", "model_flops",
             "useful_bytes_per_device", "state_bytes_per_device_actual")


def main(spec_path: str, rank: int):
    import torch
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    if spec["job"] in ALONE:
        result = JOBS[spec["job"]](rank, spec["args"])
    else:
        from repro_torch.launch.mesh import init_distributed
        init_distributed("gloo", rank=rank, world_size=spec["world"],
                         init_method=f"file://{spec['store']}")
        import torch.distributed as dist
        result = JOBS[spec["job"]](rank, spec["args"])
        dist.barrier()
        dist.destroy_process_group()
    Path(f"{spec['out']}.{rank}").write_text(json.dumps(result))


JOBS = {"pipe": job_pipe, "cell": job_cell, "cells": job_cells,
        "fake": job_fake, "report": job_report, "sites": job_sites,
        "count": job_count}
ALONE = ("fake", "report", "sites", "count")   # one process, fake groups

if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
