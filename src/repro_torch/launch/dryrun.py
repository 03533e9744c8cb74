"""Dry run: trace every (architecture x shape x mesh) cell for one device of
the production mesh, on fake tensors, and write its roofline record — the
reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch qwen2-1.5b                   # train_4k, prefill_32k, ...
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # on cuda

Each cell (``launch/specs.make_cell``) is traced once: its step runs on
one device's fake shards under ``FakeTensorMode`` over a fake process
group of the mesh's size (``launch/mesh.make_production_mesh``), so no
device memory is allocated and no collective moves a byte. While it runs,
``distributed/op_cost`` counts the device's FLOPs, transcendentals and
bytes, ``distributed/op_analysis`` its collectives and its live memory.
The record has the reference's keys: ``status``, ``meta``, ``cost``,
``memory``, ``collectives``, ``roofline`` (compute, memory and
collective seconds at the H100 constants of ``launch/mesh``, the dominant
term, ``bound_sec``, ``ideal_sec`` and the ratios), ``hbm``
(``peak_bytes_per_device``, ``fits_80GB``) and ``fallbacks``.
``trace_sec`` takes the place of the reference's ``lower_sec`` and
``compile_sec``; ``cost`` has no ``xla_naive`` (there is no XLA), and
there is no ``--save-hlo`` (there is no HLO to save). Records go to
``artifacts/dryrun_torch/``.

A failing cell is recorded with its error, and the sweep goes on; the
exit code is 1 if any cell erred. Repeated work is traced until it
repeats and counted with its trip count (the reference's while-loop
multiplicity): the xLSTM recurrences' steps (``nn/scan``) and a train
step's microbatches. ``--device`` names the fake tensors' device (default
cuda; fake tensors need no card, but the port's entry points refuse cuda
where none is present, so pass ``cpu`` there).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, LINK_BW,
                                     PEAK_FLOPS, make_production_mesh)


def trace_cell(cell) -> dict:
    """Run ``cell.fn`` once on its fake arguments and count it: ``{cost,
    memory, collective records, trace_sec}``."""
    from repro_torch.distributed import op_analysis as OA
    from repro_torch.distributed.op_cost import OpCounter
    from repro_torch.launch.specs import run
    t0 = time.perf_counter()
    with cell.fake_mode:
        with OA.track_memory(cell.args) as mem, \
                OA.record_collectives() as coll, OpCounter() as counter:
            out = run(cell, cell.args)
        memory = OA.memory_summary(mem, out)
    return {"cost": counter.cost, "matmul_by_op": counter.matmul_by_op,
            "memory": memory, "records": coll.records,
            "trace_sec": time.perf_counter() - t0, "out": out}


def roofline(cell, traced: dict, n_dev: int) -> dict:
    """The record's ``cost`` / ``memory`` / ``collectives`` / ``roofline``
    / ``hbm`` of a traced cell."""
    from repro_torch.distributed import op_analysis as OA
    cost = traced["cost"].summary()
    coll = OA.collective_stats(traced["records"], link_bw=LINK_BW,
                               num_devices=n_dev)
    mem = traced["memory"]
    terms = {"compute": cost["flops"] / PEAK_FLOPS,
             "memory": cost["bytes"] / HBM_BW,
             "collective": coll.seconds}
    dominant = max(terms, key=terms.get)
    bound_sec = max(terms.values())
    model_flops = cell.meta["model_flops"]
    useful_bytes = cell.meta.get("useful_bytes_per_device", 0)
    flops_global = cost["flops"] * n_dev
    # irreducible step time for this workload on this hardware
    ideal_sec = max(model_flops / n_dev / PEAK_FLOPS, useful_bytes / HBM_BW)
    peak = OA.peak_bytes(mem)
    return {
        "cost": cost, "memory": mem, "collectives": coll.summary(),
        "roofline": {
            "compute_sec": terms["compute"],
            "memory_sec": terms["memory"],
            "collective_sec": terms["collective"],
            "dominant": dominant,
            "bound_sec": bound_sec,
            "ideal_sec": ideal_sec,
            "model_flops": model_flops,
            "useful_bytes_per_device": useful_bytes,
            "op_flops_per_device": cost["flops"],
            "op_flops_global": flops_global,
            "useful_flops_ratio": (model_flops / flops_global
                                   if flops_global else 0.0),
            "useful_bytes_ratio": (useful_bytes / cost["bytes"]
                                   if cost["bytes"] else 0.0),
            "roofline_fraction": (ideal_sec / bound_sec
                                  if bound_sec > 0 else 0.0),
        },
        "hbm": {"peak_bytes_per_device": peak,
                "fits_80GB": bool(peak <= HBM_PER_CHIP)},
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: str,
             tag: str = "", device="cuda", **cell_kw) -> dict:
    from repro_torch.launch.specs import cell_supported, make_cell
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    ok, why = cell_supported(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_dir, rec, tag)
        print(f"[dryrun] SKIP {arch} x {shape} ({mesh_name}): {why}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_dev = mesh.size()
    try:
        cell = make_cell(arch, shape, mesh, device=device, **cell_kw)
        traced = trace_cell(cell)
        rec.update(status="ok", meta=cell.meta,
                   trace_sec=traced["trace_sec"],
                   **roofline(cell, traced, n_dev),
                   fallbacks=[{"shape": list(s), "logical": lg, "dim": d}
                              for s, lg, d in cell.fallbacks
                              + cell.op_fallbacks])
        r, c = rec["roofline"], rec["collectives"]
        print(f"[dryrun] OK {arch} x {shape} "
              f"({mesh_name}{'/' + tag if tag else ''}) "
              f"trace={rec['trace_sec']:.1f}s "
              f"compute={r['compute_sec']:.3e}s "
              f"memory={r['memory_sec']:.3e}s "
              f"coll={r['collective_sec']:.3e}s dominant={r['dominant']} "
              f"roofline_frac={r['roofline_fraction']:.3f} "
              f"peak={rec['hbm']['peak_bytes_per_device'] / 2**30:.2f}GiB "
              f"fits={rec['hbm']['fits_80GB']} "
              f"coll_bytes={c['bytes_by_kind']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] FAIL {arch} x {shape} ({mesh_name}): "
              f"{type(e).__name__}: {str(e)[:500]}")
    _write(out_dir, rec, tag)
    return rec


def _fname(out_dir, rec, tag=""):
    os.makedirs(out_dir, exist_ok=True)
    t = f"--{tag}" if tag else ""
    return os.path.join(
        out_dir, f"{rec['arch']}--{rec['shape']}--{rec['mesh']}{t}")


def _write(out_dir, rec, tag=""):
    with open(_fname(out_dir, rec, tag) + ".json", "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--score-norm", default="consmax",
                    choices=["consmax", "softmax", "softermax"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--fsdp", default="full",
                    choices=["full", "zero1", "none"])
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--q-chunk", type=int, default=2048)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--seq-shard-kv", default="auto",
                    choices=["auto", "none", "dp", "model", "2d"])
    ap.add_argument("--serve-tp2d", action="store_true")
    ap.add_argument("--expert-shard", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu for the CPU tests)")
    args = ap.parse_args(argv)

    ssk = {"auto": None, "none": False, "dp": "dp",
           "model": "model", "2d": "2d"}[args.seq_shard_kv]
    kw = dict(score_norm=args.score_norm, fsdp=args.fsdp,
              microbatch=args.microbatch, remat=args.remat,
              q_chunk=args.q_chunk, kv_chunk=args.kv_chunk,
              seq_shard_kv=ssk, serve_tp2d=args.serve_tp2d,
              expert_shard=args.expert_shard,
              capacity_factor=args.capacity_factor)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ([False, True] if (args.all or args.both_meshes)
              else [args.multi_pod])
    results = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                if args.skip_existing:
                    mesh_name = "multi_pod" if mp else "single_pod"
                    t = f"--{args.tag}" if args.tag else ""
                    fp = os.path.join(args.out, f"{a}--{s}--{mesh_name}{t}.json")
                    if os.path.exists(fp):
                        with open(fp) as f:
                            results.append(json.load(f))
                        continue
                results.append(run_cell(a, s, multi_pod=mp, out_dir=args.out,
                                        tag=args.tag, device=args.device,
                                        **kw))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(results)} cells")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
