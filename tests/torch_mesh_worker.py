"""One rank of the port's multi-process mesh tests, and the launcher that
starts them.

    python tests/torch_mesh_worker.py <spec.json> <rank>

runs the spec's job on rank ``rank`` of a gloo world over a ``FileStore``
(no port, no network) and writes its JSON result to ``<out>.<rank>``.
``spawn`` starts every rank of one world, joins them within a time limit
(killing them all and failing on expiry or on any rank's failure) and
returns their results. The worker imports the port only, never JAX: the
tests compare its results with the reference in their own process.

Jobs: ``serve`` (the sharded engine, tests/test_torch_mesh.py), ``cp``
(context-parallel decode, tests/test_torch_context_parallel.py) and
``train`` (data-parallel training, compressed_psum, the expert-parallel
MoE, elastic checkpoints; tests/test_torch_mesh_train.py).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120           # seconds for one world, the slowest rank included


def spawn(job: str, world: int, args: dict, tmp_path) -> list:
    """Run ``job`` on ``world`` ranks; returns each rank's result."""
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
    run_ranks([[sys.executable, __file__, str(spec), str(r)]
               for r in range(world)], timeout=TIMEOUT, env=env)
    return [json.loads(Path(f"{out}.{r}").read_text()) for r in range(world)]


# ------------------------------------------------------------------ jobs ----
def _lm(arch: str, weights: str, **over):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(arch, smoke=True, **over)
    model = LM(cfg, device="cpu")
    model.load_state_dict(torch.load(weights))
    return cfg, model


def _serve_once(cfg, model, scfg, prompts, budgets):
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.sampling import SamplingParams
    eng = ContinuousBatchingEngine(
        cfg, scfg, model, device="cpu",
        default_sampling=SamplingParams(temperature=0.8, top_k=40, seed=7))
    uids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run(max_steps=300)
    return dict(tokens=[res.get(u) for u in uids],
                signatures=[eng.prefill_cache_size, eng.decode_cache_size],
                collectives=eng.collectives, steps=eng.model_steps)


def job_serve(rank: int, args: dict) -> dict:
    """For each case: rank 0 serves on one device (no mesh); then every
    rank serves through the mesh engine at (tp, seq_shards)."""
    import torch.distributed as dist
    from repro_torch.configs.base import ServeConfig
    out = {}
    for case in args["cases"]:
        cfg, model = _lm(case["arch"], case["weights"], **case["over"])
        key = case["id"]
        if rank == 0 and case.get("single", True):
            out[key + "/single"] = _serve_once(
                cfg, model, ServeConfig(**case["serve"]), case["prompts"],
                case["budgets"])
        dist.barrier()
        out[key] = _serve_once(
            cfg, model, ServeConfig(**case["serve"], tp=case["tp"],
                                    seq_shards=case["ns"]),
            case["prompts"], case["budgets"])
    return out


def job_cp(rank: int, args: dict) -> dict:
    """Context-parallel decode over the whole world as one ``seq`` group:
    each rank takes its rows of the npz's K/V; per normalizer, the
    replicated output and this rank's collective counts."""
    import numpy as np
    import torch
    from repro_torch.core import context_parallel as CP
    from repro_torch.core.consmax import ConSmaxParams
    from repro_torch.configs.base import ConSmaxConfig
    from repro_torch.distributed import comm as COMM
    d = {k: torch.from_numpy(v) for k, v in np.load(args["inputs"]).items()}
    comm = COMM.Comm()
    L = d["k"].shape[1]
    lo, hi = rank * L // comm.size, (rank + 1) * L // comm.size
    params = ConSmaxParams(d["beta"].shape[0], ConSmaxConfig())
    params.load_state_dict({"beta": d["beta"], "gamma": d["gamma"]})
    out = {}
    for kind in ("consmax", "softmax"):
        fn = CP.make_cp_decode(comm, kind, params,
                               merged=kind == "consmax")
        COMM.reset_counts()
        o = fn(d["q"], d["k"][:, lo:hi], d["v"][:, lo:hi], d["index"])
        out[kind] = dict(out=o.tolist(), counts=COMM.counts())
    return out


def job_train(rank: int, args: dict) -> dict:
    """Data-parallel training over the whole world as one ``data`` axis:
    gpt2-consmax with FSDP (saving a checkpoint) and with replicated
    parameters; a resume from a single-device checkpoint; compressed_psum
    on per-rank trees; the expert-parallel MoE against moe_apply."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import comm as COMM
    from repro_torch.launch.mesh import train_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.train.trainer import Trainer
    mesh = train_mesh()
    cfg = get_config("gpt2-consmax", **args["model"])

    def trainer(**kw):
        model = LM(cfg, device="cpu")
        model.load_state_dict(torch.load(args["weights"]))
        return Trainer(cfg, TrainConfig(**args["train"], **kw.pop("t", {})),
                       mesh=mesh, model=model, device="cpu", log_every=1000,
                       **kw)

    out = {}
    for fsdp in (True, False):
        ck = dict(ckpt_dir=args["ckpt"], ckpt_every=args["ckpt_every"]) \
            if fsdp else {}
        COMM.reset_counts()
        tr = trainer(t=dict(fsdp=fsdp), **ck)
        hist = tr.run(args["steps"])
        out[f"fsdp={fsdp}"] = dict(
            loss=[h["loss"] for h in hist],
            grad_norm=[h["grad_norm"] for h in hist],
            counts=COMM.counts(),
            sharded=type(next(tr.state["params"].parameters())).__name__)
    tr = trainer(ckpt_dir=args["single_ckpt"], ckpt_every=10**6)
    out["resumed_at"] = tr.step_index()
    out["resumed"] = [h["loss"] for h in tr.run(args["resume_steps"])]

    gen = torch.Generator().manual_seed(100 + rank)
    tree = {f"g{i}": torch.randn(shape, generator=gen) * 10.0 ** (i - 1)
            for i, shape in enumerate([(17,), (4, 8), (3, 5, 2)])}
    comm = COMM.Comm()
    got = compressed_psum(tree, comm)
    out["psum"] = dict(tree={k: v.tolist() for k, v in tree.items()},
                       out={k: v.tolist() for k, v in got.items()})
    out["ep"] = _ep_case(rank, comm)
    return out


def _ep_case(rank: int, comm) -> dict:
    """phi3.5-moe smoke with 8 experts and capacity factor 8.0 (no drops):
    moe_apply_ep on this rank's rows vs moe_apply on the whole batch at
    bf16, directly and through an attention block under
    ``expert_parallel``; then at fp32 the gradients of a fixed linear loss,
    summed over the ranks, vs the whole batch's."""
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import comm as COMM
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import blocks as B
    from repro_torch.models import moe as MOE
    from repro_torch.models import moe_ep as MOE_EP
    moe = MoEConfig(n_experts=8, top_k=2, d_ff_expert=256,
                    capacity_factor=8.0)
    res = {}
    for cd in ("bfloat16", "float32"):
        cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True, moe=moe,
                         compute_dtype=cd)
        gen = torch.Generator().manual_seed(0)
        blk = B.Block(cfg, "attn_moe", device="cpu")
        blk.reset_parameters(gen)
        x = torch.randn((8, 16, cfg.d_model), generator=gen).to(cfg.cdtype())
        rows = slice(rank * 8 // comm.size, (rank + 1) * 8 // comm.size)
        if cd == "bfloat16":
            with torch.no_grad():
                y_ref, aux_ref = MOE.moe_apply(blk.moe, x, cfg)
                COMM.reset_counts()
                y_ep, aux_ep = MOE_EP.moe_apply_ep(blk.moe, x[rows], cfg,
                                                   comm)
                counts = COMM.counts()
                h_ref, _, _ = B.block_apply(blk, x, cfg)
                with SH.expert_parallel(comm):
                    h_ep, _, _ = blk(x[rows], cfg)
            res["y_err"] = float((y_ep.float() - y_ref[rows].float())
                                 .abs().max())
            res["aux"] = [float(aux_ep), float(aux_ref)]
            res["block_err"] = float((h_ep.float() - h_ref[rows].float())
                                     .abs().max())
            res["counts"] = counts
            continue
        r = torch.randn((8, 16, cfg.d_model), generator=gen)
        blk.requires_grad_(True)
        params = dict(blk.moe.named_parameters())
        y_ref, _ = MOE.moe_apply(blk.moe, x, cfg)
        g_ref = torch.autograd.grad((y_ref * r).sum(), list(params.values()))
        y_ep, _ = MOE_EP.moe_apply_ep(blk.moe, x[rows], cfg, comm)
        g_ep = torch.autograd.grad((y_ep * r[rows]).sum(),
                                   list(params.values()), allow_unused=True)
        errs = {}
        for name, a, b in zip(params, g_ref, g_ep):
            b = torch.zeros_like(a) if b is None else b
            b = comm.all_reduce(b.clone())
            errs[name] = float((a - b).abs().max() / a.abs().max())
        res["grad_rel_err"] = errs
    return res


def main(spec_path: str, rank: int):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    spec = json.loads(Path(spec_path).read_text())
    init_distributed("gloo", rank=rank, world_size=spec["world"],
                     init_method=f"file://{spec['store']}")
    import torch.distributed as dist
    result = JOBS[spec["job"]](rank, spec["args"])
    dist.barrier()
    dist.destroy_process_group()
    Path(f"{spec['out']}.{rank}").write_text(json.dumps(result))


JOBS = {"serve": job_serve, "cp": job_cp, "train": job_train}

if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
