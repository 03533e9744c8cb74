"""Serving-path static-analysis gate of the port: the full rule set over the
serve config matrix, one machine-readable report, non-zero exit on any
violation (the counterpart of the reference's ``launch/analyze.py``).

    PYTHONPATH=src python -m repro_torch.launch.analyze          # on cuda
    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu \
        --skip-trace-guard                                       # fast
    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu \
        --self-test                                              # rules fire?
    PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu \
        --mesh                                                   # sharded gate

For every serve config of the matrix — {contiguous, paged} x {fused
sampling, logits} x {fill-bounded, capacity-swept}, all with both serving
kernels on, plus ``paged_prefix`` (the prefix cache over a warm-admission
workload), plus per quantized ``--kv-dtype`` the two fused bounded configs
— on the smoke config of ``--arch``, the gate:

* runs one prefill chunk and one decode step of a real engine (eager:
  ``cuda_graphs=False``) with the kernels captured
  (``kernel_contracts.capture_launches``: their launch plans recorded,
  nothing launched), records the aten ops each static step
  (``ContinuousBatchingEngine._prefill_step`` / ``_decode_step``, the
  programs a graphed engine captures) dispatches (``op_lint.record_ops``;
  the host bookkeeping around them, the staging copies, the token drain
  and the page-table upload, stays outside the step, as in the
  reference) and runs the
  ``op_lint`` rules: no cache-sized copies, no vocab-sized outputs under
  fused sampling, no host syncs, cache-dtype stability, the quantized
  cache's fp32 scales and no full-cache dequant;
* captures the serving kernels' launch plans at the config's capacity
  shapes and checks them (``kernel_contracts``): declared, independent grid
  dimensions, no write races (the decode output's elected writer
  excepted), shared memory within a Hopper block, int32 index operands;
* unless ``--skip-trace-guard``, drives a short mixed-length workload
  through a fresh engine under a ``TraceGuard``: one step signature across
  admission, ragged prefill, decode and slot recycling (and, for
  ``paged_prefix``, warm admissions and a copy-on-write).

``--mesh`` switches to the sharded matrix (tp 2 contiguous, tp 2 x seq 2
paged, seq 4 paged int8; n_kv_heads 4), one gloo world of ranks per config
(each world joined within ``MESH_TIMEOUT`` seconds): every rank runs the
prefill and decode steps and holds the collectives each logged
(``distributed/comm.calls``) to the ``sharded-collective-contract`` rule.

The report (``ANALYSIS_torch.json`` / ``ANALYSIS_torch_mesh.json`` by
default; never the reference's ``ANALYSIS.json`` / ``ANALYSIS_mesh.json``)
holds the rule catalog, per-config per-step findings and every captured
launch plan, schema-asserted before it is written. ``--self-test`` routes
one seeded violation per rule through the same checks and exits 1 only
if every rule fired.

``--device`` (default cuda) is where the engines run; on cuda with no
card the gate exits with an error instead of running on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

# the analyzer's serving shapes: big enough that cache-sized strictly
# dominates every parameter / activation surface (``_cache_threshold``),
# small enough that the matrix's engines build in seconds
_MAX_SEQ = 4096
_MAX_SLOTS = 4
_CHUNK = 64
_PAGE = 64
JSON_OUT = "ANALYSIS_torch.json"
MESH_JSON_OUT = "ANALYSIS_torch_mesh.json"
MESH_TIMEOUT = 120          # seconds for one world of ranks
ONE_TRACE = {"one-trace-per-step": "one step signature serves every fill "
                                   "level and slot count"}


def _matrix(kv_dtypes=("bfloat16",)):
    from repro_torch.configs.base import ServeConfig
    base = dict(max_seq=_MAX_SEQ, prefill_chunk=_CHUNK, max_slots=_MAX_SLOTS,
                decode_kernel=True, prefill_kernel=True, score_norm="consmax")
    paged = dict(paged_kv=True, page_size=_PAGE)
    out = {}
    for is_paged in (False, True):
        for fused in (True, False):
            for bounded in (True, False):
                label = "_".join(("paged" if is_paged else "contig",
                                  "fused" if fused else "logits",
                                  "bounded" if bounded else "capacity"))
                out[label] = ServeConfig(**base, fused_sampling=fused,
                                         fill_bound=bounded,
                                         **(paged if is_paged else {}))
    # the prefix cache on the production paged config, analyzed over the
    # warm path: the index pin and the page copy join the step targets
    out["paged_prefix"] = ServeConfig(**base, **paged, prefix_cache=True)
    for dt in kv_dtypes:
        if dt in ("bfloat16", "bf16"):
            continue
        for is_paged in (False, True):
            label = ("paged" if is_paged else "contig") + \
                f"_fused_bounded_{dt}"
            out[label] = ServeConfig(**base, kv_cache_dtype=dt,
                                     **(paged if is_paged else {}))
    return out


def _mesh_matrix():
    from repro_torch.configs.base import ServeConfig
    base = dict(max_seq=_MAX_SEQ, prefill_chunk=_CHUNK, max_slots=_MAX_SLOTS,
                decode_kernel=True, prefill_kernel=True, score_norm="consmax")
    return {
        "sharded_contig_fused_tp2": ServeConfig(**base, tp=2),
        "sharded_paged_fused_2x2": ServeConfig(
            **base, paged_kv=True, page_size=_PAGE, tp=2, seq_shards=2),
        "sharded_paged_int8_1x4": ServeConfig(
            **base, paged_kv=True, page_size=_PAGE, kv_cache_dtype="int8",
            seq_shards=4),
    }


def _cache_threshold(cfg, scfg, step: str) -> int:
    """Element count above which an operand is cache-sized for ``step``.

    Decode touches the whole bank (all slots / the whole pool); a prefill
    chunk one slot's rows (contiguous) or the pool (paged). The threshold
    must strictly dominate every non-cache surface or the rule could fire
    on a parameter cast; the embedding / head matrix (vocab x d_model) is
    the largest one."""
    hkv_dk = cfg.n_kv_heads * cfg.head_dim_
    if scfg.paged_kv:
        cells = scfg.num_pages * scfg.page_size * hkv_dk
    elif step == "decode":
        cells = scfg.max_slots * scfg.max_seq * hkv_dk
    else:
        cells = scfg.max_seq * hkv_dk
    largest_param = cfg.vocab_size * cfg.d_model
    if cells <= largest_param:
        raise RuntimeError(
            f"analyzer shapes too small: cache threshold {cells} does not "
            f"dominate the vocab x d_model parameter surface "
            f"{largest_param} — raise _MAX_SEQ")
    return int(cells)


def _leaves(tree, path=()):
    """``(path, tensor)`` of every tensor of a cache tree, in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree)
             if isinstance(tree, (list, tuple)) else ())
    return [leaf for k, v in items for leaf in _leaves(v, path + (k,))]


def _cache_metas(caches):
    from repro_torch.analysis.op_lint import meta
    leaves = _leaves(caches)
    scales = tuple(i for i, (path, _) in enumerate(leaves)
                   if str(path[-1]).endswith("_scale"))
    return tuple(meta(t) for _, t in leaves), scales


def _step_targets(cfg, scfg, eng, *, prefix=False):
    """Run one prefill chunk and one decode step of ``eng`` with the kernels
    captured, recording the ops of each static step (``_prefill_step``,
    ``_decode_step``) and the cache leaves before and after it: one
    ``StepTarget`` per step. ``prefix=True`` adds the warm-admission index
    pin and the COW page copy (they rewrite pool leaves, so the cache rules
    apply to them)."""
    from repro_torch.analysis import op_lint as OL
    from repro_torch.analysis.kernel_contracts import capture_launches
    from repro_torch.models import transformer as T
    from repro_torch.serve.sampling import SamplingParams
    vocab = cfg.vocab_size if scfg.fused_sampling else None
    device = eng.device.type
    targets = []

    def lint(step):
        real = getattr(eng, f"_{step}_step")

        def run(draw):
            cache_in, scales = _cache_metas(eng.caches)
            with OL.record_ops() as ops:
                out = real(draw)
            targets.append(OL.StepTarget(
                step, ops, cache_cells=_cache_threshold(cfg, scfg, step),
                vocab_size=vocab, outputs=OL.metas(out), cache_in=cache_in,
                cache_out=_cache_metas(eng.caches)[0], scale_leaves=scales,
                device=device))
            return out
        setattr(eng, f"_{step}_step", run)

    lint("prefill")
    lint("decode")
    try:
        with capture_launches():
            # a sampled prompt within one chunk: the iteration prefills it
            # (first token) and runs the decode step (second token, done);
            # the draw is the heavier epilogue, greedy's is its argmax
            eng.submit(list(range(1, 1 + min(8, scfg.prefill_chunk))), 2,
                       sampling=SamplingParams(temperature=0.7, top_k=20,
                                               seed=3))
            eng.step()
    finally:
        del eng._prefill_step, eng._decode_step
    names = [t.name for t in targets]
    assert names == ["prefill", "decode"], names
    if prefix:
        cells = _cache_threshold(cfg, scfg, "decode")
        for step, fn in (("set_index", T.set_slot_index),
                         ("copy_page", T.copy_kv_page)):
            cache_in, scales = _cache_metas(eng.caches)
            with OL.record_ops() as ops:
                fn(eng.caches, 0, 0)
            targets.append(OL.StepTarget(
                step, ops, cache_cells=cells, vocab_size=vocab,
                cache_in=cache_in, cache_out=_cache_metas(eng.caches)[0],
                scale_leaves=scales, device=device))
    return targets


def _prompts(cfg, lengths, seed):
    import numpy as np
    r = np.random.default_rng(seed)
    return [r.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def _trace_guard_findings(cfg, eng):
    """Drive a short mixed-length workload (ragged admissions, decode, slot
    recycling, sampled requests) and demand one signature per step."""
    from repro_torch.analysis.trace_guard import TraceGuard
    from repro_torch.serve.sampling import SamplingParams
    guard = TraceGuard.for_engine(eng, limit=1)
    for i, (p, mx) in enumerate(zip(_prompts(cfg, (7, 3, 12), 11),
                                    (4, 6, 3))):
        eng.submit(p, mx, sampling=SamplingParams(temperature=0.8 + 0.2 * i,
                                                  seed=i))
    eng.run(max_steps=120)
    return guard.counts(), guard.findings()


def _prefix_trace_guard_findings(cfg, scfg, eng):
    """Warm-admission workload for the prefix-cache config: a cold page-
    aligned prompt seeds the cache; a fully cached re-serve (index pin +
    one-token tail re-score), a live sharer (copy-on-write) and an extended
    prompt (partial hit) follow. One signature per step, the index pin and
    the page copy included."""
    from repro_torch.analysis.trace_guard import TraceGuard
    guard = TraceGuard.for_engine(eng, limit=1)
    ps = scfg.page_size
    prompt = _prompts(cfg, (2 * ps,), 17)[0]
    eng.submit(prompt, 4)                  # cold: registers both pages
    eng.run(max_steps=60)
    eng.submit(prompt, 3)                  # fully cached: tail re-score
    eng.submit(prompt, 2)                  # live sharer: COW on the tail
    eng.submit(prompt + prompt[:ps], 2)    # partial hit + fresh suffix
    eng.run(max_steps=120)
    # a warm run that never hit the cache or never copied a page would pass
    # the guard while analyzing the wrong path
    assert eng.pool.prefix_hit_rows > 0, "warm workload produced no hits"
    assert eng.pool.cow_copies >= 1, "warm workload never fired COW"
    return guard.counts(), guard.findings()


def analyze_config(label, cfg, params, scfg, *, trace_guard=True):
    """One serve config through the three layers, on ``params``' device.
    Returns the per-config report dict and the list of findings."""
    from repro_torch.analysis.kernel_contracts import (check_launch,
                                                       serving_launches)
    from repro_torch.analysis.op_lint import run_rules
    from repro_torch.serve.engine import ContinuousBatchingEngine

    prefix = label == "paged_prefix"
    device = params.device
    eng = ContinuousBatchingEngine(cfg, scfg, params, device=device,
                                   cuda_graphs=False)
    findings = []
    entry = {"serve": {"paged_kv": scfg.paged_kv,
                       "fused_sampling": scfg.fused_sampling,
                       "fill_bound": scfg.fill_bound,
                       "kv_cache_dtype": scfg.kv_cache_dtype,
                       "prefix_cache": scfg.paged_kv and scfg.prefix_cache,
                       "max_seq": scfg.max_seq,
                       "max_slots": scfg.max_slots},
             "device": device.type, "steps": {}, "kernels": {},
             "trace_guard": None}
    for target in _step_targets(cfg, scfg, eng, prefix=prefix):
        step_findings = run_rules(target)
        findings.extend(step_findings)
        entry["steps"][target.name] = {
            "cache_cells": target.cache_cells, "ops": len(target.ops),
            "launches": sorted({op.name for op in target.ops
                                if op.name.startswith("launch.")}),
            "findings": [f.to_json() for f in step_findings]}
    for kname, launch in serving_launches(cfg, scfg, device=device).items():
        kf = check_launch(launch)
        findings.extend(kf)
        entry["kernels"][kname] = dict(launch.to_json(),
                                       findings=[f.to_json() for f in kf])
    if trace_guard:
        fresh = ContinuousBatchingEngine(cfg, scfg, params, device=device)
        counts, tg = (_prefix_trace_guard_findings(cfg, scfg, fresh)
                      if prefix else _trace_guard_findings(cfg, fresh))
        findings.extend(tg)
        entry["trace_guard"] = {"counts": counts,
                                "findings": [f.to_json() for f in tg]}
    return entry, findings


def _assert_schema(report, labels, *, trace_guard):
    """The artifact contract: a refactor that drops a config, a step, a
    kernel launch or the rule catalog fails the gate instead of thinning
    the report."""
    for key, typ in (("arch", str), ("device", str), ("rules", dict),
                     ("configs", dict), ("violations", int),
                     ("findings", list)):
        assert isinstance(report.get(key), typ), (
            f"analysis schema: missing/mistyped {key!r}")
    assert report["rules"], "analysis schema: empty rule catalog"
    for label in labels:
        entry = report["configs"].get(label)
        assert isinstance(entry, dict), (
            f"analysis schema: config {label!r} missing")
        assert isinstance(entry["serve"].get("kv_cache_dtype"), str), (
            f"analysis schema: {label}.serve.kv_cache_dtype missing")
        steps = ("decode", "prefill")
        if label == "paged_prefix":
            steps += ("set_index", "copy_page")
        for step in steps:
            assert isinstance(entry["steps"].get(step), dict), (
                f"analysis schema: {label}.steps[{step!r}] missing")
        for step in ("decode", "prefill"):
            assert entry["steps"][step]["launches"], (
                f"analysis schema: {label}.steps[{step!r}] captured no "
                "kernel launch (the kernel flags are on)")
        kind = "paged" if entry["serve"]["paged_kv"] else "contiguous"
        for k in (f"decode_{kind}", f"prefill_{kind}"):
            launch = entry["kernels"].get(k)
            assert isinstance(launch, dict), (
                f"analysis schema: {label}.kernels[{k!r}] missing")
            for key in ("grid", "dimension_semantics", "smem_bytes"):
                assert key in launch, (
                    f"analysis schema: {label}.kernels[{k!r}] lacks {key!r}")
        if trace_guard:
            assert isinstance(entry.get("trace_guard"), dict), (
                f"analysis schema: {label}.trace_guard missing")


def _device(name: str):
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("analyze: --device cuda but torch.cuda.is_available()"
                         " is False; pass --device cpu to run on the CPU")
    return device


def _model(arch, device, **over):
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.weights import init_params
    cfg = get_config(arch, smoke=True, **over)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def _write(report, json_out, what):
    if json_out:
        with open(json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"{what}: wrote {json_out} ({report['violations']} violations)")


def run(arch="qwen2-1.5b", *, json_out=JSON_OUT, trace_guard=True,
        kv_dtypes=("bfloat16",), device="cuda") -> int:
    from repro_torch.analysis.kernel_contracts import CHECK_CATALOG
    from repro_torch.analysis.op_lint import rule_catalog
    dev = _device(device)
    cfg, params = _model(arch, dev)
    matrix = _matrix(kv_dtypes)
    report = {"arch": arch, "device": dev.type,
              "rules": dict(rule_catalog(), **CHECK_CATALOG, **ONE_TRACE),
              "configs": {}, "violations": 0, "findings": []}
    for label, scfg in matrix.items():
        entry, findings = analyze_config(label, cfg, params, scfg,
                                         trace_guard=trace_guard)
        report["configs"][label] = entry
        report["findings"] += [dict(f.to_json(), config=label)
                               for f in findings]
        print(f"analyze {label:28s} {'FAIL' if findings else 'ok'}"
              + (f"  ({len(findings)} findings)" if findings else ""))
        for f in findings:
            print(f"  [{f.rule}] {f.target}: {f.message}")
    report["violations"] = len(report["findings"])
    _assert_schema(report, matrix.keys(), trace_guard=trace_guard)
    _write(report, json_out, "analyze")
    return 1 if report["findings"] else 0


# ----------------------------------------------------------------- mesh ----
def mesh_rank(spec_path: str, rank: int):
    """One rank of a ``--mesh`` world: the spec's sharded config on this
    rank, its steps' collectives against the contract, and (unless
    skipped) the trace guard's workload; writes its result as JSON."""
    import torch

    from repro_torch.analysis.collective_contract import (
        cache_bytes_per_shard, check_collectives, step_collective_bytes)
    from repro_torch.analysis.kernel_contracts import capture_launches
    from repro_torch.configs.base import ServeConfig
    from repro_torch.distributed import comm as COMM
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.serve.engine import ContinuousBatchingEngine

    spec = json.loads(Path(spec_path).read_text())
    dev = torch.device(spec["device"])
    init_distributed("gloo", rank=rank, world_size=spec["world"],
                     init_method=f"file://{spec['store']}",
                     device=dev if dev.type == "cuda" else None)
    cfg, params = _model(spec["arch"], dev, n_kv_heads=4)
    scfg = ServeConfig(**spec["serve"])
    label = spec["label"]
    thresh = cache_bytes_per_shard(cfg, scfg)
    eng = ContinuousBatchingEngine(cfg, scfg, params, device=dev)
    steps, findings = {}, []
    real = eng._lm

    def lm(tokens, caches, **kw):
        step = "prefill" if "prefill_append" in kw else "decode"
        COMM.reset_counts()
        out = real(tokens, caches, **kw)
        calls = COMM.calls()
        n = sum(c["calls"] for c in COMM.counts().values())
        assert len(calls) == n, "collective log truncated"
        ops, cf = check_collectives(f"{label}.{step}", calls,
                                    cache_bytes=thresh,
                                    group_size=spec["world"])
        findings.extend(cf)
        steps[step] = {"cache_bytes_per_shard": thresh,
                       "collectives": step_collective_bytes(ops),
                       "findings": [f.to_json() for f in cf]}
        return out

    eng._lm = lm
    try:
        with capture_launches():
            eng.submit(list(range(1, 9)), 2)
            eng.step()
    finally:
        del eng._lm
    entry = {"serve": {"tp": scfg.tp, "seq_shards": scfg.seq_shards,
                       "paged_kv": scfg.paged_kv,
                       "kv_cache_dtype": scfg.kv_cache_dtype,
                       "fused_sampling": scfg.fused_sampling},
             "steps": steps, "trace_guard": None}
    if spec["trace_guard"]:
        fresh = ContinuousBatchingEngine(cfg, scfg, params, device=dev)
        counts, tg = _trace_guard_findings(cfg, fresh)
        findings.extend(tg)
        entry["trace_guard"] = {"counts": counts,
                                "findings": [f.to_json() for f in tg]}
    torch.distributed.destroy_process_group()
    Path(f"{spec['out']}.{rank}").write_text(json.dumps(
        {"entry": entry, "findings": [f.to_json() for f in findings]}))


def _assert_mesh_schema(report, labels, *, trace_guard):
    for key, typ in (("arch", str), ("device", str), ("rules", dict),
                     ("configs", dict), ("violations", int),
                     ("findings", list)):
        assert isinstance(report.get(key), typ), (
            f"mesh analysis schema: missing/mistyped {key!r}")
    assert "sharded-collective-contract" in report["rules"], (
        "mesh analysis schema: contract rule missing from catalog")
    for label in labels:
        entry = report["configs"].get(label)
        assert isinstance(entry, dict), (
            f"mesh analysis schema: config {label!r} missing")
        for k in ("tp", "seq_shards"):
            assert isinstance(entry["serve"].get(k), int), (
                f"mesh analysis schema: {label}.serve.{k} missing")
        for step in ("decode", "prefill"):
            sd = entry["steps"].get(step)
            assert isinstance(sd, dict), (
                f"mesh analysis schema: {label}.steps[{step!r}] missing")
            assert isinstance(sd.get("collectives", {}).get("total_bytes"),
                              int), (
                f"mesh analysis schema: {label}.steps[{step!r}] lacks "
                "collective bytes")
        if trace_guard:
            assert isinstance(entry.get("trace_guard"), dict), (
                f"mesh analysis schema: {label}.trace_guard missing")


def run_mesh(arch="qwen2-1.5b", *, json_out=MESH_JSON_OUT, trace_guard=True,
             device="cuda") -> int:
    """The ``--mesh`` gate: each sharded config in its own gloo world of
    tp * seq_shards ranks (sharing the one card on cuda), spawned and
    joined within ``MESH_TIMEOUT`` seconds."""
    from repro_torch.analysis.collective_contract import CONTRACT_CATALOG
    from repro_torch.launch.mesh import run_ranks
    dev = _device(device)
    report = {"arch": arch, "device": dev.type,
              "rules": dict(CONTRACT_CATALOG, **ONE_TRACE), "configs": {},
              "violations": 0, "findings": []}
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    matrix = _mesh_matrix()
    with tempfile.TemporaryDirectory() as tmp:
        for label, scfg in matrix.items():
            world = scfg.tp * scfg.seq_shards
            spec = Path(tmp) / f"{label}.json"
            out = Path(tmp) / f"{label}.out"
            serve = {f: getattr(scfg, f) for f in (
                "max_seq", "prefill_chunk", "max_slots", "decode_kernel",
                "prefill_kernel", "score_norm", "paged_kv", "page_size",
                "kv_cache_dtype", "tp", "seq_shards") if f != "page_size"
                or scfg.paged_kv}
            spec.write_text(json.dumps(dict(
                arch=arch, label=label, device=str(dev), world=world,
                serve=serve, trace_guard=trace_guard,
                store=str(Path(tmp) / f"{label}.store"), out=str(out))))
            run_ranks([[sys.executable, "-m", "repro_torch.launch.analyze",
                        "--mesh-rank", str(spec), str(r)]
                       for r in range(world)], timeout=MESH_TIMEOUT, env=env)
            ranks = [json.loads(Path(f"{out}.{r}").read_text())
                     for r in range(world)]
            report["configs"][label] = dict(ranks[0]["entry"], world=world)
            found = [dict(f, config=label, rank=r)
                     for r, res in enumerate(ranks) for f in res["findings"]]
            report["findings"] += found
            bytes_ = {s: d["collectives"]["total_bytes"]
                      for s, d in ranks[0]["entry"]["steps"].items()}
            print(f"analyze --mesh {label:28s} {'FAIL' if found else 'ok'}  "
                  f"{world} ranks, collective bytes per rank {bytes_}"
                  + (f"  ({len(found)} findings)" if found else ""))
            for f in found:
                print(f"  [{f['rule']}] rank {f['rank']} {f['target']}: "
                      f"{f['message']}")
    report["violations"] = len(report["findings"])
    _assert_mesh_schema(report, matrix.keys(), trace_guard=trace_guard)
    _write(report, json_out, "analyze --mesh")
    return 1 if report["findings"] else 0


# ------------------------------------------------------------- self-test ----
def _self_test(json_out) -> int:
    """Seed one violation per rule through the real checks; every rule must
    fire. Exit 1 when all did (the gate's non-zero exit on findings), 2
    when one did not."""
    import torch

    from repro_torch.analysis import op_lint as OL
    from repro_torch.analysis.collective_contract import check_collectives
    from repro_torch.analysis.kernel_contracts import (KernelLaunch,
                                                       OutputTile,
                                                       check_launch)
    from repro_torch.analysis.trace_guard import SignatureCounter, TraceGuard

    cache = torch.zeros((4, 4096, 1, 32), dtype=torch.int8)
    logits = torch.zeros((4, 512))
    with OL.record_ops() as ops:
        relaid = cache.transpose(1, 3).contiguous()   # a full-cache copy
        wide = cache.float()                          # a dequantized copy
        int(logits[0, 0])                             # a host sync
    bf16_scale = OL.TensorMeta((4, 4096, 1), "bfloat16", "cpu")
    findings = OL.run_rules(OL.StepTarget(
        "seeded_step", ops, cache_cells=4 * 4096 * 32, vocab_size=512,
        outputs=OL.metas((relaid, logits)),
        cache_in=(OL.meta(cache), bf16_scale),
        cache_out=(OL.meta(wide), bf16_scale), scale_leaves=(1,)))

    race = KernelLaunch(
        name="seeded_kernel", kernel="seeded", grid=(4, 8, 1), block=256,
        smem=300_000,                                 # over a block's budget
        dims=("independent", "ordered", "independent"),
        outputs=[OutputTile("out", (4, 128), "float32",
                            lambda bx, by, bz: (bx, 0))],   # dim 1 reduces
        index_operands=[("page_table", (4, 8), "float32")], n_index=1)
    findings += check_launch(race)

    step = SignatureCounter(lambda x: x * 2)
    guard = TraceGuard().track("seeded_retrace", step.cache_size, limit=1)
    step(torch.zeros(2))
    step(torch.zeros(3))                              # a second signature
    findings += guard.findings()

    # a rank gathering a shard's whole KV pool
    _, cf = check_collectives("seeded_sharded", [dict(
        kind="all_gather", shape=[16, 65536], dtype="bfloat16",
        bytes=16 * 65536 * 2)], cache_bytes=1 << 20, group_size=4)
    findings += cf

    fired = {f.rule for f in findings}
    expected = {"no-cache-sized-layout-ops", "no-vocab-sized-outputs",
                "no-host-syncs", "cache-dtype-stability",
                "quant-scale-contract", "parallel-write-race",
                "grid-semantics-declared", "smem-budget", "index-operands",
                "one-trace-per-step", "sharded-collective-contract"}
    missing = expected - fired
    report = {"arch": "self-test", "device": "cpu",
              "rules": {r: "seeded" for r in expected}, "configs": {},
              "violations": len(findings),
              "findings": [f.to_json() for f in findings]}
    _write(report, json_out, "analyze --self-test")
    if missing:
        print(f"analyze --self-test: rules did not fire: {sorted(missing)}")
        return 2
    print(f"analyze --self-test: all {len(expected)} rules fired "
          f"({len(findings)} seeded findings) -> exit 1")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-path static-analysis gate of the port")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--json-out", default=None,
                    help=f"report path ('' disables; default {JSON_OUT}, "
                         f"with --mesh {MESH_JSON_OUT})")
    ap.add_argument("--skip-trace-guard", action="store_true",
                    help="static layers only: skip driving the engines")
    ap.add_argument("--self-test", action="store_true",
                    help="seed one violation per rule; exit 1 iff every "
                         "rule fires")
    ap.add_argument("--kv-dtype", nargs="+", default=["bfloat16"],
                    choices=("bfloat16", "bf16", "int8", "fp8_e4m3"),
                    help="KV cache dtypes to sweep: each quantized dtype "
                         "adds two kernel-on configs with codes + fp32 "
                         "scales")
    ap.add_argument("--mesh", action="store_true",
                    help="sharded gate: gloo ranks per sharded config, "
                         "every collective against the contract")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda, or cpu)")
    ap.add_argument("--mesh-rank", nargs=2, metavar=("SPEC", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_rank:
        mesh_rank(args.mesh_rank[0], int(args.mesh_rank[1]))
        return 0
    if args.self_test:
        return _self_test(JSON_OUT if args.json_out is None
                          else args.json_out)
    if args.mesh:
        return run_mesh(args.arch, json_out=(MESH_JSON_OUT if args.json_out
                                             is None else args.json_out),
                        trace_guard=not args.skip_trace_guard,
                        device=args.device)
    return run(args.arch, json_out=(JSON_OUT if args.json_out is None
                                    else args.json_out),
               trace_guard=not args.skip_trace_guard,
               kv_dtypes=tuple(args.kv_dtype), device=args.device)


if __name__ == "__main__":
    sys.exit(main())
