"""True-positive + clean-pass tests of the port's serving-path static
analysis (``repro_torch.analysis``, ``repro_torch.launch.analyze``), one
for one with the reference's ``tests/test_analysis.py`` where the rule
carries over, plus parity with the reference.

Every lint rule and launch contract check is exercised both ways: a seeded
violation it must flag and a clean case it must not, including the real
serving steps and the real kernel launch plans. The host-sync rule (the
reference's ``no-host-callbacks``) is held to its own seeded ``.item()`` /
``bool()`` / ``nonzero`` cases. Parity: the rule catalogs share their
names (three renamed for the card: host callbacks -> host syncs, VMEM ->
shared memory, scalar prefetch -> index operands); the trace guards count
the same on the same workload; the smoke matrix lints clean.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis.jaxpr_lint import rule_catalog as jrule_catalog
from repro.analysis.kernel_contracts import CHECK_CATALOG as JCHECKS
from repro.analysis.trace_guard import TraceGuard as JTraceGuard
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.launch import analyze as janalyze
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.analysis import collective_contract as CC
from repro_torch.analysis.kernel_contracts import (CHECK_CATALOG,
                                                   KernelLaunch, OutputTile,
                                                   capture_launches,
                                                   check_index_operands,
                                                   check_launch, check_smem,
                                                   check_write_races,
                                                   serving_launches)
from repro_torch.analysis.op_lint import (LAYOUT_OPS, QuantScaleContract,
                                          StepTarget, TensorMeta,
                                          cache_sized_ops, record_ops,
                                          rule_catalog, run_rules,
                                          vocab_sized_outputs)
from repro_torch.analysis.trace_guard import SignatureCounter, TraceGuard
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed import comm as COMM
from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
from repro_torch.launch import analyze
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import init_params

CACHE = (4, 4096, 1, 32)                                  # 524288 elements
CELLS = 4 * 4096 * 1 * 32


def _rules_fired(findings):
    return {f.rule for f in findings}


def _cache(dtype=torch.bfloat16):
    return torch.zeros(CACHE, dtype=dtype)


def _meta(shape, dtype):
    return TensorMeta(tuple(shape), dtype, "cpu")


@pytest.fixture(scope="module")
def qwen2():
    cfg = get_config("qwen2-1.5b", smoke=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


# -------------------------------------------------------------- op lint ----
def test_record_ops_reaches_nested_calls_and_loops():
    """Eager steps have no jaxpr: the recorder sees every op a step
    dispatches, however deep in Python calls and loops it sits."""
    def inner(x):
        for _ in range(2):
            x.transpose(1, 3).contiguous()
        return x

    with record_ops() as ops:
        inner(_cache())
    assert [op.name for op in ops].count("clone") == 2
    assert cache_sized_ops(ops, CELLS, ("clone",))


def test_layout_rule_flags_each_op_and_spares_small_ops():
    big = torch.zeros(CELLS, dtype=torch.bfloat16)
    with record_ops() as ops:
        c = _cache()
        c.transpose(1, 3).contiguous()                      # clone
        torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))      # pad
        c.float()                                           # _to_copy
        big.copy_(c.reshape(-1))                            # copy_
        torch.zeros((8, 8)).t().contiguous()                # under threshold
    bad = cache_sized_ops(ops, CELLS)
    assert {op for op, _ in bad} == set(LAYOUT_OPS)
    findings = run_rules(StepTarget("s", ops, cache_cells=CELLS))
    # the cache-sized WIDENING copy is double-flagged on purpose: it is both
    # a layout materialization and a dequantized full-cache copy
    assert _rules_fired(findings) == {"no-cache-sized-layout-ops",
                                      "quant-scale-contract"}
    assert not cache_sized_ops(ops, CELLS * 8)


def test_layout_rule_ignores_captured_kernel_launches():
    """A kernel launch is one opaque op: under capture the step shows the
    launch and none of the plain version's ops (whose whole-cache .float()
    the rule would flag, as the CPU run without capture shows)."""
    b, L, H, hkv, d = 4, 4096, 2, 1, 32
    q = torch.zeros((b, 1, H, d), dtype=torch.bfloat16)
    k = torch.zeros((b, L, hkv, d), dtype=torch.bfloat16)
    idx = torch.full((b,), L - 1, dtype=torch.int32)
    beta, gamma = torch.ones(H), torch.full((H,), 100.0)
    with record_ops() as plain:
        consmax_decode_op(q, k, k, idx, beta, gamma)
    assert cache_sized_ops(plain, CELLS)
    with capture_launches() as plans, record_ops() as ops:
        out = consmax_decode_op(q, k, k, idx, beta, gamma)
    assert out.shape == q.shape and len(plans) == 1
    assert [op.name for op in ops if op.name.startswith("launch.")] == [
        "launch.consmax_decode"]
    assert not cache_sized_ops(ops, CELLS)


def test_vocab_rule_flags_logits_and_spares_tokens():
    outputs = (_meta((4,), "int32"), _meta((4, 512), "float32"))
    findings = run_rules(StepTarget("s", [], vocab_size=512, outputs=outputs))
    assert _rules_fired(findings) == {"no-vocab-sized-outputs"}
    assert vocab_sized_outputs(outputs, 512) == [(4, 512)]
    # the logits steps (vocab_size None) are exempt on purpose
    assert not run_rules(StepTarget("s", [], outputs=outputs))


@pytest.mark.parametrize("sync", ["item", "bool", "nonzero"])
def test_host_sync_rule_flags_item_bool_and_nonzero(sync):
    x = torch.arange(8)
    with record_ops() as ops:
        if sync == "item":
            x.sum().item()
        elif sync == "bool":
            bool((x > 3).any())
        else:
            x.nonzero()
    assert _rules_fired(run_rules(StepTarget("s", ops))) == {"no-host-syncs"}
    with record_ops() as clean:
        torch.where(x > 3, x, 0).sum()
    assert not run_rules(StepTarget("s", clean))
    # a CPU scalar in a step on the card is no sync with the card
    assert not run_rules(StepTarget("s", ops, device="cuda"))


def test_dtype_stability_rule_flags_upcast_and_arity_change():
    c = _meta(CACHE, "bfloat16")
    up = StepTarget("s", [], cache_in=(c,),
                    cache_out=(_meta(CACHE, "float32"),))
    assert _rules_fired(run_rules(up)) == {"cache-dtype-stability"}
    arity = StepTarget("s", [], cache_in=(c, c), cache_out=(c,))
    assert _rules_fired(run_rules(arity)) == {"cache-dtype-stability"}
    assert not run_rules(StepTarget("s", [], cache_in=(c,), cache_out=(c,)))


def test_quant_scale_rule_flags_nonf32_scales_and_widening_convert():
    q = _meta(CACHE, "int8")
    bad_scale = _meta((4, 4096, 1), "bfloat16")
    t = StepTarget("s", [], cache_in=(q, bad_scale),
                   cache_out=(q, bad_scale), scale_leaves=(1,))
    findings = run_rules(t)
    assert _rules_fired(findings) == {"quant-scale-contract"}
    assert len(findings) == 2              # flagged on the way in AND out
    with record_ops() as wide:
        _cache(torch.int8).float()
    t = StepTarget("s", wide, cache_cells=CELLS)
    assert "quant-scale-contract" in _rules_fired(run_rules(t))
    # the quantize write direction (narrowing) is the sanctioned path
    with record_ops() as narrow:
        torch.zeros(CACHE).to(torch.int8)
    assert not QuantScaleContract().check(
        StepTarget("s", narrow, cache_cells=CELLS))


def test_quant_scale_rule_clean_on_real_int8_steps(qwen2):
    cfg, params = qwen2
    scfg = analyze._matrix(("bfloat16", "int8"))["contig_fused_bounded_int8"]
    assert scfg.kv_cache_dtype == "int8"
    eng = ContinuousBatchingEngine(cfg, scfg, params, device="cpu")
    targets = analyze._step_targets(cfg, scfg, eng)
    assert [t.name for t in targets] == ["prefill", "decode"]
    assert all(t.scale_leaves for t in targets), (
        "quantized step targets must carry scale-leaf indices")
    for target in targets:
        assert not run_rules(target), target.name


def test_real_serving_steps_lint_clean(qwen2):
    """The gate's zero-findings half, on one fused contiguous config: the
    engine's real prefill and decode steps pass every rule, with the
    kernels captured and the sampled epilogue in the step."""
    cfg, params = qwen2
    scfg = analyze._matrix()["contig_fused_bounded"]
    eng = ContinuousBatchingEngine(cfg, scfg, params, device="cpu")
    targets = analyze._step_targets(cfg, scfg, eng)
    for target in targets:
        assert LAYOUT_OPS == ("clone", "copy_", "_to_copy", "constant_pad_nd")
        names = {op.name for op in target.ops}
        assert f"launch.consmax_{target.name}" in names
        assert "sort" in names                  # the draw ran in the step
        assert not run_rules(target), target.name


# ------------------------------------------------------ launch contracts ----
def _race_launch(elected_over=(), election=None):
    # grid dim 1 never reaches the output tile -> a race unless elected
    return KernelLaunch(
        name="k", kernel="k", grid=(4, 8, 1), block=128, smem=0,
        outputs=[OutputTile("out", (4, 128), "float32",
                            lambda bx, by, bz: (bx, bz),
                            elected_over=elected_over)],
        election=election)


def test_write_race_flags_independent_reduce_dim():
    bad = check_write_races(_race_launch())
    assert bad and bad[0].rule == "parallel-write-race"
    assert bad[0].detail[0] == 1                     # the offending dim
    # an elected writer without its election operand is still a race
    assert check_write_races(_race_launch(elected_over=(1,)))


def test_write_race_spares_elected_writer_and_disjoint_writes():
    assert not check_write_races(_race_launch(elected_over=(1,),
                                              election="tickets"))
    disjoint = KernelLaunch(
        name="k", kernel="k", grid=(4, 8, 2), block=128, smem=0,
        outputs=[OutputTile("out", (4, 8, 2), "float32",
                            lambda bx, by, bz: (bz, by, bx))])
    assert not check_write_races(disjoint)


def test_smem_budget_flags_over_budget_plan():
    fat = KernelLaunch(name="k", kernel="k", grid=(2, 1, 1), block=128,
                       smem=200_000, static_smem=40_000)
    bad = check_smem(fat)
    assert bad and bad[0].rule == "smem-budget"
    assert "200000 dynamic + 40000 static" in bad[0].message
    ok = KernelLaunch(name="k", kernel="k", grid=(2, 1, 1), block=128,
                      smem=232_448)
    assert not check_smem(ok)


def test_index_operands_flags_dtype_and_arity():
    launch = KernelLaunch(
        name="k", kernel="k", grid=(2, 1, 1), block=128, smem=0,
        index_operands=[("lengths", (4,), "int32"),
                        ("page_table", (4, 8), "float32")], n_index=3)
    msgs = [f.message for f in check_index_operands(launch)]
    assert any("declares 3" in m for m in msgs)               # arity
    assert any("not int32" in m for m in msgs)                # dtype
    ok = KernelLaunch(name="k", kernel="k", grid=(2, 1, 1), block=128,
                      smem=0, index_operands=[("lengths", (4,), "int32")],
                      n_index=1)
    assert not check_index_operands(ok)


def test_missing_or_ordered_dimension_semantics_is_flagged():
    naked = KernelLaunch(name="k", kernel="k", grid=(4, 8, 1), block=128,
                         smem=0, dims=None)
    assert _rules_fired(check_launch(naked)) == {"grid-semantics-declared"}
    ordered = KernelLaunch(name="k", kernel="k", grid=(4, 8, 1), block=128,
                           smem=0, dims=("independent", "ordered",
                                         "independent"))
    assert _rules_fired(check_launch(ordered)) == {"grid-semantics-declared"}


def _serving_launches(paged, **scfg_kw):
    cfg = get_config("qwen2-1.5b", smoke=True)
    kw = dict(paged_kv=True, page_size=64) if paged else {}
    scfg = ServeConfig(max_seq=4096, prefill_chunk=64, max_slots=4,
                       decode_kernel=True, prefill_kernel=True,
                       score_norm="consmax", **kw, **scfg_kw)
    return serving_launches(cfg, scfg), "paged" if paged else "contiguous"


def _assert_prefill_sharded(pre, prefill_kv_block):
    ns = 4096 // prefill_kv_block
    assert pre.layout["ns"] == ns and pre.grid[0] % ns == 0
    consumers = 2 if pre.layout["dk"] <= 128 else 1
    assert pre.layout["consumers"] == consumers
    assert pre.block == 128 * (consumers + 1)
    assert pre.election == "tickets"
    assert pre.outputs[-1].elected_over == (0,)


@pytest.mark.parametrize("paged", [False, True])
def test_real_serving_kernel_launches_pass_all_contracts(paged):
    """The four serving kernels' plans at the analyzer shapes: concrete
    grids, int32 index operands of the reference's arity, no race (the
    decode output elected over the shard dim by its tickets, the prefill
    output over its KV-shard dim at the default prefill_kv_block), shared
    memory within a block."""
    launches, kind = _serving_launches(paged)
    assert set(launches) == {f"decode_{kind}", f"prefill_{kind}"}
    for label, launch in launches.items():
        assert launch.grid and all(isinstance(g, int) for g in launch.grid)
        assert 0 < launch.smem <= 232_448
        assert not check_launch(launch), label
    dec, pre = launches[f"decode_{kind}"], launches[f"prefill_{kind}"]
    assert dec.n_index == (2 if paged else 1)
    # the reference's (page table,) index, lengths; the contiguous step
    # adds its slot operand where the reference dynamic-slices the slot
    assert pre.n_index == 3
    assert dec.election == "tickets"
    assert dec.outputs[-1].elected_over == (0,) and dec.grid[0] == 16
    _assert_prefill_sharded(pre, 512)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_launches_at_a_set_prefill_kv_block(paged):
    """The prefill plan at ``scfg.prefill_kv_block=64`` (64 shards of 64
    rows over 4096): every launch contract met, the output elected over
    the shard dim by the tickets."""
    launches, kind = _serving_launches(paged, prefill_kv_block=64)
    for launch in launches.values():
        assert not check_launch(launch)
    _assert_prefill_sharded(launches[f"prefill_{kind}"], 64)


def test_capture_launches_restores_dispatch():
    q = torch.randn((2, 1, 2, 32)).bfloat16()
    k = torch.randn((2, 64, 1, 32)).bfloat16()
    idx = torch.tensor([10, 63], dtype=torch.int32)
    beta, gamma = torch.ones(2), torch.full((2,), 100.0)
    with capture_launches() as plans:
        assert not consmax_decode_op(q, k, k, idx, beta, gamma).any()
    out = consmax_decode_op(q, k, k, idx, beta, gamma)      # plain again
    assert out.any() and len(plans) == 1


# ------------------------------------------------------------ trace guard ----
def test_trace_guard_flags_retrace_and_passes_single_shape():
    fn = SignatureCounter(lambda x: x * 2)
    guard = TraceGuard().track("step", fn.cache_size, limit=1)
    fn(torch.zeros(2))
    fn(torch.zeros(2))                   # same signature: no new shape
    assert not guard.findings()
    fn(torch.zeros(3))                   # a second shape leaks in
    bad = guard.findings()
    assert bad and bad[0].rule == "one-trace-per-step"
    assert guard.counts()["step"] == 2
    with pytest.raises(AssertionError):
        guard.assert_ok()


def test_trace_guard_baseline_is_attach_time():
    fn = SignatureCounter(lambda x: x + 1)
    fn(torch.zeros(2))                   # warm BEFORE attach
    guard = TraceGuard().track("step", fn.cache_size, limit=0)
    fn(torch.zeros(2))
    assert guard.counts()["step"] == 0 and not guard.findings()


def test_trace_guard_for_engine_tracks_both_steps(qwen2):
    cfg, params = qwen2
    scfg = ServeConfig(max_seq=24, prefill_chunk=4, max_slots=2)
    eng = ContinuousBatchingEngine(cfg, scfg, params, device="cpu")
    guard = TraceGuard.for_engine(eng, limit=1)
    assert set(guard.counts()) == {"prefill_step", "decode_step"}
    for pr, mx in zip([[3, 1, 4], [2, 7]], [2, 3]):
        eng.submit(pr, mx)
    eng.run(max_steps=60)
    guard.assert_ok()                    # one signature per step


@pytest.mark.parametrize("paged", [False, True])
def test_trace_guard_counts_match_reference(paged):
    """The same short fused workload through both engines: the port's
    signature counts equal the reference's compile counts, step by step
    (paged: the index pin and the page copy tracked too)."""
    from jax.random import key

    from repro_torch.weights import from_jax_params
    import jax
    kw = dict(max_seq=64, prefill_chunk=8, max_slots=2)
    if paged:
        kw.update(paged_kv=True, page_size=4)
    jc = jget("qwen2-1.5b", smoke=True)
    tc = get_config("qwen2-1.5b", smoke=True)
    p = JT.lm_init(Ctx(key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    from repro.serve.sampling import SamplingParams as JSP
    jeng = JEngine(jc, JServeConfig(**kw), p)
    teng = ContinuousBatchingEngine(tc, ServeConfig(**kw), model,
                                    device="cpu")
    jguard = JTraceGuard.for_engine(jeng, limit=1)
    tguard = TraceGuard.for_engine(teng, limit=1)
    r = np.random.default_rng(11)
    prompts = [r.integers(0, tc.vocab_size, n).tolist() for n in (7, 3, 12)]
    for eng, sp in ((jeng, JSP), (teng, SamplingParams)):
        for i, pr in enumerate(prompts):
            eng.submit(pr, 4 + i, sampling=sp(temperature=0.8, seed=i))
        eng.run(max_steps=200)
    assert tguard.counts() == jguard.counts()
    assert tguard.counts()["prefill_step"] == 1
    assert set(tguard.counts()) == set(jguard.counts())


# -------------------------------------------------- collective contract ----
def test_collective_log_is_cleared_by_reset():
    COMM.reset_counts()
    COMM._count("all_gather", torch.zeros((4, 8), dtype=torch.bfloat16))
    assert COMM.calls() == [{"kind": "all_gather", "shape": [4, 8],
                             "dtype": "bfloat16", "bytes": 64}]
    assert COMM.counts()["all_gather"] == {"calls": 1, "bytes": 64}
    COMM.reset_counts()
    assert COMM.calls() == [] and COMM.counts()["all_gather"]["calls"] == 0


def test_collective_rule_flags_cache_sized_and_spares_output_sized():
    cfg = get_config("qwen2-1.5b", smoke=True, n_kv_heads=4)
    scfg = analyze._mesh_matrix()["sharded_paged_fused_2x2"]
    thresh = CC.cache_bytes_per_shard(cfg, scfg)
    assert thresh == scfg.num_pages * scfg.page_size * 4 * 32 * 2 // 4
    calls = [dict(kind="all_reduce", shape=[4, 1, 2, 32], dtype="float32",
                  bytes=1024),
             dict(kind="all_gather", shape=[4, 1, 4, 32], dtype="bfloat16",
                  bytes=1024),
             dict(kind="all_gather", shape=[thresh // 2], dtype="bfloat16",
                  bytes=thresh)]
    ops, bad = CC.check_collectives("s", calls, cache_bytes=thresh)
    assert [f.detail[0] for f in bad] == ["all_gather"]
    assert CC.step_collective_bytes(ops)["total_bytes"] == 2048 + thresh
    assert not CC.check_collectives("s", calls[:2], cache_bytes=thresh)[1]


# --------------------------------------------------------------- the gate ----
def test_analyze_self_test_exits_nonzero(tmp_path):
    """Seeded violations route through the real checks, every rule fires,
    the exit code is non-zero."""
    out = tmp_path / "ANALYSIS_torch.json"
    assert analyze.main(["--self-test", "--device", "cpu", "--json-out",
                         str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["violations"] == len(report["findings"]) > 0
    fired = {f["rule"] for f in report["findings"]}
    assert fired == set(report["rules"])
    assert set(report["rules"]) == (set(rule_catalog()) | set(CHECK_CATALOG)
                                    | set(CC.CONTRACT_CATALOG)
                                    | {"one-trace-per-step"})


def test_analyze_config_clean_and_schema(qwen2):
    """One real config through analyze_config with the trace guard: zero
    findings, and the entry carries the steps, kernels and counts the
    schema asserts."""
    _analyze_clean(qwen2, analyze._matrix()["paged_fused_bounded"])


def test_analyze_config_clean_at_a_set_prefill_kv_block(qwen2):
    """The same with the prefill kernel's KV shards at 64 rows: the gate
    plans the prefill launch at ``scfg.prefill_kv_block``, 0 findings."""
    _analyze_clean(qwen2, dataclasses.replace(
        analyze._matrix()["paged_fused_bounded"], prefill_kv_block=64))


def _analyze_clean(qwen2, scfg):
    cfg, params = qwen2
    entry, findings = analyze.analyze_config("paged_fused_bounded", cfg,
                                             params, scfg)
    assert findings == []
    assert set(entry["steps"]) == {"decode", "prefill"}
    assert set(entry["kernels"]) == {"decode_paged", "prefill_paged"}
    for launch in entry["kernels"].values():
        assert launch["smem_bytes"] > 0 and launch["findings"] == []
    assert entry["trace_guard"]["counts"] == {
        "prefill_step": 1, "decode_step": 1, "set_index": 0, "copy_page": 0}


def test_analyze_threshold_must_dominate_param_surfaces():
    cfg = get_config("qwen2-1.5b", smoke=True)
    scfg = ServeConfig(max_seq=512, prefill_chunk=64, max_slots=4,
                       decode_kernel=True, prefill_kernel=True,
                       score_norm="consmax")
    with pytest.raises(RuntimeError, match="dominate"):
        analyze._cache_threshold(cfg, scfg, "prefill")
    ok = analyze._matrix()["contig_fused_bounded"]
    assert analyze._cache_threshold(cfg, ok, "prefill") > \
        cfg.vocab_size * cfg.d_model


# ---------------------------------------------- parity with the reference ----
def test_rule_catalogs_share_the_reference_names():
    port = set(rule_catalog()) | set(CHECK_CATALOG)
    ref = set(jrule_catalog()) | set(JCHECKS)
    renamed = {"no-host-callbacks": "no-host-syncs",
               "vmem-budget": "smem-budget",
               "scalar-prefetch": "index-operands"}
    assert port == {renamed.get(r, r) for r in ref}
    assert port & ref == ref - set(renamed)
    assert janalyze._cache_threshold(
        jget("qwen2-1.5b", smoke=True), janalyze._matrix()
        ["contig_fused_bounded"], "decode") == analyze._cache_threshold(
        get_config("qwen2-1.5b", smoke=True),
        analyze._matrix()["contig_fused_bounded"], "decode")


def test_smoke_matrix_lints_clean_and_writes_only_its_report(tmp_path,
                                                             monkeypatch):
    """The gate's bare static form on the qwen2 smoke matrix with both
    quantized dtypes: exit 0, its own report name, never the reference's
    ``ANALYSIS.json`` / ``ANALYSIS_mesh.json``."""
    monkeypatch.chdir(tmp_path)
    assert analyze.main(["--device", "cpu", "--skip-trace-guard",
                         "--kv-dtype", "int8", "fp8_e4m3"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ANALYSIS_torch.json"]
    report = json.loads((tmp_path / "ANALYSIS_torch.json").read_text())
    assert report["violations"] == 0 and len(report["configs"]) == 13


def test_mesh_gate_spawns_gloo_ranks_and_holds_the_contract(tmp_path,
                                                            monkeypatch):
    """``--mesh`` on the CPU: a gloo world per sharded config (2, 4 and 4
    ranks, each world joined within 120 s), every collective output-sized,
    the report under its own name."""
    monkeypatch.chdir(tmp_path)
    assert analyze.MESH_TIMEOUT == 120
    assert analyze.main(["--device", "cpu", "--mesh",
                         "--skip-trace-guard"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ANALYSIS_torch_mesh.json"]
    report = json.loads((tmp_path / "ANALYSIS_torch_mesh.json").read_text())
    assert report["violations"] == 0
    tp2 = report["configs"]["sharded_contig_fused_tp2"]["steps"]
    assert tp2["decode"]["collectives"]["bytes_by_kind"] == {
        "all_gather": 2 * 4 * 4 * 32 * 2}        # 2 layers, (4, 1, 4, 32)
    seq4 = report["configs"]["sharded_paged_int8_1x4"]["steps"]
    assert set(seq4["prefill"]["collectives"]["bytes_by_kind"]) == {
        "all_reduce"}
