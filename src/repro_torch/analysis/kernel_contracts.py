"""Static launch contracts of the serving CUDA kernels — their launch plans
checked *without running the kernels* (the counterpart of the reference's
``analysis/kernel_contracts.py``).

Each kernel wrapper computes its launch as a ``kernels.launch_plan.
LaunchPlan`` before it launches (operand checks, grid, block, dynamic
shared memory, the tile each block writes, the index operands).
``capture_launches`` records those plans instead of launching: the
wrappers run exactly as written (operand checks, shard sizes, GQA folding),
and each call returns zeros of its output's shape. Nothing is built or
launched and no plain version runs, so the checks run on any device in
milliseconds; a ``KernelLaunch`` is one recorded plan.

Checks (the kernel half of the serving contract; names shared with the
reference where the meaning carries over):

* ``smem-budget`` (the reference's ``vmem-budget``) — dynamic plus static
  shared memory within what a Hopper block may use,
  ``_build.SMEM_PER_BLOCK`` (232,448 B). The plan's number is the Python
  twin of the library's own (``consmax_decode_smem_bytes``,
  ``attn_walk_smem_bytes``); ``chip_smoke.py`` phase 18 holds the two
  equal for every instantiation.
* ``parallel-write-race`` — every grid dimension of a CUDA launch is
  independent (blocks run concurrently, in no order), so two blocks mapped
  to one output tile race. Probed by evaluating each output's tile map at
  unit block-index offsets. The one sanctioned exception is an output
  whose writer is elected at run time over the dimensions it names
  (``elected_over``) through an election operand (the decode kernel's
  integer tickets: the last shard of each (slot, KV head) writes ``out``);
  a dimension not named there, or a plan naming one without its election
  operand, is still a race.
* ``grid-semantics-declared`` — the plan declares every grid dimension's
  semantics, and each is ``"independent"`` (a CUDA grid has no ordered
  dimension: a plan that relies on block order is wrong).
* ``index-operands`` (the reference's ``scalar-prefetch``) — the page
  table, ``index`` and ``lengths`` a launch reads, and the contiguous
  prefill's ``slot``, are int32 and as many as the plan declares.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.op_lint import Finding
from repro_torch.kernels import _build
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.launch_plan import LaunchPlan as KernelLaunch
from repro_torch.kernels.launch_plan import OutputTile

SMEM_BUDGET_BYTES = _build.SMEM_PER_BLOCK
DIM_KINDS = ("independent",)

CHECK_CATALOG = {
    "grid-semantics-declared": "every launched grid declares its dimensions'"
                               " semantics, all independent (a CUDA grid "
                               "runs its blocks in no order)",
    "parallel-write-race": "two blocks of an independent grid dim never map "
                           "to one output tile, unless one writer per tile "
                           "is elected at run time through a declared "
                           "election operand",
    "smem-budget": "dynamic + static shared memory per block within the "
                   f"{SMEM_BUDGET_BYTES}-byte Hopper limit",
    "index-operands": "the page table / index / lengths / slot operands "
                      "are int32 and match the declared arity",
}

__all__ = ["KernelLaunch", "OutputTile", "capture_launches", "check_launch",
           "serving_launches", "CHECK_CATALOG"]


def capture_launches():
    """Record the kernel wrappers' launch plans instead of launching them;
    yields the list of ``KernelLaunch`` records (see the module doc)."""
    return LP.capture()


# --------------------------------------------------------------- checks ----
def check_grid_semantics(launch: KernelLaunch) -> list[Finding]:
    grid = tuple(int(g) for g in launch.grid)
    if launch.dims is None:
        return [Finding("grid-semantics-declared", launch.name,
                        f"grid {grid} launched without declared dimension "
                        "semantics", (grid,))]
    if len(launch.dims) != len(grid):
        return [Finding("grid-semantics-declared", launch.name,
                        f"{len(launch.dims)} dimension semantics for a grid "
                        f"of rank {len(grid)}",
                        (len(launch.dims), len(grid)))]
    return [Finding("grid-semantics-declared", launch.name,
                    f"grid dim {d} declared {kind!r}: a CUDA grid runs its "
                    "blocks concurrently in no order, so every dim is "
                    "'independent'", (d, kind))
            for d, kind in enumerate(launch.dims) if kind not in DIM_KINDS]


def check_write_races(launch: KernelLaunch) -> list[Finding]:
    """Probe each output's tile map at block (0, 0, 0) and at a unit offset
    along every dim of size >= 2: the same tile means two concurrent blocks
    write it, a race unless that dim is one the output's writer is elected
    over (and the launch carries its election operand)."""
    findings = []
    if launch.dims is None:
        return findings
    base_ids = [0] * len(launch.grid)
    for oi, out in enumerate(launch.outputs):
        base = tuple(out.tile_of(*base_ids))
        for dim, size in enumerate(launch.grid):
            if size < 2:
                continue
            ids = list(base_ids)
            ids[dim] = 1
            if tuple(out.tile_of(*ids)) != base:
                continue
            if dim in out.elected_over and launch.election:
                continue                   # one writer, elected at run time
            why = ("an elected writer needs its election operand"
                   if dim in out.elected_over else
                   "give each block its own tile, or elect one writer per "
                   "tile (the split-KV partials + ticket design)")
            findings.append(Finding(
                "parallel-write-race", launch.name,
                f"grid dim {dim} (size {size}) does not reach output "
                f"{out.name!r}'s tile: two blocks write the same tile; "
                f"{why}", (dim, int(size), oi)))
    return findings


def check_smem(launch: KernelLaunch, *,
               budget_bytes: int = SMEM_BUDGET_BYTES) -> list[Finding]:
    total = launch.smem + launch.static_smem
    if total <= budget_bytes:
        return []
    return [Finding("smem-budget", launch.name,
                    f"{total} bytes of shared memory per block "
                    f"({launch.smem} dynamic + {launch.static_smem} static) "
                    f"exceed the {budget_bytes}-byte budget",
                    (total, budget_bytes))]


def check_index_operands(launch: KernelLaunch) -> list[Finding]:
    findings = []
    if len(launch.index_operands) != launch.n_index:
        findings.append(Finding(
            "index-operands", launch.name,
            f"launch passes {len(launch.index_operands)} index operands but "
            f"declares {launch.n_index}",
            (len(launch.index_operands), launch.n_index)))
    for name, shape, dtype in launch.index_operands:
        if dtype != "int32":
            findings.append(Finding(
                "index-operands", launch.name,
                f"index operand {name} {tuple(shape)} is {dtype}, not int32 "
                "— the blocks read it as int32 row and page indices",
                (name, tuple(shape), dtype)))
    return findings


KERNEL_CHECKS = (check_grid_semantics, check_write_races, check_smem,
                 check_index_operands)


def check_launch(launch: KernelLaunch, **kw) -> list[Finding]:
    """Run every launch contract check against one recorded plan."""
    findings = []
    for check in KERNEL_CHECKS:
        findings.extend(check(launch, **kw) if check is check_smem
                        else check(launch))
    return findings


# ----------------------------------------- the four serving kernels' plans --
def serving_launches(cfg, scfg, *, device="cpu") -> dict[str, KernelLaunch]:
    """Capture the decode + prefill kernel launches of one serve config at
    its real shapes (full fill: the capacity grid), without running them.
    Contiguous or paged follows ``scfg.paged_kv``, the KV dtype
    ``scfg.kv_cache_dtype``, the decode and prefill shards
    ``scfg.decode_kv_block`` / ``scfg.prefill_kv_block``: what the
    engine's steps launch."""
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_op, consmax_decode_paged_op)
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_op, consmax_prefill_paged_op)
    H, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b, L, c = scfg.max_slots, scfg.max_seq, scfg.prefill_chunk
    dev = torch.device(device)
    bf16 = torch.bfloat16
    beta = torch.linspace(0.5, 2.5, H, device=dev)
    gamma = torch.full((H,), 100.0, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    kw = dict(window=cfg.window, softcap=cfg.attn_softcap, scale=1.0,
              fill_bound=scfg.fill_bound)
    kv_dtype = CL.kv_cache_dtype(scfg.kv_cache_dtype)
    quant = CL.kv_quantized(kv_dtype)
    out: dict[str, KernelLaunch] = {}

    def grab(label, caught):
        assert len(caught) == 1, (label, len(caught))
        launch = caught[0]
        launch.name = label
        out[label] = launch

    if scfg.paged_kv:
        ps, P = scfg.page_size, scfg.num_pages
        npg = scfg.max_pages_per_slot
        pool = torch.zeros((P + 1, ps, hkv, d), dtype=kv_dtype, device=dev)
        spool = (dict(k_scale=torch.ones((P + 1, ps, hkv), device=dev),
                      v_scale=torch.ones((P + 1, ps, hkv), device=dev))
                 if quant else {})
        table = (torch.arange(b * npg, **i32) % P).reshape(b, npg)
        with capture_launches() as caught:
            consmax_decode_paged_op(
                torch.zeros((b, 1, H, d), dtype=bf16, device=dev), pool,
                pool, table, torch.full((b,), L, **i32), beta, gamma,
                bk=scfg.decode_kv_block, **kw, **spool)
        grab("decode_paged", caught)
        with capture_launches() as caught:
            consmax_prefill_paged_op(
                torch.zeros((1, c, H, d), dtype=bf16, device=dev), pool,
                pool, table[:1].contiguous(), torch.full((1,), L - c, **i32),
                torch.full((1,), c, **i32), beta, gamma,
                bk=scfg.prefill_kv_block, **kw, **spool)
        grab("prefill_paged", caught)
    else:
        cache = torch.zeros((b, L, hkv, d), dtype=kv_dtype, device=dev)
        scale = (dict(k_scale=torch.ones((b, L, hkv), device=dev),
                      v_scale=torch.ones((b, L, hkv), device=dev))
                 if quant else {})
        with capture_launches() as caught:
            consmax_decode_op(
                torch.zeros((b, 1, H, d), dtype=bf16, device=dev), cache,
                cache, torch.full((b,), L - 1, **i32), beta, gamma,
                bk=scfg.decode_kv_block, **kw, **scale)
        grab("decode_contiguous", caught)
        # the engine's static step: one chunk against the whole slot pool,
        # its slot a device operand
        with capture_launches() as caught:
            consmax_prefill_op(
                torch.zeros((1, c, H, d), dtype=bf16, device=dev), cache,
                cache, torch.full((1,), L - c, **i32),
                torch.full((1,), c, **i32), beta, gamma,
                bk=scfg.prefill_kv_block, slot=torch.full((1,), b - 1, **i32),
                **kw, **scale)
        grab("prefill_contiguous", caught)
    return out
