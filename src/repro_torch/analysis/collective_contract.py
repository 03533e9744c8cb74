"""Sharded-serving collective contract: the only cross-rank traffic a
serving step may carry is output-sized (the counterpart of the reference's
``analysis/collective_contract.py``).

The sharded engine's combine (``distributed/comm.AttentionMesh``) runs at
most two collectives per attention block, both sized like the attention
*output*, never like the KV cache:

* one fp32 all-reduce of the ConSmax partials over the ``seq`` ranks — the
  split-KV addition, ``rows * H_local * dk * 4`` bytes;
* one all-gather of the per-rank heads over the ``model`` ranks,
  ``rows * H * dk`` elements.

A cache-sized all-gather is a rank rematerializing the KV pool (what
sequence sharding exists to avoid), a cache-sized all-to-all a resharding
shuffle of pages, a cache-sized all-reduce a combine of something that
should have stayed local. The reference walks the compiled partitioned
HLO; every collective of the port goes through ``distributed/comm.Comm``,
which logs each call (kind, result shape, dtype, bytes; ``comm.calls()``),
so the ``sharded-collective-contract`` rule reads that log around a step
and fires one ``Finding`` per call at or above one shard's KV-cache bytes.
"""
from __future__ import annotations

from repro_torch.analysis.op_lint import Finding

RULE = "sharded-collective-contract"
KINDS = ("all_gather", "all_to_all", "all_reduce", "collective_permute")

CONTRACT_CATALOG = {
    RULE: "sharded steps move only output-sized collectives (the ConSmax "
          "partial all-reduce + the head all-gather) — no cache-sized "
          "all-gather/all-to-all/all-reduce",
}


def cache_bytes_per_shard(cfg, scfg) -> int:
    """Per-rank KV cache footprint in bytes — the contract threshold: the
    pool shards over KV heads (tp) and pages (seq_shards), so one rank holds
    ``cells / (tp * seq_shards)`` elements, 1 byte each for int8 / fp8
    codes, 2 for bf16 (a quantized pool's scales are smaller still)."""
    hkv_dk = cfg.n_kv_heads * cfg.head_dim_
    if scfg.paged_kv:
        cells = scfg.num_pages * scfg.page_size * hkv_dk
    else:
        cells = scfg.max_slots * scfg.max_seq * hkv_dk
    esize = 1 if scfg.kv_cache_dtype in ("int8", "fp8_e4m3") else 2
    return cells * esize // max(scfg.tp * scfg.seq_shards, 1)


def check_collectives(target: str, calls: list, *, cache_bytes: int,
                      group_size: int = 0) -> tuple[list[dict], list[Finding]]:
    """Inventory a step's collective calls (``comm.calls()`` records) and
    flag every one whose payload reaches ``cache_bytes``. Returns ``(ops,
    findings)``; each op has kind / bytes / shape / dtype / group size /
    multiplicity 1 (the port logs each call), as the reference's
    inventory does."""
    ops = [dict(kind=c["kind"], bytes=int(c["bytes"]),
                shape=list(c.get("shape", ())), dtype=c.get("dtype", ""),
                group_size=group_size, multiplicity=1) for c in calls]
    findings = [Finding(
        RULE, target,
        f"cache-sized {op['kind']}: {op['bytes']} bytes (threshold "
        f"{cache_bytes} = one shard's KV cache) — sharded serving must keep "
        "the cache resident and exchange only output-sized ConSmax "
        "partials", (op["kind"], op["bytes"], op["group_size"],
                     op["multiplicity"]))
        for op in ops if op["kind"] in KINDS and op["bytes"] >= cache_bytes]
    return ops, findings


def step_collective_bytes(ops: list[dict]) -> dict:
    """Aggregate an op inventory to per-step totals (multiplicity-weighted
    bytes by kind + overall)."""
    by_kind: dict[str, int] = {}
    for op in ops:
        by_kind[op["kind"]] = (by_kind.get(op["kind"], 0)
                               + op["bytes"] * max(op["multiplicity"], 1))
    return {"bytes_by_kind": by_kind, "total_bytes": sum(by_kind.values()),
            "count": len(ops)}
