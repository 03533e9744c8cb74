"""The port's sharded serving (``distributed/serve_mesh``) on gloo ranks over
the CPU: the reference's A/B matrix (``tests/test_sharded_serving.py``),
cut to fit the suite's time.

* Tokens: three requests sampled at temperature 0.8, top_k 40, seed 7 (the
  reference's geometry and traffic) on the qwen2-1.5b, gemma2-2b and
  grok-1-314b smoke configs with ``n_kv_heads=4``, at fp32 compute (the two
  packages' logits agree to ~1e-6 there, far from flipping a draw).
  Contiguous bf16 caches at tp 2; paged bf16 and paged int8 caches at
  (tp, seq_shards) = (2, 2), paged bf16 also at (2, 1) and (1, 4). On
  every rank, the mesh engine's tokens are EQUAL (plain int lists) to the
  port's single-device engine's and to the reference's single-device
  ``ContinuousBatchingEngine``'s on the same weights, with one prefill and
  one decode signature per rank. Every request stays inside one seq block
  (max_seq 128 over 4 ranks: 32 rows), where the combine adds exact zeros.
* A request longer than one seq block spills across ranks and still
  serves (``test_seq_block_spill_still_serves``).
* The collectives per model step: one fp32 all-reduce over ``seq`` and one
  all-gather over ``model`` per attention layer, output-sized.
* ``plan_mesh`` / ``ServeConfig`` refuse what the reference refuses, and
  the page-ownership helpers equal the reference's on the same tables.

One spawn per world size (2 and 4 ranks) runs all of its cases.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.kernels import cache_layout as JCL
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.sampling import SamplingParams as JSamplingParams
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.distributed import serve_mesh as SM
from repro_torch.kernels import cache_layout as CL
from repro_torch.serve.engine import ServeSession
from repro_torch.weights import from_jax_params
from torch_mesh_worker import spawn

ARCHS = ("qwen2-1.5b", "gemma2-2b", "grok-1-314b")
OVER = dict(n_kv_heads=4, compute_dtype="float32")
# the reference's geometry (tests/test_sharded_serving.py:48)
CONTIG = dict(max_seq=64, prefill_chunk=8, max_slots=3, decode_kernel=True,
              decode_kv_block=16)
PAGED = dict(max_seq=128, prefill_chunk=8, max_slots=3, paged_kv=True,
             page_size=8, num_pages=64, decode_kernel=True,
             decode_kv_block=16, prefill_kernel=True, prefill_kv_block=16)
CACHES = {"contig-bf16": CONTIG, "paged-bf16": PAGED,
          "paged-int8": dict(PAGED, kv_cache_dtype="int8")}
# world size -> (arch, cache, tp, seq_shards) cases of that spawn
MATRIX = {
    2: [(a, "contig-bf16", 2, 1) for a in ARCHS]
       + [("qwen2-1.5b", "paged-bf16", 2, 1)],
    4: [(a, c, 2, 2) for a in ARCHS for c in ("paged-bf16", "paged-int8")]
       + [("qwen2-1.5b", "paged-bf16", 1, 4)],
}
BUDGETS = [4, 6, 5]
SPILL_PROMPT, SPILL_NEW = 40, 8   # 48 rows = 6 pages: blocks 0 and 1 of 4


def _case_id(arch, cache, tp, ns):
    return f"{arch}-{cache}-{tp}x{ns}"


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    cfg = jget(arch, smoke=True, **OVER)
    return cfg, JT.lm_init(Ctx(random.key(0)), cfg)


def _prompts(vocab):
    return [list(map(int, random.randint(random.key(i + 10), (n,), 0,
                                         vocab)))
            for i, n in enumerate([5, 9, 12])]


@functools.lru_cache(maxsize=None)
def _reference_tokens(arch, cache):
    cfg, p = _jax_model(arch)
    scfg = dict(CACHES[cache])
    if scfg.get("paged_kv"):
        scfg["prefill_kv_block"] = 16
    eng = JEngine(cfg, JServeConfig(**scfg), p,
                  default_sampling=JSamplingParams(temperature=0.8, top_k=40,
                                                   seed=7))
    uids = [eng.submit(pr, n) for pr, n in zip(_prompts(cfg.vocab_size),
                                                BUDGETS)]
    res = eng.run(max_steps=300)
    return [res[u] for u in uids]


def _weights(tmp, arch):
    path = tmp / f"{arch}.pt"
    if not path.exists():
        cfg, p = _jax_model(arch)
        model = from_jax_params(jax.tree.map(np.asarray, p),
                                tget(arch, smoke=True, **OVER), device="cpu")
        torch.save(model.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    runs = {}
    for world, cases in MATRIX.items():
        specs = []
        for arch, cache, tp, ns in cases:
            cfg, _ = _jax_model(arch)
            specs.append(dict(id=_case_id(arch, cache, tp, ns), arch=arch,
                              over=OVER, weights=_weights(tmp, arch),
                              serve=CACHES[cache], tp=tp, ns=ns,
                              prompts=_prompts(cfg.vocab_size),
                              budgets=BUDGETS))
        args = dict(cases=specs)
        if world == 4:
            cfg, _ = _jax_model("qwen2-1.5b")
            prompt = list(map(int, random.randint(
                random.key(3), (SPILL_PROMPT,), 0, cfg.vocab_size)))
            args["cases"].append(dict(
                id="spill", arch="qwen2-1.5b", over=OVER,
                weights=_weights(tmp, "qwen2-1.5b"), serve=PAGED, tp=1,
                ns=4, prompts=[prompt], budgets=[SPILL_NEW], single=False))
        runs[world] = spawn("serve", world, args, tmp)
    return runs


@pytest.mark.parametrize(
    "world,arch,cache,tp,ns",
    [pytest.param(w, *c, id=_case_id(*c)) for w, cs in MATRIX.items()
     for c in cs])
def test_sharded_tokens_equal_single_device_and_reference(
        mesh_runs, world, arch, cache, tp, ns):
    """On every rank: mesh tokens == the port's single-device engine's ==
    the reference's single-device engine's, as plain int lists; one prefill
    and one decode signature per rank."""
    results = mesh_runs[world]
    key = _case_id(arch, cache, tp, ns)
    single = results[0][key + "/single"]
    ref = _reference_tokens(arch, cache)
    assert single["tokens"] == ref
    for rank, res in enumerate(results):
        assert res[key]["tokens"] == ref, rank
        assert res[key]["signatures"] == [1, 1], rank


@pytest.mark.parametrize("world", sorted(MATRIX))
def test_collectives_per_step(mesh_runs, world):
    """Each attention layer of each model step: one fp32 all-reduce over
    ``seq`` of the rank's (rows, H/tp, dk) output and one all-gather of the
    heads over ``model`` (in the compute dtype: fp32 here, half that at
    bf16), nothing else; every rank ran the same. The bytes are the
    rows the steps carried (a prefill chunk's 8, a decode step's 3 slots)
    times one row's."""
    for arch, cache, tp, ns in MATRIX[world]:
        key = _case_id(arch, cache, tp, ns)
        cfg = tget(arch, smoke=True, **OVER)
        per_rank = [res[key]["collectives"] for res in mesh_runs[world]]
        assert all(c == per_rank[0] for c in per_rank)
        c, steps = per_rank[0], mesh_runs[world][0][key]["steps"]
        calls = steps * cfg.n_layers
        assert c["all_to_all"]["calls"] == 0
        assert c["all_reduce"]["calls"] == (calls if ns > 1 else 0)
        assert c["all_gather"]["calls"] == (calls if tp > 1 else 0)
        row = cfg.n_heads * cfg.head_dim_ * 4       # one row, all heads
        rows = (c["all_gather"]["bytes"] // row if tp > 1
                else c["all_reduce"]["bytes"] // row)
        assert 3 * calls <= rows <= 8 * calls
        if tp > 1:
            assert c["all_gather"]["bytes"] == rows * row
        if ns > 1:
            assert c["all_reduce"]["bytes"] == rows * row // tp


def test_seq_block_spill_still_serves(mesh_runs):
    """A 40-token prompt + 8 new tokens (6 pages of 8 rows) outgrows the 4
    pages of one seq block at seq_shards 4: its pages spill onto ranks 0 and
    1, and it still serves, one signature each, on every rank alike. Its
    tokens are not gated against single-device serving (the spilled rows'
    fp32 sums regroup per rank)."""
    results = mesh_runs[4]
    first = results[0]["spill"]["tokens"]
    assert len(first[0]) == SPILL_NEW
    for res in results:
        assert res["spill"]["tokens"] == first
        assert res["spill"]["signatures"] == [1, 1]


def test_plan_mesh_validation():
    cfg = tget("qwen2-1.5b", smoke=True, **OVER)
    with pytest.raises(ValueError, match="divide n_heads"):
        SM.plan_mesh(cfg, ServeConfig(max_seq=64, tp=3))
    with pytest.raises(ValueError, match="consmax"):
        SM.plan_mesh(cfg.replace(score_norm="softmax"),
                     ServeConfig(max_seq=64, tp=2))
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        SM.plan_mesh(cfg, ServeConfig(max_seq=64, tp=2))
    assert SM.plan_mesh(cfg, ServeConfig(max_seq=64)) is None
    with pytest.raises(NotImplementedError, match="never builds a mesh"):
        ServeSession(cfg, ServeConfig(max_seq=64, tp=2), None, device="cpu")


def test_serve_config_mesh_validation():
    """The reference's test_serve_config_mesh_validation, on the port's
    ServeConfig."""
    with pytest.raises(ValueError, match="requires paged_kv"):
        ServeConfig(max_seq=64, seq_shards=2)
    with pytest.raises(ValueError, match="requires fill_bound"):
        ServeConfig(max_seq=64, paged_kv=True, page_size=8, num_pages=16,
                    seq_shards=2, fill_bound=False)
    with pytest.raises(ValueError, match="divide num_pages"):
        ServeConfig(max_seq=64, paged_kv=True, page_size=8, num_pages=10,
                    seq_shards=4)
    with pytest.raises(ValueError, match="must be >= 1"):
        ServeConfig(max_seq=64, tp=0)
    auto = ServeConfig(max_seq=64, paged_kv=True, page_size=8, max_slots=4,
                       seq_shards=2)
    assert auto.num_pages == 32 and auto.mesh_shape == (1, 2)


def test_page_ownership_helpers_match_reference():
    """localize_page_table, page_shard and position_shard equal the
    reference's on the same tables (tests/test_sharded_serving.py:276)."""
    rng = np.random.default_rng(0)
    tables = [np.array([[0, 3, 4, -1], [7, 2, -1, -1]], np.int32),
              rng.integers(-1, 16, (3, 8)).astype(np.int32)]
    for table in tables:
        for shard, pps in [(0, 8), (0, 4), (1, 4), (2, 4), (3, 4), (1, 8)]:
            got = CL.localize_page_table(torch.from_numpy(table), shard, pps)
            ref = np.asarray(JCL.localize_page_table(table, shard, pps))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), ref)
    for pos in range(10):
        assert (CL.position_shard(pos, 4, 2)
                == JCL.position_shard(pos, 4, 2))
        assert CL.page_shard(pos, 3) == JCL.page_shard(pos, 3)
