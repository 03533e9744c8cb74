"""Head_dim 96 and fp32 operands in the port's kernels, and the engine's
host-side sampling flag, against the JAX reference on the CPU.

* The operand checks take head_dim 96 for the six attention kernels and
  fp32 q / k / v for the two full-sequence kernels only (the serving
  kernels take bf16 queries and bf16 / int8 / fp8 caches, as in both
  packages' serving configs).
* The plain versions at dk 96 (what the wrappers compute on the CPU) match
  the reference's oracles: decode and prefill at fp32 (rtol / atol 1e-5),
  the full-sequence kernels at fp32 within the reference's fp32 atol 2e-5
  (``tests/test_kernels.py``).
* The phi-3-vision smoke config with its head_dim raised to 96 (its phi3
  backbone on the token frontend: neither package's continuous engine
  serves the stub patch frontend) is served with the kernel flags on,
  token-equal to the reference's engine with its flags on (Pallas in
  interpret mode), at fp32.
* ``sample_tokens`` with the engine's host flag gives the tokens it gives
  without, and its calls dispatch no ``_local_scalar_dense`` (the op
  lint's ``no-host-syncs``), where the flagless call dispatches one.
* The fp32 kernel's launch plan (``launch_plan.f32_plan``, captured from
  both wrappers) follows ``csrc/attn_f32.cuh``: a 1-D grid of row tiles x
  batch rows x KV heads whose blocks write distinct tiles covering every
  row, the layout's threads and dynamic shared memory, every launch
  contract met.
* The prefill kernels' launch plans over the KV-shard grid: grid (row tiles
  x ns, hkv, b) with ``cache_layout.prefill_shards``' ns, the fp32
  partials one tile per block, the output elected by the tickets over the
  shard dim when ns > 1 (one writer per row tile), the split grid's
  paired blocks (two consumer warpgroups, two shards each) at dk <= 128,
  ns = 1 with no partials and no election, contiguous and paged alike.
The card runs the CUDA kernels at dk 96 and on fp32 (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.kernels.consmax_attn.ref import consmax_attention_ref as jattn
from repro.kernels.consmax_decode.ref import consmax_decode_ref as jdecode
from repro.kernels.consmax_prefill.ref import consmax_prefill_ref as jprefill
from repro.kernels.softmax_attn.ref import softmax_attention_ref as jsoftmax
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.analysis.kernel_contracts import check_launch
from repro_torch.analysis.op_lint import record_ops, run_rules, StepTarget
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.kernels import _build
from repro_torch.kernels import launch_plan as LP
from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
from repro_torch.kernels.consmax_prefill.ops import (
    consmax_prefill_op, consmax_prefill_paged_op)
from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref
from repro_torch.kernels.softmax_attn.ops import softmax_attention_op
from repro_torch.serve import sampling as TS
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
F32_ATOL = 2e-5          # the reference's fp32 kernel tolerance


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(np.asarray(a, np.float32)).to(dtype) for a in arrays]


# ------------------------------------------------------- operand checks ----
def _serving_operands(dk, q_dtype=torch.bfloat16):
    q = torch.zeros((2, 1, 4, dk), dtype=q_dtype)
    k = torch.zeros((2, 64, 2, dk), dtype=torch.bfloat16)
    return q, k, k.clone()


@pytest.mark.parametrize("dk", [32, 64, 96, 128, 256])
def test_operand_checks_take_head_dim_96(dk):
    q, k, v = _serving_operands(dk)
    slots = {"index": torch.zeros(2, dtype=torch.int32)}
    heads = {"beta": torch.zeros(4), "gamma": torch.ones(4)}
    assert _build.check_operands("k", q, k, v, slots=slots,
                                 heads=heads) == 0
    seq = torch.zeros((1, 8, 4, dk))
    kv = torch.zeros((1, 8, 2, dk))
    for dt in (torch.bfloat16, torch.float32):
        _build.check_sequence_operands("k", seq.to(dt), kv.to(dt), kv.to(dt),
                                       heads=heads)


def test_operand_checks_refuse_other_head_dims_and_dtypes():
    heads = {"beta": torch.zeros(4), "gamma": torch.ones(4)}
    q, k, v = _serving_operands(80)
    with pytest.raises(ValueError, match="head_dim 80"):
        _build.check_operands("k", q, k, v, slots={}, heads=heads)
    q, k, v = _serving_operands(96, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):      # rows 1-4: bf16 q
        _build.check_operands("k", q, k, v, slots={}, heads=heads)
    seq = torch.zeros((1, 8, 4, 96))
    kv = torch.zeros((1, 8, 2, 96))
    for args in ((seq.half(), kv.half(), kv.half()),
                 (seq, kv.bfloat16(), kv.bfloat16())):
        with pytest.raises(TypeError, match="all bfloat16 or all float32"):
            _build.check_sequence_operands("k", *args, heads=heads)


# ------------------------------------------------ plain versions, dk 96 ----
def _heads(H, r):
    return (r.uniform(0.5, 2.5, H).astype(np.float32),
            np.full(H, 100.0, np.float32))


@pytest.mark.parametrize("H,hkv", [(8, 2), (4, 4)])
def test_decode_plain_version_at_dk96_matches_reference(H, hkv):
    r = np.random.default_rng(0)
    b, L, dk = 3, 80, 96
    q = r.standard_normal((b, H, dk)).astype(np.float32) * dk ** -0.5
    k = r.standard_normal((b, L, hkv, dk)).astype(np.float32)
    v = r.standard_normal((b, L, hkv, dk)).astype(np.float32)
    lengths = np.array([1, 37, 80], np.int32)
    beta, gamma = _heads(H, r)
    for kw in (dict(), dict(window=17, softcap=5.0), dict(merged=False)):
        ref = jdecode(jnp.asarray(q), jnp.asarray(k).swapaxes(1, 2),
                      jnp.asarray(v).swapaxes(1, 2), jnp.asarray(lengths),
                      jnp.asarray(beta), jnp.asarray(gamma), **kw)
        got = consmax_decode_ref(*_t(q, k, v), torch.tensor(lengths),
                                 *_t(beta, gamma), **kw)
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_prefill_plain_version_at_dk96_matches_reference():
    r = np.random.default_rng(1)
    b, c, L, H, hkv, dk = 2, 12, 70, 8, 2, 96
    q = r.standard_normal((b, c, H, dk)).astype(np.float32) * dk ** -0.5
    k = r.standard_normal((b, L, hkv, dk)).astype(np.float32)
    v = r.standard_normal((b, L, hkv, dk)).astype(np.float32)
    index = np.array([0, L - c], np.int32)
    lengths = np.array([c - 3, c], np.int32)
    beta, gamma = _heads(H, r)
    for kw in (dict(), dict(window=9, softcap=5.0), dict(merged=False)):
        ref = jprefill(*[jnp.asarray(a) for a in (q, k, v, index, lengths,
                                                   beta, gamma)], **kw)
        got = consmax_prefill_ref(*_t(q, k, v), torch.tensor(index),
                                  torch.tensor(lengths), *_t(beta, gamma),
                                  **kw)
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


@pytest.mark.parametrize("dk", [64, 96])
@pytest.mark.parametrize("variant", [dict(), dict(causal=False),
                                     dict(window=13, softcap=30.0)])
def test_fp32_attention_ops_match_reference(dk, variant):
    """The fp32 full-sequence ops (the plain versions on the CPU) against
    the reference's oracles, at the reference's fp32 tolerance."""
    r = np.random.default_rng(2)
    b, s, H, hkv = 2, 40, 4, 2
    q, k, v = (r.standard_normal((b, s, n, dk)).astype(np.float32)
               for n in (H, hkv, hkv))
    beta, gamma = _heads(H, r)
    jqkv = [jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)]
    ref = jattn(*jqkv, jnp.asarray(beta), jnp.asarray(gamma),
                **variant).swapaxes(1, 2)
    got = consmax_attention_op(*_t(q, k, v), *_t(beta, gamma), **variant)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=F32_ATOL)
    ref = jsoftmax(*jqkv, **variant).swapaxes(1, 2)
    got = softmax_attention_op(*_t(q, k, v), **variant)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=F32_ATOL)


# -------------------------------------------- phi-3-vision at head_dim 96 ----
SERVE = dict(max_seq=48, prefill_chunk=8, max_slots=3)


@pytest.mark.parametrize("paged", [False, True])
def test_phi3_vision_head_dim_96_serves_token_equal_to_reference(paged):
    over = dict(head_dim=96, frontend="tokens", compute_dtype="float32")
    jc = jget("phi-3-vision-4.2b", smoke=True, **over)
    tc = tget("phi-3-vision-4.2b", smoke=True, **over)
    assert tc.head_dim_ == jc.head_dim_ == 96
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    r = np.random.default_rng(3)
    prompts = [r.integers(0, jc.vocab_size, n).tolist() for n in (5, 13, 9)]
    budgets = [4, 3, 5]
    kw = dict(decode_kernel=True, prefill_kernel=True, decode_kv_block=16)
    if paged:
        kw.update(paged_kv=True, page_size=4)
    jeng = JEngine(jc, JServeConfig(**SERVE, **kw), p)
    teng = ContinuousBatchingEngine(tc, ServeConfig(**SERVE, **kw), model,
                                    device="cpu")
    outs = []
    for eng in (jeng, teng):
        uids = [eng.submit(pr, n) for pr, n in zip(prompts, budgets)]
        res = eng.run(max_steps=200)
        outs.append([list(map(int, res[u])) for u in uids])
    assert outs[1] == outs[0]
    assert [len(t) for t in outs[0]] == budgets
    assert teng.prefill_cache_size == teng.decode_cache_size == 1


# ------------------------------------------- the host-side sampling flag ----
def _syncs(ops):
    return run_rules(StepTarget("s", ops, device="cpu"))


def test_sample_tokens_host_flag_is_bit_equal_and_sync_free():
    r = np.random.default_rng(4)
    b, vocab = 6, 300
    logits = torch.tensor(r.standard_normal((b, vocab)), dtype=torch.float32)
    pos = torch.tensor(r.integers(0, 1000, b), dtype=torch.int32)
    mixed = TS.bank_of([SamplingParams(temperature=0.9 * (s % 2), top_k=20,
                                       seed=s) for s in range(b)], b)
    greedy = TS.bank_init(b)
    for bank, flag in ((mixed, True), (greedy, False)):
        with record_ops() as bare:
            want = TS.sample_tokens(logits, bank, pos)
        with record_ops() as flagged:
            got = TS.sample_tokens(logits, bank, pos, any_sampled=flag)
        assert torch.equal(got, want)
        assert not _syncs(flagged)
        assert {f.rule for f in _syncs(bare)} == {"no-host-syncs"}
    # the flag, not the bank, decides: an all-greedy answer skips the draw
    assert torch.equal(TS.sample_tokens(logits, mixed, pos,
                                        any_sampled=False),
                       torch.argmax(logits, -1).to(torch.int32))


def test_engine_flags_only_its_sampled_slots():
    cfg = tget("qwen2-1.5b", smoke=True)
    from repro_torch.weights import init_params
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousBatchingEngine(cfg, ServeConfig(**SERVE), model,
                                   device="cpu")
    a = eng.submit([1, 2, 3], 3, sampling=SamplingParams(temperature=0.8))
    g = eng.submit([4, 5], 6)
    eng.step()
    assert eng._sampled_slots == {0}
    eng.run(max_steps=50)
    assert eng._sampled_slots == set() and len(eng.results[a]) == 3
    assert len(eng.results[g]) == 6


# ------------------------------------------------ the fp32 kernel's plan ----
@pytest.mark.parametrize("dk", [32, 64, 96, 128, 256])
def test_fp32_plan_follows_the_kernel(dk):
    b, sq, skv, H, hkv = 2, 333, 100, 12, 2
    q = torch.zeros((b, sq, H, dk))
    kv = torch.zeros((b, skv, hkv, dk))
    with LP.capture() as plans:
        consmax_attention_op(q, kv, kv, torch.zeros(H), torch.ones(H))
        softmax_attention_op(q, kv, kv)
    rows = 64 if dk == 256 else 128
    keys = 32 if dk == 256 else 64
    base = 128 + rows * (dk + 16) * 4
    stage = keys * ((dk + 16) + (dk + 4)) * 4
    stages = 3 if base + 3 * stage <= _build.SMEM_PER_BLOCK else 2
    tiles = -(-sq * (H // hkv) // rows)
    for plan in plans:
        assert plan.kernel == "attn_f32_kernel"
        assert plan.grid == (tiles * b * hkv, 1, 1)
        assert plan.block == rows * 2 and plan.static_smem == 0
        assert plan.smem == base + stages * stage <= _build.SMEM_PER_BLOCK
        assert check_launch(plan) == []
        out = plan.outputs[0]
        written = {out.tile_of(bx, 0, 0) for bx in range(plan.grid[0])}
        assert written == {(i, j, t) for i in range(b) for j in range(hkv)
                           for t in range(tiles)}
        # the last row tiles are issued first
        assert out.tile_of(0, 0, 0)[2] == tiles - 1


# --------------------------------------------- the prefill kernels' plans ----
@pytest.mark.parametrize("dk", [64, 256])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("L, bk, ns", [(8192, 512, 16), (8192, 256, 32),
                                       (8192, 64, 64), (8192, 8192, 1),
                                       (200, 16, 4), (40, 512, 1),
                                       (65536, 512, 64)])
def test_prefill_plan_carries_the_shard_grid(L, bk, ns, paged, dk):
    b, c, H, hkv = 2, 40, 12, 2
    g, ps = H // hkv, 8
    q = torch.zeros((b, c, H, dk), dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    index, lengths = torch.zeros(b, **i32), torch.full((b,), c, **i32)
    beta, gamma = torch.zeros(H), torch.ones(H)
    with LP.capture() as plans:
        if paged:
            pool = torch.zeros((b * L // ps + 1, ps, hkv, dk),
                               dtype=torch.bfloat16)
            table = torch.arange(b * L // ps, **i32).reshape(b, L // ps)
            consmax_prefill_paged_op(q, pool, pool, table, index, lengths,
                                     beta, gamma, bk=bk)
        else:
            kv = torch.zeros((b, L, hkv, dk), dtype=torch.bfloat16)
            consmax_prefill_op(q, kv, kv, index, lengths, beta, gamma, bk=bk)
    (plan,) = plans
    rows, want_ns = CL.prefill_shards(L, bk)
    assert want_ns == ns and plan.layout["ns"] == ns
    assert plan.layout["shard_rows"] == rows
    consumers = 2 if dk <= 128 else 1      # on one K/V tile up to dk 128
    nr = -(-(c * g) // (64 * consumers))
    assert plan.grid == (nr * ns, hkv, b)
    assert plan.block == 128 * (consumers + 1)
    assert plan.layout["consumers"] == consumers
    assert check_launch(plan) == []
    out = plan.outputs[-1]
    tiles = {out.tile_of(bx, by, bz) for bx in range(plan.grid[0])
             for by in range(hkv) for bz in range(b)}
    assert tiles == {(i, j, t) for i in range(b) for j in range(hkv)
                     for t in range(nr)}
    if ns == 1:
        assert len(plan.outputs) == 1 and plan.election is None
        assert out.elected_over == () and plan.scratch_bytes == 0
        return
    partials, out = plan.outputs
    assert partials.shape == (b, hkv, ns, c * g, dk)
    assert partials.dtype == "float32"
    assert plan.scratch_bytes == b * hkv * ns * c * g * dk * 4
    assert plan.election == "tickets" and out.elected_over == (0,)
    parts = [partials.tile_of(bx, by, bz) for bx in range(plan.grid[0])
             for by in range(hkv) for bz in range(b)]
    assert len(set(parts)) == len(parts)       # one writer per partial


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8,
                                      torch.float8_e4m3fn])
@pytest.mark.parametrize("dk", list(_build.HEAD_DIMS))
def test_walk_plan_reckons_every_instantiation(dk, kv_dtype):
    """Every mainloop instantiation's block and shared memory, reckoned
    here from the layout (attn_mainloop.cuh WalkLayout): two consumer
    warpgroups on each K/V tile up to dk 128, one at 256, plus the
    producer; 128 bytes of mbarriers, a 64-row bf16 Q tile per consumer,
    three stages of bf16 K and V tiles (two at dk 256 with codes) and, for
    codes, a staging slot per stage (rows padded by 16 below dk 256, two
    fp32 row scales); within a block's 232,448 bytes. The prefill plan
    and, at bf16, both full-sequence plans carry it."""
    b, c, H, hkv, L = 1, 100, 8, 2, 512
    consumers = 2 if dk <= 128 else 1
    quant = kv_dtype != torch.bfloat16
    stages = 2 if dk == 256 and quant else 3
    code_slot = 2 * 64 * (dk + (16 if dk < 256 else 0)) + 2 * 64 * 4
    smem = (128 + consumers * 64 * dk * 2 + stages * 2 * 64 * dk * 2
            + (stages * code_slot if quant else 0))
    assert smem <= _build.SMEM_PER_BLOCK
    q = torch.zeros((b, c, H, dk), dtype=torch.bfloat16)
    kv = torch.zeros((b, L, hkv, dk), dtype=kv_dtype)
    scales = (dict(k_scale=torch.ones((b, L, hkv)),
                   v_scale=torch.ones((b, L, hkv))) if quant else {})
    i32 = dict(dtype=torch.int32)
    with LP.capture() as plans:
        consmax_prefill_op(q, kv, kv, torch.zeros(b, **i32),
                           torch.full((b,), c, **i32), torch.zeros(H),
                           torch.ones(H), bk=128, **scales)
        if not quant:
            consmax_attention_op(q, kv, kv, torch.zeros(H), torch.ones(H))
            softmax_attention_op(q, kv, kv)
    rows = 64 * consumers
    for plan in plans:
        assert plan.block == 128 * (consumers + 1)
        assert plan.smem == smem == LP.walk_smem_bytes(dk, quant, consumers)
        assert plan.layout["consumers"] == consumers
        assert plan.grid[0] == -(-(c * H // hkv) // rows) * plan.layout["ns"]
        assert check_launch(plan) == []
