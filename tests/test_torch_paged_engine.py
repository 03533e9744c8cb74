"""The port's paged continuous-batching engine: against the JAX reference's
paged engine, against its own contiguous engine, and through the prefix
cache, copy-on-write, ``submit(n=K)`` and pool pressure.

* Greedy tokens equal the reference's paged engine on the qwen2,
  gpt2-consmax, gemma2, chatglm3, granite, phi3.5-moe and grok smoke
  configs at ``compute_dtype="float32"`` (the two packages' logits agree
  to ~1e-6 there, gemma2's to ~2e-5: far from flipping a greedy token),
  with the port's kernel flags on and off (their plain versions on the
  CPU). The pool is smaller than ``max_slots x max_pages_per_slot``, so
  admission waits for released pages. The prompts share no prefix, which
  keeps this traffic clear of the reference's ``reserve_prefix`` admission
  fault (fixed only in the port's copy: ``tests/test_torch_scheduler.py``).
* At the bf16 serving default, paged tokens equal the port's contiguous
  engine's, with the kernel flags on and off.
* Warm vs cold (``tests/test_paged_kv.py:383``, greedy): the same tokens
  with the prefix cache on and off, and exactly the uncached rows
  prefilled.
* Copy-on-write under a live sharer (``tests/test_prefix_cache.py:89``),
  ``submit(n=2)`` sharing the prompt's pages (``:160``), and a pool that fits
  one request at a time (``tests/test_paged_kv.py:368``).
"""
import jax
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import from_jax_params, init_params

ARCHS = ["qwen2-1.5b", "gpt2-consmax", "gemma2-2b", "chatglm3-6b",
         "granite-3-2b", "phi3.5-moe-42b-a6.6b", "grok-1-314b"]
PROMPT_LENS = [5, 13, 3, 11, 7]
BUDGETS = [4, 6, 3, 5, 6]
# the reference's paged parity parameters (tests/test_paged_kv.py:324)
PAGED = dict(max_seq=48, prefill_chunk=4, max_slots=3, paged_kv=True,
             page_size=4, num_pages=14)


def _prompts(vocab, lens, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).tolist() for n in lens]


def _serve(engine, prompts, budgets):
    uids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    results = engine.run(max_steps=500)
    return [results[u] for u in uids]


def _port_model(arch, cd="float32", seed=1):
    cfg = tget(arch, smoke=True, compute_dtype=cd)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_greedy_tokens_match_reference_paged_engine(arch):
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    prompts = _prompts(jc.vocab_size, PROMPT_LENS)
    jeng = JEngine(jc, JServeConfig(**PAGED), p)
    ref = _serve(jeng, prompts, BUDGETS)
    assert jeng.pool.free_pages == PAGED["num_pages"]
    for kernels in (False, True):
        scfg = ServeConfig(**PAGED, decode_kernel=kernels,
                           prefill_kernel=kernels, decode_kv_block=16)
        assert scfg.num_pages < scfg.max_slots * scfg.max_pages_per_slot
        eng = ContinuousBatchingEngine(tc, scfg, model, device="cpu")
        assert _serve(eng, prompts, BUDGETS) == ref, kernels
        assert eng.pool.free_pages == scfg.num_pages     # all returned
        assert eng.prefill_cache_size == eng.decode_cache_size == 1
        assert eng.pool.peak_in_use <= scfg.num_pages
    assert [len(t) for t in ref] == BUDGETS


@pytest.mark.parametrize("kernels", [False, True])
def test_paged_tokens_equal_contiguous_tokens_at_bf16(kernels):
    cfg, model = _port_model("qwen2-1.5b", cd="bfloat16")
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS, seed=2)
    flags = dict(decode_kernel=kernels, prefill_kernel=kernels,
                 decode_kv_block=16)
    paged = _serve(ContinuousBatchingEngine(
        cfg, ServeConfig(**PAGED, **flags), model, device="cpu"),
        prompts, BUDGETS)
    cont = dict(PAGED, paged_kv=False)
    for key in ("page_size", "num_pages"):
        del cont[key]
    contiguous = _serve(ContinuousBatchingEngine(
        cfg, ServeConfig(**cont, **flags), model, device="cpu"),
        prompts, BUDGETS)
    assert paged == contiguous


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_vs_cold_greedy_streams_and_prefilled_tokens(arch):
    cfg, model = _port_model(arch)
    shared = _prompts(cfg.vocab_size, [12], seed=77)[0]   # 3 pages of 4
    tails = _prompts(cfg.vocab_size, [7, 4, 12], seed=80)

    def serve(prefix_cache):
        scfg = ServeConfig(max_seq=48, prefill_chunk=4, max_slots=1,
                           paged_kv=True, page_size=4, num_pages=24,
                           prefix_cache=prefix_cache, decode_kernel=True,
                           prefill_kernel=True)
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
        uids = [eng.submit(shared, 4)]                    # cold: seeds it
        uids += [eng.submit(shared + t, 4) for t in tails]
        uids.append(eng.submit(shared, 4))                # fully cached
        results = eng.run(max_steps=600)
        return [results[u] for u in uids], eng

    warm, weng = serve(True)
    cold, ceng = serve(False)
    assert warm == cold
    assert ceng.prefilled_tokens == 12 + 19 + 16 + 24 + 12
    assert weng.prefilled_tokens == 12 + 7 + 4 + 12 + 1
    assert weng.pool.prefix_hit_rows > 0 == ceng.pool.prefix_hit_rows
    assert weng.pool.free_pages == 24 and weng.pool.cached_pages > 0


def test_cow_under_a_live_sharer_keeps_streams_identical():
    cfg, model = _port_model("qwen2-1.5b")
    prompt = _prompts(cfg.vocab_size, [12], seed=5)[0]   # page-aligned

    def serve(prefix_cache):
        scfg = ServeConfig(max_seq=32, prefill_chunk=4, max_slots=2,
                           paged_kv=True, page_size=4, num_pages=16,
                           prefix_cache=prefix_cache, decode_kernel=True,
                           prefill_kernel=True)
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
        ua = eng.submit(prompt, 10)
        eng.run(max_steps=5)                   # A prefilled, now decoding
        ub = eng.submit(prompt, 6)             # same prompt, A still live
        res = eng.run(max_steps=400)
        return res[ua], res[ub], eng

    wa, wb, weng = serve(True)
    ca, cb, ceng = serve(False)
    assert wa == ca and wb == cb
    assert wb == wa[:6]                        # greedy: the same stream
    assert weng.pool.cow_copies >= 1 and ceng.pool.cow_copies == 0
    assert weng.prefilled_tokens == 12 + 1 < ceng.prefilled_tokens
    assert weng.pool.free_pages == 16
    assert set(weng.ttft) == {0, 1}


def test_submit_n_streams_share_the_prefilled_prompt():
    cfg, model = _port_model("qwen2-1.5b")
    prompt = _prompts(cfg.vocab_size, [12], seed=5)[0]
    scfg = ServeConfig(max_seq=32, prefill_chunk=4, max_slots=1,
                       paged_kv=True, page_size=4, num_pages=16)
    eng = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
    uids = eng.submit(prompt, 5, n=2)
    assert len(uids) == 2
    res = eng.run(max_steps=400)
    assert sorted(res) == sorted(uids)
    assert res[uids[0]] == res[uids[1]]        # greedy: identical streams
    assert eng.prefilled_tokens == 12 + 1      # one prefill + tail re-score
    with pytest.raises(ValueError, match="n must be"):
        eng.submit(prompt, 5, n=0)


def test_pool_pressure_serializes_admissions_but_serves_all():
    cfg, model = _port_model("qwen2-1.5b")
    scfg = ServeConfig(max_seq=16, prefill_chunk=4, max_slots=3,
                       paged_kv=True, page_size=4, num_pages=4,
                       decode_kernel=True, prefill_kernel=True)
    eng = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
    prompts = _prompts(cfg.vocab_size, [9, 8, 10], seed=40)
    uids = [eng.submit(p, 3) for p in prompts]
    results = eng.run(max_steps=400)
    assert sorted(results) == sorted(uids)
    assert all(len(results[u]) == 3 for u in uids)
    assert eng.pool.free_pages == 4 and eng.pool.peak_in_use <= 4
    assert eng.page_occupancy == 0.0 and eng.page_reserved == 0.0


@pytest.mark.parametrize("fill_bound", [True, False])
def test_paged_prefill_kv_block_tokens_match_reference_paged_engine(
        fill_bound):
    """The paged engine at ``prefill_kv_block=16`` with both kernels on,
    fill-bounded and capacity-swept: the reference paged engine's tokens at
    the same config (its Pallas kernels in interpret mode; its paged
    prefill kernel walks pages and reads no shard size, the port's walks
    the contiguous kernel's shards)."""
    jc = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    tc = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    kw = dict(PAGED, decode_kernel=True, prefill_kernel=True,
              decode_kv_block=16, prefill_kv_block=16, fill_bound=fill_bound)
    prompts = _prompts(jc.vocab_size, PROMPT_LENS[:3], seed=2)
    ref = _serve(JEngine(jc, JServeConfig(**kw), p), prompts, BUDGETS[:3])
    eng = ContinuousBatchingEngine(tc, ServeConfig(**kw), model,
                                   device="cpu")
    assert _serve(eng, prompts, BUDGETS[:3]) == ref
    assert eng.prefill_cache_size == eng.decode_cache_size == 1
