"""The port's sampling against the reference's ``serve/sampling.py``, bit for
bit, and the sampled continuous engines against the reference engines.

* ``threefry2x32``: Random123's known-answer vectors and the reference's
  ``threefry_2x32`` on random words; the per-slot ``fold_in`` keys, the
  32-bit draws, the uniforms and the Gumbel noise equal ``jax.random``'s on
  a grid of seeds (0 to 2^32 - 1, across 2^31), positions and vocab sizes.
* ``apply_logits_masks`` + ``sample_tokens`` on batches that mix greedy and
  sampled rows: the reference's tokens.
* ``bank_of``: a broadcast ``SamplingParams`` gives row r the seed
  ``(seed + r) mod 2^32``; a per-row sequence keeps its seeds.
* Sampled engines (qwen2 and gpt2-consmax smoke configs, fp32 compute, where
  the two packages' logits agree to ~1e-6), contiguous and paged, fused and
  host-side: the reference engine's tokens; fused == host in the port; one
  prefill and one decode signature over a mixed-parameter run.
* A request's sampled stream does not depend on what else the engine
  serves (the reference's ``tests/test_sampling.py:238``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random
from jax._src import prng as jprng

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve import sampling as JS
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.serve import sampling as TS
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import from_jax_params, init_params

SEEDS = np.array([0, 1, 7, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1,
                  3_000_000_019], np.uint32)
POSITIONS = np.array([0, 1, 5, 511, 4096, 8191, 100_000, 2**31 - 1],
                     np.int32)


@pytest.fixture(autouse=True)
def _one_thread():
    """The draw is ~200 elementwise ops over (rows, vocab). Above torch's
    grain size each one opens an intra-op parallel region, and with several
    test workers sharing the machine's cores those regions spin: the 4099-
    vocab cases took 50-110 s instead of 1 s under the suite's load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a).astype(np.int64))


def _jkeys(seeds, positions):
    return jax.vmap(lambda s, p: random.fold_in(
        random.fold_in(random.key(0), s), p))(jnp.asarray(seeds),
                                              jnp.asarray(positions))


# ------------------------------------------------------------ threefry ----
def test_threefry_known_answers_and_reference():
    """Random123's threefry2x32_20 known answers (key, counter -> output),
    then the reference's ``threefry_2x32`` on random words."""
    kat = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
           ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
            (0x1CB996FC, 0xBB002BE7)),
           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
            (0xC4923A9C, 0x483DF7A0))]
    for key, ctr, out in kat:
        got = TS.threefry2x32(*(torch.tensor([w]) for w in key + ctr))
        assert tuple(int(w) for w in got) == out
    r = np.random.default_rng(0)
    words = r.integers(0, 2**32, (4, 64), dtype=np.uint64).astype(np.uint32)
    for i in range(8):
        key = words[:2, i]
        ref = np.asarray(jprng.threefry_2x32(
            jnp.asarray(key), jnp.asarray(np.concatenate(words[2:]))))
        x0, x1 = TS.threefry2x32(_t(key[0]), _t(key[1]), _t(words[2]),
                                 _t(words[3]))
        np.testing.assert_array_equal(np.concatenate([x0, x1]), ref)


@pytest.mark.parametrize("vocab", [1, 37, 1000, 4099])
def test_keys_bits_uniforms_and_gumbel_bit_equal_to_reference(vocab):
    seeds = np.tile(SEEDS, 2)
    positions = np.concatenate([POSITIONS, POSITIONS[::-1]])
    jk = _jkeys(seeds, positions)
    k0, k1 = TS.slot_keys(_t(seeds), torch.tensor(positions))
    np.testing.assert_array_equal(
        np.stack([k0.numpy(), k1.numpy()], 1), np.asarray(
            random.key_data(jk)))
    bits = TS.random_bits((k0, k1), vocab)
    jbits = jax.vmap(lambda k: random.bits(k, (vocab,), jnp.uint32))(jk)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    tiny = np.finfo(np.float32).tiny
    u = TS.uniform(bits)
    ju = jax.vmap(lambda k: random.uniform(k, (vocab,), jnp.float32,
                                           minval=tiny, maxval=1.0))(jk)
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  np.asarray(ju).view(np.int32))
    jg = jax.vmap(lambda k: random.gumbel(k, (vocab,), jnp.float32))(jk)
    np.testing.assert_array_equal(TS.gumbel(u).numpy().view(np.int32),
                                  np.asarray(jg).view(np.int32))


def test_gumbel_log_is_xla_cpu_log_bit_for_bit():
    """``_xla_log`` equals ``jnp.log`` on the CPU over the range the Gumbel
    transform feeds it: (0, 1) and (0, 88]."""
    r = np.random.default_rng(1)
    x = np.concatenate([r.random(50_000), r.random(50_000) * 88.0,
                        [np.finfo(np.float32).tiny, 0.5, 1.0, 2.0,
                         1 - 2**-24, 87.33654]]).astype(np.float32)
    x = x[x > 0]
    ref = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = TS._xla_log(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# ------------------------------------------------------------ epilogue ----
@pytest.mark.parametrize("vocab,seed", [(50, 0), (1000, 1), (4099, 2)])
def test_sample_tokens_mixed_rows_match_reference(vocab, seed):
    """Greedy and sampled rows side by side (every mask alone and stacked,
    a tie at the top, temperatures below and above 1, top_k 1), over 16
    positions each: the reference's tokens."""
    r = np.random.default_rng(seed)
    b = 8
    logits = (r.standard_normal((b, vocab)) * 3).astype(np.float32)
    logits[1, :2] = logits[1].max() + 0.5                   # a tie
    bank = dict(
        temperature=np.array([0, 0.7, 1.0, 1.3, 0.5, 2.0, 0.9, 6.0],
                             np.float32),
        top_k=np.array([0, 0, 5, 0, 50, 3, 0, 1], np.int32),
        top_p=np.array([1, 1, 0.9, 0.95, 1, 0.5, 0.8, 1], np.float32),
        min_p=np.array([0, 0, 0, 0.05, 0.01, 0, 0.1, 0], np.float32),
        seed=SEEDS)
    jb = {k: jnp.asarray(v) for k, v in bank.items()}
    tb = {k: torch.tensor(v.astype(np.int64) if k == "seed" else v)
          for k, v in bank.items()}
    jsample = jax.jit(JS.sample_tokens)          # as the fused steps run it
    for step in range(16):
        pos = (POSITIONS + step).astype(np.int32)
        ref = np.asarray(jsample(jnp.asarray(logits), jb, jnp.asarray(pos)))
        got = TS.sample_tokens(torch.tensor(logits), tb, torch.tensor(pos))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    # an all-greedy bank takes the first argmax of every row
    greedy = TS.sample_tokens(torch.tensor(logits), TS.bank_init(b),
                              torch.zeros(b, dtype=torch.int32))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_bank_of_broadcast_and_per_row_seeds():
    sp = TS.SamplingParams(temperature=0.8, top_k=4, seed=2**32 - 2)
    got = TS.bank_of(sp, 4)
    ref = JS.bank_of(JS.SamplingParams(temperature=0.8, top_k=4,
                                       seed=2**32 - 2), 4)
    assert got["seed"].tolist() == [2**32 - 2, 2**32 - 1, 0, 1]
    for name, dt in TS._FIELDS:
        assert got[name].dtype == dt
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))
    rows = [TS.SamplingParams(seed=5), TS.SamplingParams(temperature=1.0,
                                                         seed=5)]
    per_row = TS.bank_of(rows, 2)
    assert per_row["seed"].tolist() == [5, 5]
    assert per_row["temperature"].tolist() == [0.0, 1.0]
    assert TS.bank_of(None, 3)["temperature"].tolist() == [0.0] * 3
    with pytest.raises(ValueError, match="2 SamplingParams for 3 rows"):
        TS.bank_of(rows, 3)


# -------------------------------------------------------------- engines ----
SERVE = dict(max_seq=48, prefill_chunk=8, max_slots=3)
PAGED = dict(paged_kv=True, page_size=4, num_pages=30)
PROMPT_LENS = [5, 13, 3, 20, 9]
BUDGETS = [4, 6, 3, 5, 7]
SAMPLING = [None, dict(temperature=0.8, seed=3),
            dict(temperature=1.2, top_k=10, seed=2**31 + 1), None,
            dict(temperature=0.7, top_p=0.9, min_p=0.05, seed=11)]


def _prompts(vocab, lens, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).tolist() for n in lens]


def _serve(engine, make_sp, prompts=None):
    prompts = prompts or _prompts(engine.cfg.vocab_size, PROMPT_LENS)
    uids = [engine.submit(p, n, sampling=None if s is None else make_sp(**s))
            for p, n, s in zip(prompts, BUDGETS, SAMPLING)]
    results = engine.run(max_steps=500)
    return [results[u] for u in uids]


@pytest.mark.parametrize("arch,paged", [("qwen2-1.5b", False),
                                        ("qwen2-1.5b", True),
                                        ("gpt2-consmax", False)])
def test_sampled_engine_tokens_match_reference(arch, paged):
    """Mixed greedy and sampled requests through the port's engine, fused
    and host-side: the reference engine's tokens, and one prefill and one
    decode signature for each engine's lifetime."""
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    extra = PAGED if paged else {}
    ref = _serve(JEngine(jc, JServeConfig(**SERVE, **extra), p),
                 JS.SamplingParams)
    for fused in (True, False):
        eng = ContinuousBatchingEngine(
            tc, ServeConfig(**SERVE, **extra, fused_sampling=fused,
                            decode_kernel=paged, prefill_kernel=paged),
            model, device="cpu")
        assert _serve(eng, TS.SamplingParams) == ref, fused
        assert (eng.prefill_cache_size, eng.decode_cache_size) == (1, 1)
    assert [len(t) for t in ref] == BUDGETS


def test_same_seed_same_prompt_regardless_of_cohabitants():
    cfg = tget("qwen2-1.5b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    target = _prompts(cfg.vocab_size, [6], seed=43)[0]
    sp = TS.SamplingParams(temperature=1.2, top_k=7, seed=123)
    scfg = ServeConfig(max_seq=32, prefill_chunk=4, max_slots=2)
    alone = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
    uid = alone.submit(target, 5, sampling=sp)
    ref = alone.run(max_steps=200)[uid]
    busy = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
    fillers = [busy.submit(pr, mx, sampling=TS.SamplingParams(
        temperature=0.9, top_p=0.8, seed=500 + i))
        for i, (pr, mx) in enumerate(zip(
            _prompts(cfg.vocab_size, [9, 3, 7], seed=44), [4, 6, 3]))]
    uid2 = busy.submit(target, 5, sampling=sp)   # queued behind the fillers
    results = busy.run(max_steps=300)
    assert sorted(results) == sorted(fillers + [uid2])
    assert results[uid2] == ref
    assert (busy.prefill_cache_size, busy.decode_cache_size) == (1, 1)


def test_default_sampling_policy_and_n_streams():
    """``default_sampling`` is a policy (submit k draws from seed + k), and
    ``submit(n=K)`` gives stream i the seed + i: both equal the explicit
    seeds, and two streams of one prompt differ."""
    cfg = tget("gpt2-consmax", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    sp = TS.SamplingParams(temperature=1.4, top_k=40, seed=9)
    scfg = ServeConfig(max_seq=32, prefill_chunk=4, max_slots=2)
    pr = _prompts(cfg.vocab_size, [4], seed=47)[0]
    dflt = ContinuousBatchingEngine(cfg, scfg, model, device="cpu",
                                    default_sampling=sp)
    ua = [dflt.submit(pr, 6) for _ in range(2)]
    expl = ContinuousBatchingEngine(cfg, scfg, model, device="cpu")
    ub = expl.submit(pr, 6, sampling=sp, n=2)
    a, b = dflt.run(max_steps=100), expl.run(max_steps=100)
    assert [a[u] for u in ua] == [b[u] for u in ub]
    assert a[ua[0]] != a[ua[1]]
