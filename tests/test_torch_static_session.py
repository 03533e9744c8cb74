"""The static session's decode step: fixed tensors, one program per (batch
size, mode), the reference's tokens.

``ServeSession`` keeps, per batch size, one cache tree and fixed decode
inputs (the last tokens, the sampling bank), reset in place by each
``generate``; its decode step reads and writes only those, which is what
a graphed session captures as one CUDA graph per (b, argmax | draw |
logits). On the CPU (smoke configs, one thread; the session is eager
there):

* the aten ops that ``op_lint.record_ops`` records for the decode step are
  the same ops with the same shapes and dtypes at every step of a
  ``generate`` and across calls, per (b, mode): gpt2-consmax with the
  decode kernel (its plain version runs) and without it, and with logits
  out of the step (``fused_sampling=False``), softmax, xLSTM (logits mode:
  no attention cache) and jamba (Mamba, MoE and one attention block);
* every held cache leaf and input buffer keeps its ``data_ptr`` across
  steps, calls and batch sizes;
* calls in a row, with another batch size between them, give the tokens
  of fresh sessions, bit for bit;
* the tokens equal the reference's ``repro.serve.engine.ServeSession.
  generate`` on the same weights (``weights.from_jax_params``) and the
  same numpy-made whole prompts, greedy and sampled, two calls on one
  session: exactly, at fp32 compute, as tests/test_torch_session.py holds
  these archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ServeSession as JSession
from repro.serve.sampling import SamplingParams as JSP
from repro_torch.analysis import op_lint as OL
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ServeSession
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import from_jax_params, init_params

SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95, min_p=0.02, seed=7)
# (arch, config overrides, ServeConfig overrides)
CASES = {
    "gpt2-consmax-decode-kernel": ("gpt2-consmax", {},
                                   dict(decode_kernel=True,
                                        decode_kv_block=16)),
    "gpt2-consmax": ("gpt2-consmax", {}, {}),
    "gpt2-consmax-logits": ("gpt2-consmax", {}, dict(fused_sampling=False)),
    "gpt2-softmax": ("gpt2-consmax", dict(score_norm="softmax"), {}),
    "xlstm": ("xlstm-1.3b", {}, {}),
    "jamba": ("jamba-1.5-large-398b", {}, {}),
}
REFERENCE = ["gpt2-consmax-decode-kernel", "gpt2-consmax", "gpt2-softmax",
             "xlstm", "jamba"]
S_PROMPT, MAX_SEQ = 16, 32     # one chunk of the recurrent smoke scans


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, b, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, S_PROMPT)).astype(np.int32)


def _session(case, **kw):
    arch, over, serve = CASES[case]
    cfg = get_config(arch, smoke=True, **over)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    scfg = ServeConfig(max_seq=MAX_SEQ, score_norm=cfg.score_norm, **serve)
    return cfg, scfg, model


def _held_tensors(sess):
    """Every tensor a decode step reads or writes in place, per held
    batch shape."""
    out = {}
    for key, held in sess._held.items():
        ts = [t for sup in held.caches for blk in sup.values()
              for c in blk.values() for t in c.values()]
        out[key] = ts + [held.tok, *held.bank.values()]
    return out


def _ptrs(sess):
    return {key: [t.data_ptr() for t in ts]
            for key, ts in _held_tensors(sess).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_is_one_program_on_fixed_tensors(case):
    cfg, scfg, model = _session(case)
    sess = ServeSession(cfg, scfg, model, device="cpu")
    assert not sess.graphed
    seen, ptrs = {}, {}
    real = sess._decode_step

    def run(held, draw):
        mode = "logits" if not sess.fused else ("draw" if draw else "argmax")
        b = held.tok.shape[0]
        with OL.record_ops() as ops:
            out = real(held, draw)
        seen.setdefault((b, mode), []).append(ops)
        now = _ptrs(sess)
        for key, p in ptrs.items():
            assert now[key] == p, key
        ptrs.update(now)
        return out

    sess._decode_step = run
    calls = [(2, None, 1), (3, SamplingParams(**SAMPLED), 2),
             (2, SamplingParams(**SAMPLED), 3), (2, None, 4)]
    for b, sp, seed in calls:
        out = sess.generate(_prompts(cfg.vocab_size, b, seed), steps=4,
                            sampling=sp)
        assert out.shape == (b, 4) and out.dtype == torch.int32
    modes = ({"logits"} if not sess.fused else {"argmax", "draw"})
    assert {mode for _, mode in seen} == modes
    assert {b for b, _ in seen} == {2, 3}
    for key, runs in seen.items():
        # three decode steps per call; b 2 argmax ran in two calls
        assert len(runs) >= 3 and runs[0], key
        assert all(ops == runs[0] for ops in runs), key
    assert set(sess.held_cache_bytes) == {2, 3}
    assert sess.decode_graphs == sess.graph_replays == 0
    assert sess.graph_pool_bytes == 0 and sess.capture_seconds == {}
    assert sess.decode_steps == 3 * len(calls)


@pytest.mark.parametrize("case", list(CASES))
def test_calls_in_a_row_equal_fresh_sessions(case):
    cfg, scfg, model = _session(case)
    sess = ServeSession(cfg, scfg, model, device="cpu")
    calls = [(3, SamplingParams(**SAMPLED), 5), (1, None, 6),
             (3, None, 7), (3, SamplingParams(**SAMPLED), 5)]
    got = [sess.generate(_prompts(cfg.vocab_size, b, seed), steps=5,
                         sampling=sp) for b, sp, seed in calls]
    for (b, sp, seed), tokens in zip(calls, got):
        fresh = ServeSession(cfg, scfg, model, device="cpu").generate(
            _prompts(cfg.vocab_size, b, seed), steps=5, sampling=sp)
        assert torch.equal(tokens, fresh), (b, sp, seed)
    assert torch.equal(got[0], got[3])


@pytest.mark.parametrize("case", REFERENCE)
def test_session_tokens_match_reference(case):
    arch, over, serve = CASES[case]
    jc = jget(arch, smoke=True, compute_dtype="float32", **over)
    tc = get_config(arch, smoke=True, compute_dtype="float32", **over)
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    jsess = JSession(jc, JServeConfig(max_seq=MAX_SEQ, **serve), p)
    sess = ServeSession(tc, ServeConfig(max_seq=MAX_SEQ,
                                        score_norm=tc.score_norm, **serve),
                        model, device="cpu")
    toks = _prompts(jc.vocab_size, 3, 8)
    for kw, jkw in (({}, {}), (dict(sampling=SamplingParams(**SAMPLED)),
                               dict(sampling=JSP(**SAMPLED)))):
        ref = np.asarray(jsess.generate(jnp.asarray(toks), steps=6, **jkw))
        got = sess.generate(toks, steps=6, **kw)
        np.testing.assert_array_equal(got.numpy(), ref)
