"""The port's static engine (``ServeSession``), ``write_slot`` and the CLI's
sampling seed, against the JAX reference.

* ``ServeSession.generate`` — whole prompts and right-padded ragged prompts
  (``lengths=``), fused and host-side sampling, greedy and sampled (a
  broadcast ``SamplingParams``, a per-row sequence, the legacy
  ``temperature`` / ``seed`` scalars): the reference session's tokens on the
  qwen2 and gemma2 smoke configs at fp32 compute; row r of a ragged batch
  equals prompt r served alone; broadcast rows draw independent streams.
* The recurrent archs (jamba: Mamba + MoE + one attention block; xlstm: no
  attention at all): the reference session's tokens, whole prompts, greedy
  and sampled. jamba samples in the steps; xlstm on the host whatever
  ``fused_sampling`` says (no attention cache to fold the keys on), as in
  the reference.
* The refusals: ``steps < 1`` and paged KV, with the reference's messages;
  and, as the reference: ragged prompts on an arch with recurrent state,
  generation from the stub vlm / audio frontends, the continuous engine for
  recurrent, cross-attention or stub-frontend archs, and fused sampling in
  ``make_serve_fns`` without a token frontend or an attention block.
* ``write_slot`` — the index set to the real length, the rows past it
  zeroed, a shorter bucket written as a prefix: the reference's caches.
* ``launch/serve.py --seed`` is the sampling seed (request i on seed + i):
  greedy runs give equal tokens whatever the seed, sampled runs differ.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.kernels import cache_layout as JCL
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ServeSession as JSession
from repro.serve.sampling import SamplingParams as JSP
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeSession
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import from_jax_params, init_params

SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95, min_p=0.02, seed=7)


def _pair(arch):
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc,
                                      device="cpu")


def _batch(vocab, lens, width, seed=0):
    """Right-padded (b, width) prompts of real lengths ``lens``."""
    r = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = r.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
@pytest.mark.parametrize("fused", [True, False])
def test_session_tokens_match_reference(arch, fused):
    jc, tc, p, model = _pair(arch)
    toks, lens = _batch(jc.vocab_size, [9, 4, 6], 9)
    jsess = JSession(jc, JServeConfig(max_seq=24, fused_sampling=fused), p)
    sess = ServeSession(tc, ServeConfig(max_seq=24, fused_sampling=fused),
                        model, device="cpu")
    rows = [SamplingParams(), SamplingParams(temperature=1.1, seed=4),
            SamplingParams(temperature=0.7, top_p=0.8, seed=2**32 - 1)]
    cases = [(dict(sampling=SamplingParams(**SAMPLED)),
              dict(sampling=JSP(**SAMPLED))),
             (dict(temperature=1.3, seed=2**31), dict(temperature=1.3,
                                                      seed=2**31)),
             (dict(sampling=rows), dict(sampling=[JSP(**vars(sp))
                                                  for sp in rows])),
             ({}, {})]
    # the reference's host path samples eagerly (slow on the CPU): the
    # broadcast and per-row banks only
    for kw, jkw in (cases if fused else cases[::2]):
        for lengths in (None, lens):
            ref = np.asarray(jsess.generate(
                jnp.asarray(toks), steps=5, **jkw,
                lengths=None if lengths is None else jnp.asarray(lengths)))
            got = sess.generate(toks, steps=5, lengths=lengths, **kw)
            assert got.dtype == torch.int32 and got.shape == (3, 5)
            np.testing.assert_array_equal(got.numpy(), ref)


def test_ragged_rows_equal_prompts_served_alone():
    """Row r of a right-padded ragged batch == prompt r alone, sampled and
    greedy; and the session's greedy tokens == the continuous engine's."""
    cfg = tget("qwen2-1.5b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    sess = ServeSession(cfg, ServeConfig(max_seq=32), model, device="cpu")
    toks, lens = _batch(cfg.vocab_size, [7, 3, 5], 7, seed=3)
    for sp in (SamplingParams(), SamplingParams(temperature=1.2, seed=40)):
        batch = sess.generate(toks, steps=6, lengths=lens, sampling=sp)
        for r, n in enumerate(lens):
            alone = sess.generate(toks[r:r + 1, :n], steps=6,
                                  sampling=SamplingParams(
                                      **{**vars(sp), "seed": sp.seed + r}))
            assert batch[r].tolist() == alone[0].tolist(), (sp, r)
    eng = ContinuousBatchingEngine(cfg, ServeConfig(
        max_seq=32, prefill_chunk=4, max_slots=2), model, device="cpu")
    uids = [eng.submit(toks[r, :n].tolist(), 6) for r, n in enumerate(lens)]
    results = eng.run(max_steps=200)
    greedy = sess.generate(toks, steps=6, lengths=lens)
    assert [results[u] for u in uids] == greedy.tolist()


def test_broadcast_rows_draw_independent_streams():
    cfg = tget("gpt2-consmax", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    sess = ServeSession(cfg, ServeConfig(max_seq=32), model, device="cpu")
    pr = np.random.default_rng(48).integers(0, cfg.vocab_size, 5)
    batch = np.stack([pr, pr]).astype(np.int32)
    sp = SamplingParams(temperature=2.0, seed=3)
    broad = sess.generate(batch, steps=6, sampling=sp)
    assert broad[0].tolist() != broad[1].tolist()
    pinned = sess.generate(batch, steps=6, sampling=[sp, sp])
    assert pinned[0].tolist() == pinned[1].tolist()


@pytest.mark.parametrize("prefill_kernel", [False, True])
def test_session_prefill_kv_block_matches_reference(prefill_kernel):
    """``ServeSession`` at ``prefill_kv_block=64``: the ragged prefill goes
    through the append path (with the prefill kernel, whose shard size it
    passes on) and gives the reference session's tokens at the same
    config."""
    jc, tc, p, model = _pair("qwen2-1.5b")
    kw = dict(max_seq=24, prefill_kernel=prefill_kernel,
              prefill_kv_block=64)
    toks, lens = _batch(jc.vocab_size, [9, 4, 6], 9, seed=3)
    ref = np.asarray(JSession(jc, JServeConfig(**kw), p).generate(
        jnp.asarray(toks), steps=5, lengths=jnp.asarray(lens)))
    got = ServeSession(tc, ServeConfig(**kw), model, device="cpu").generate(
        toks, steps=5, lengths=lens)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
@pytest.mark.parametrize("fused", [True, False])
def test_recurrent_session_tokens_match_reference(arch, fused):
    """Whole 16-token prompts (one chunk of the smoke's scans), 6 steps."""
    jc, tc, p, model = _pair(arch)
    toks, _ = _batch(jc.vocab_size, [16, 16, 16], 16, seed=8)
    jsess = JSession(jc, JServeConfig(max_seq=24, fused_sampling=fused), p)
    sess = ServeSession(tc, ServeConfig(max_seq=24, fused_sampling=fused),
                        model, device="cpu")
    assert sess.fused == jsess._fused == (fused and arch != "xlstm-1.3b")
    for kw, jkw in (({}, {}), (dict(sampling=SamplingParams(**SAMPLED)),
                               dict(sampling=JSP(**SAMPLED)))):
        ref = np.asarray(jsess.generate(jnp.asarray(toks), steps=6, **jkw))
        got = sess.generate(toks, steps=6, **kw)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_arch_refusals_match_reference():
    from repro.serve.engine import ContinuousBatchingEngine as JEngine
    from repro.serve.engine import make_serve_fns as jfns
    from repro_torch.serve.engine import make_serve_fns as tfns
    for arch in ("jamba-1.5-large-398b", "xlstm-1.3b", "musicgen-large",
                 "phi-3-vision-4.2b"):
        jc, tc, p, model = _pair(arch)
        scfg, jscfg = ServeConfig(max_seq=32), JServeConfig(max_seq=32)
        with pytest.raises(NotImplementedError):
            JEngine(jc, jscfg, p)
        with pytest.raises(NotImplementedError):
            ContinuousBatchingEngine(tc, scfg, model, device="cpu")
        has_attn = arch != "xlstm-1.3b"
        tokens = jc.frontend == "tokens"
        for fns, c, kw in ((jfns, jc, {}), (tfns, tc, dict(device="cpu"))):
            if tokens and has_attn:
                fns(c, jscfg if fns is jfns else scfg, **kw)
            else:
                with pytest.raises(ValueError, match="fused_sampling"):
                    fns(c, jscfg if fns is jfns else scfg, **kw)
        toks, lens = _batch(jc.vocab_size, [16, 8], 16)
        jsess = JSession(jc, jscfg, p)
        sess = ServeSession(tc, scfg, model, device="cpu")
        if not tokens:
            with pytest.raises(NotImplementedError, match="embedding"):
                jsess.generate(jnp.asarray(toks), steps=2)
            with pytest.raises(NotImplementedError, match="embedding"):
                sess.generate(toks, steps=2)
            continue
        with pytest.raises(NotImplementedError, match="ragged"):
            jsess.generate(jnp.asarray(toks), steps=2,
                           lengths=jnp.asarray(lens))
        with pytest.raises(NotImplementedError, match="ragged"):
            sess.generate(toks, steps=2, lengths=lens)


def test_session_refusals():
    cfg = tget("qwen2-1.5b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sess = ServeSession(cfg, ServeConfig(max_seq=32), model, device="cpu")
    with pytest.raises(ValueError, match=re.escape(
            "generate: steps must be >= 1, got 0")):
        sess.generate(np.zeros((1, 4), np.int32), steps=0)
    with pytest.raises(NotImplementedError, match="ServeSession is the "
                       "static contiguous baseline"):
        ServeSession(cfg, ServeConfig(max_seq=32, paged_kv=True,
                                      page_size=4), model, device="cpu")
    for kw in (dict(batch=4), dict(tp=2), dict(page_size=4)):
        with pytest.raises(NotImplementedError):
            ServeSession(cfg, ServeConfig(max_seq=32, **kw), model,
                         device="cpu")
    with pytest.raises(ValueError, match="score_norm='consmax'"):
        ServeSession(tget("qwen2-1.5b", smoke=True, score_norm="softmax"),
                     ServeConfig(max_seq=32, decode_kernel=True), model,
                     device="cpu")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_write_slot_matches_reference(kv):
    """A 10-row batch-1 cache written into slot 2 of a 16-row pool at real
    length 6: index 6, rows 6-9 zeroed (K/V and scales), rows 10-15 and the
    other slots untouched."""
    tc = tget("qwen2-1.5b", smoke=True)
    r = np.random.default_rng(0)
    one = TT.init_caches(tc, 1, 10, kv, device="cpu")
    big = TT.init_caches(tc, 3, 16, kv, device="cpu")
    for sup in one + big:
        for blk in sup.values():
            for key, t in blk["attn"].items():
                if key != "index":
                    t.copy_(torch.tensor(r.standard_normal(t.shape)))
    jtree = {}
    for which, tree in (("one", one), ("big", big)):
        jtree[which] = {name: {"attn": {
            key: jnp.asarray(np.stack([
                (sup[name]["attn"][key].float() if key != "index" else
                 sup[name]["attn"][key]).numpy() for sup in tree])).astype(
                JCL.kv_cache_dtype(kv) if key in ("k", "v") else
                (jnp.int32 if key == "index" else jnp.float32))
            for key in tree[0][name]["attn"]}} for name in tree[0]}
    ref = JT.write_slot(jtree["big"], jtree["one"], 2, 6)
    TT.write_slot(big, one, 2, 6)
    for i, sup in enumerate(big):
        for name, blk in sup.items():
            for key, t in blk["attn"].items():
                want = np.asarray(ref[name]["attn"][key][i]).astype(
                    np.float32)
                np.testing.assert_array_equal(t.float().numpy(), want,
                                              err_msg=f"{name}/{key}")
    assert TT.cache_index(big).tolist() == [0, 0, 6]


def _cli_tokens(capsys, *args):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", "gpt2-consmax", "--prompt-len", "6",
          "--steps", "5", *args])
    out = capsys.readouterr().out
    return [line for line in out.splitlines() if "sample:" in line]


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_cli_seed_is_the_sampling_seed(capsys, engine):
    """Weights and prompts come from fixed seeds: greedy tokens do not move
    with ``--seed``; sampled tokens do."""
    kw = ["--engine", engine, "--batch", "2", "--requests", "3",
          "--max-slots", "2", "--prefill-chunk", "4"]
    greedy = [_cli_tokens(capsys, *kw, "--seed", s) for s in ("0", "11")]
    assert greedy[0] == greedy[1] and greedy[0]
    hot = ["--temperature", "1.5", "--top-k", "50"]
    sampled = [_cli_tokens(capsys, *kw, *hot, "--seed", s)
               for s in ("0", "11")]
    assert sampled[0] != sampled[1]
    host = _cli_tokens(capsys, *kw, *hot, "--seed", "11", "--host-sampling")
    assert host == sampled[1]
