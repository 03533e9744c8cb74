"""The six arch families this slice ports — phi3.5-moe and grok (MoE), jamba
(Mamba + MoE + attention), xlstm (mLSTM + sLSTM), musicgen (frame
embeddings, sinusoidal positions, cross-attention) and phi-3-vision (patch
embeddings) — at their smoke sizes against the JAX reference, on the CPU:
whole-sequence logits and aux, logits through caches (a whole-prompt
prefill, then one-token decode steps), a train step's loss and per-leaf
gradients (``embeds`` / ``cond`` batches for the stub frontends), random
init, and checkpoints either package restores.

Weights come from the reference's ``lm_init`` through ``from_jax_params``,
inputs from numpy seeds. Tolerances, as fractions of the largest reference
value:

* whole-sequence logits at fp32: 1e-5 (the same fp32 ops in other
  summation orders; the Mamba scan in another tree; measured <= 4.2e-6),
  with equal greedy tokens; aux 1e-5 relative.
* logits through caches at fp32: 1e-4. The KV cache is bf16 on both
  sides, written from fp32 rows that differ by rounding, so a row that
  sits on a bf16 rounding boundary can round the other way (2^-9 of that
  element); measured <= 2.7e-5. Against the port's own whole-sequence
  pass 2^-8: there the whole sequence attends unrounded K/V and the decode
  steps the bf16 cache (measured <= 7.3e-4).
* bf16 compute: 2^-4, as ``test_torch_model.py``, for every (batch,
  position) row of the archs without experts. With experts, the router
  reads a residual stream that differs by bf16 roundings between the two
  packages, so a token whose k-th and (k+1)-th router probabilities sit
  closer than that (jamba's smoke: gaps down to 3.6e-5) can take another
  expert — an O(1) change to its row, carried along the sequence by the
  attention and Mamba state (measured: one such flip in 5 of jamba's 8 MoE
  layers, 2 of 32 rows off). There at least 7/8 of the rows hold 2^-4;
  the fp32 tests above hold every row, with no flip.
* train-step loss 1e-5 relative; gradients 1e-4 of each leaf's largest |g|
  (the recurrences' gradients sum over every step in another order;
  measured <= 1.7e-5, xLSTM's forget-gate weights).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.checkpoint.store import CheckpointManager as JCkpt
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.train import step as JS
from repro_torch.checkpoint.store import CheckpointManager as TCkpt
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS
from repro_torch.weights import from_jax_params, init_params, to_jax_params

ARCHS = ["phi3.5-moe-42b-a6.6b", "grok-1-314b", "jamba-1.5-large-398b",
         "xlstm-1.3b", "musicgen-large", "phi-3-vision-4.2b"]
B, P, STEPS, L = 2, 16, 4, 32


def _pair(arch, cd="float32", **over):
    jc = jget(arch, smoke=True, compute_dtype=cd, **over)
    tc = tget(arch, smoke=True, compute_dtype=cd, **over)
    p = JT.lm_init(Ctx(random.key(0)), jc)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc,
                                      device="cpu")


def _inputs(cfg, s, seed=0):
    """numpy model inputs: tokens or frame / patch embeddings, and cond."""
    r = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        out = {"tokens": r.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)}
    else:
        out = {"embeds": r.standard_normal((B, s, cfg.d_model)).astype(
            np.float32)}
    if cfg.cross_attn:
        out["cond"] = r.standard_normal(
            (B, cfg.n_cond_tokens, cfg.d_model)).astype(np.float32)
    return out


def _sl(inputs, sl):
    """The sequence slice ``sl`` of the inputs (cond is not sliced)."""
    return {k: (v if k == "cond" else v[:, sl]) for k, v in inputs.items()}


def _close(got, ref, frac):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_sequence_logits_match_reference(arch):
    jc, tc, p, model = _pair(arch)
    x = _inputs(jc, 24)
    jl, _, jaux = JT.lm_apply(p, jc, **{k: jnp.asarray(v)
                                         for k, v in x.items()})
    with torch.no_grad():
        tl, caches, taux = TT.lm_apply(model, tc, **{
            k: torch.tensor(v) for k, v in x.items()})
    assert caches is None
    _close(tl.numpy(), jl, 1e-5)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_through_caches_match_reference(arch):
    """A whole-prompt prefill of P inputs, then STEPS one-token steps (with
    cond each time): per step against the reference's, and against the
    port's whole-sequence pass; caches hold what the reference's hold."""
    jc, tc, p, model = _pair(arch)
    x = _inputs(jc, P + STEPS, seed=1)
    jcache = JT.init_caches(jc, B, L)
    tcache = TT.init_caches(tc, B, L, device="cpu")
    steps = [slice(0, P)] + [slice(P + t, P + t + 1) for t in range(STEPS)]
    jouts, touts = [], []
    for i, sl in enumerate(steps):
        ji, ti = JT.cache_index(jcache), TT.cache_index(tcache)
        if i == 0:
            jpos, tpos = jnp.arange(P)[None], torch.arange(P)[None]
        else:
            jpos = None if ji is None else ji[:, None]
            tpos = None if ti is None else ti[:, None]
        jl, jcache, _ = JT.lm_apply(
            p, jc, caches=jcache, positions=jpos, merged=True,
            **{k: jnp.asarray(v) for k, v in _sl(x, sl).items()})
        with torch.no_grad():
            tl, tcache, _ = TT.lm_apply(
                model, tc, caches=tcache, positions=tpos, merged=True,
                **{k: torch.tensor(v) for k, v in _sl(x, sl).items()})
        jouts.append(np.asarray(jl)[:, -1])
        touts.append(tl.numpy()[:, -1])
    for j, t in zip(jouts, touts):
        _close(t, j, 1e-4)
    with torch.no_grad():
        whole, _, _ = TT.lm_apply(model, tc, **{
            k: torch.tensor(v) for k, v in x.items()})
    _close(np.stack(touts, 1), whole.numpy()[:, P - 1:], 2 ** -8)
    # the caches: the reference's leaves, stacked on n_super, one per
    # super-layer here (bf16 K/V within a rounding of each other)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        name, kind, key = (k.key for k in path)
        for i, sup in enumerate(tcache):
            got = sup[name][kind][key]
            if key == "index":
                np.testing.assert_array_equal(got.numpy(), P + STEPS)
            else:
                _close(got.float().numpy(), np.asarray(
                    leaf[i].astype(jnp.float32)), 2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    jc, tc, p, model = _pair(arch, cd="bfloat16")
    x = _inputs(jc, 16, seed=2)
    jl, _, _ = JT.lm_apply(p, jc, **{k: jnp.asarray(v)
                                      for k, v in x.items()})
    with torch.no_grad():
        tl, _, _ = TT.lm_apply(model, tc, **{k: torch.tensor(v)
                                             for k, v in x.items()})
    got, ref = tl.float().numpy(), np.asarray(jl.astype(jnp.float32))
    assert got.shape == ref.shape and np.isfinite(got).all()
    held = np.abs(got - ref).max(-1) <= 2 ** -4 * np.abs(ref).max()
    assert held.mean() >= (7 / 8 if tc.moe is not None else 1.0), held


def _tcfg():
    base = dict(global_batch=B, seq_len=16, lr=1e-3, warmup_steps=2,
                total_steps=50, remat="none")
    return JTrainConfig(**base), TTrainConfig(**base)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(arch):
    """``make_loss_fn`` on one batch (``embeds`` / ``cond`` for the stub
    frontends): loss, ce and aux, and the gradient of every leaf, against
    ``jax.value_and_grad`` of the reference's loss."""
    jc, tc, p, model = _pair(arch)
    jt, tt = _tcfg()
    x = _inputs(jc, 16, seed=3)
    x["labels"] = np.random.default_rng(4).integers(
        0, jc.vocab_size, (B, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(JS.make_loss_fn(jc, jt), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in x.items()})
    model.requires_grad_(True)
    tl, tm = TS.make_loss_fn(tc, tt)(model, {k: torch.tensor(v)
                                             for k, v in x.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-12)
    assert (float(tm["aux"]) > 0) == (tc.moe is not None)
    got = to_jax_params({n: t.grad for n, t in model.named_parameters()},
                        tc)
    ref = jax.tree_util.tree_flatten_with_path(jg)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(ref) == len(got_flat)
    for path, g in ref:
        g = np.asarray(g)
        np.testing.assert_allclose(got_flat[path], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_reference_distributions(arch):
    """Every parameter of ``init_params`` has the reference leaf's shape;
    constants (norms, biases, gates, A_log, D, gamma) equal the
    reference's; random leaves have its standard deviation."""
    _, tc, _, bridged = _pair(arch)
    model = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    ref = dict(bridged.named_parameters())
    assert ref.keys() == dict(model.named_parameters()).keys()
    for name, t in model.named_parameters():
        r = ref[name]
        assert t.shape == r.shape, name
        if "score_norm.beta" in name:               # U[lo, hi]
            cfg = tc.consmax
            assert ((t >= cfg.beta_init_lo)
                    & (t <= cfg.beta_init_hi)).all(), name
        elif r.unique().numel() > 64:               # random draws
            np.testing.assert_allclose(t.std().item(), r.std().item(),
                                       rtol=0.1, err_msg=name)
        else:                                       # deterministic leaves
            torch.testing.assert_close(t, r, msg=name)


def test_moe_checkpoints_restore_in_either_package(tmp_path):
    """A consmax-router MoE (its beta / gamma are 0-d per layer, stacked to
    (n_super,)): the port's state tree saved by the port's manager restores
    in the reference's to the same leaves, and a reference checkpoint
    restores in the port to the same logits."""
    kw = dict(n_experts=4, top_k=2, d_ff_expert=256, router_norm="consmax")
    jc = jget("phi3.5-moe-42b-a6.6b", smoke=True, compute_dtype="float32",
              moe=JMoEConfig(**kw))
    tc = tget("phi3.5-moe-42b-a6.6b", smoke=True, compute_dtype="float32",
              moe=TMoEConfig(**kw))
    jt, tt = _tcfg()
    init_state, _ = TS.make_train_fns(tc, tt, device="cpu")
    state = init_state()
    tree = TS.state_tree(state, tc)
    assert tree["params"]["blocks"]["b0"]["moe"]["beta"].shape == (
        tc.n_super_layers,)
    TCkpt(str(tmp_path / "port")).save(tree, 3)
    back = JCkpt(str(tmp_path / "port")).restore(3)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(b), a,
                                      err_msg=jax.tree_util.keystr(path))

    jinit, _ = JS.make_train_fns(jc, jt)
    jstate = jinit(random.key(1))
    JCkpt(str(tmp_path / "ref")).save(jstate, 5)
    TS.load_state_tree(state, TCkpt(str(tmp_path / "ref")).restore(5), tc)
    assert int(state["step"]) == 0
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, 12))
    jl, _, _ = JT.lm_apply(jstate["params"], jc,
                           tokens=jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        tl, _, _ = TT.lm_apply(state["params"], tc,
                               tokens=torch.tensor(toks, dtype=torch.int32))
    _close(tl.numpy(), jl, 1e-5)


def test_serve_cli_serves_the_new_archs_on_cpu(capsys):
    """``launch/serve.py``: MoE on the continuous engine (paged, kernel
    flags on: their plain versions here) and the static session; xlstm on
    the static session, host-sampled; the continuous engine refuses a
    recurrent arch and the CLI a stub frontend, as the reference's do."""
    from repro_torch.launch.serve import main
    for arch in ("phi3.5-moe-42b-a6.6b", "grok-1-314b"):
        main(["--device", "cpu", "--arch", arch, "--engine", "continuous",
              "--requests", "3", "--max-slots", "2", "--prefill-chunk", "8",
              "--prompt-len", "10", "--steps", "4", "--paged",
              "--page-size", "4", "--decode-kernel", "--prefill-kernel"])
        assert "3 requests" in capsys.readouterr().out
    main(["--device", "cpu", "--arch", "xlstm-1.3b", "--batch", "2",
          "--steps", "3"])
    assert "fused=False" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="pure-attention"):
        main(["--device", "cpu", "--arch", "jamba-1.5-large-398b",
              "--engine", "continuous"])
    with pytest.raises(SystemExit, match="embeddings"):
        main(["--device", "cpu", "--arch", "phi-3-vision-4.2b"])
