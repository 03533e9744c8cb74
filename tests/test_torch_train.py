"""The port's training path against the JAX reference, on the CPU: the loss,
per-leaf gradients (ConSmax beta/gamma included), AdamW and its decay mask,
int8 error feedback, the trainer's loss curves, remat and microbatching,
and the CLI.

Weights come from the reference's ``lm_init`` through ``from_jax_params``,
inputs from numpy seeds. Tolerances, each argued where it is used:

* fp32 loss and gradients: 1e-5 of the largest |g| of each leaf. Both
  sides run the same fp32 ops and differ in summation order (and libm
  ulps); measured <= 2.3e-6 on these configs.
* AdamW: 1e-6 absolute on parameters of O(1) and on moments. The update is
  elementwise fp32 in the reference's order; only the global norm (a sum)
  and ``cos`` / ``pow`` in the schedule and the bias correction may differ
  by an ulp.
* 8-step loss curves at fp32: 1e-5 relative per step (measured <= 3.5e-7:
  the gradient differences above, passed through Adam's normalized step).
  At bf16: 1e-3 relative (each matmul rounds to bf16, 2^-9 relative, in
  another accumulation order; measured <= 1.5e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget
from repro.core import consmax as JC
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.optim import adamw as JA
from repro.optim import compression as JCMP
from repro.train import step as JS
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import consmax as TC
from repro_torch.nn import layers as TL
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TCMP
from repro_torch.train import step as TS
from repro_torch.train.trainer import StragglerMonitor
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.weights import from_jax_params, split_jax_tree, to_jax_params

SMALL = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=128)


def _tcfg(**kw):
    base = dict(global_batch=8, seq_len=32, lr=1e-3, warmup_steps=2,
                total_steps=50, remat="none", microbatch=0)
    base.update(kw)
    return JTrainConfig(**base), TTrainConfig(**base)


def _configs(arch="gpt2-consmax", smoke=False, **over):
    if smoke:
        return jget(arch, smoke=True, **over), tget(arch, smoke=True, **over)
    return jget(arch, **SMALL, **over), tget(arch, **SMALL, **over)


def _models(jc, tc, seed=0):
    p = JT.lm_init(Ctx(random.key(seed)), jc)
    return p, from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, b, s, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": r.integers(0, vocab, (b, s)).astype(np.int32)}


# ----------------------------------------------------------------- loss ----
@pytest.mark.parametrize("z_weight", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_weight):
    r = np.random.default_rng(1)
    logits = (r.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    ref = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           z_weight=z_weight)
    got = TS.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                           z_weight=z_weight)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # bf16 logits are upcast first on both sides
    ref16 = JS.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(labels), z_weight=z_weight)
    got16 = TS.cross_entropy(torch.tensor(logits).bfloat16(),
                             torch.tensor(labels), z_weight=z_weight)
    np.testing.assert_allclose(float(got16), float(ref16), rtol=1e-6)


@pytest.mark.parametrize("arch,norm,smoke", [
    ("gpt2-consmax", "consmax", True), ("gpt2-consmax", "softmax", True),
    ("qwen2-1.5b", "consmax", True), ("gemma2-2b", "consmax", True)])
def test_step0_loss_and_grads_match_reference(arch, norm, smoke):
    """``jax.value_and_grad`` of the reference's loss against autograd
    through the port's ``blockwise_attention`` (two query and four KV
    chunks at s 64), per leaf within 1e-5 of its largest |g|."""
    jc, tc = _configs(arch, smoke, compute_dtype="float32", score_norm=norm)
    p, model = _models(jc, tc)
    jt, tt = _tcfg(global_batch=2, seq_len=64, q_chunk=32, kv_chunk=16)
    batch = _batch(jc.vocab_size, 2, 64)
    (lj, mj), gj = jax.value_and_grad(JS.make_loss_fn(jc, jt), has_aux=True)(
        p, {k: jnp.asarray(v) for k, v in batch.items()})
    model.requires_grad_(True)
    lt, mt = TS.make_loss_fn(tc, tt)(
        model, {k: torch.tensor(v) for k, v in batch.items()})
    params = dict(model.named_parameters())
    g = dict(zip(params, torch.autograd.grad(lt, list(params.values()))))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(float(mt["ce"].detach()), float(mj["ce"]),
                               rtol=1e-6)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    ref, got = _leaves(gj), _leaves(to_jax_params(g, tc))
    assert ref.keys() == got.keys()
    if norm == "consmax":
        assert any(k.endswith("['beta']") for k in ref)
        assert any(k.endswith("['gamma']") for k in ref)
    for k, a in ref.items():
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(got[k] - a).max())
        assert err <= 1e-5 * scale, (k, err, scale)


@pytest.mark.parametrize("merged", [False, True])
def test_consmax_beta_gamma_gradients(merged):
    """beta and gamma get gradients through ``consmax`` in both forms,
    equal to the reference's (fp32 elementwise ops, 1e-5 relative)."""
    r = np.random.default_rng(2)
    scores = r.standard_normal((2, 3, 5, 7)).astype(np.float32)
    mask = r.random((5, 7)) < 0.7
    beta = r.uniform(0.5, 2.5, 3).astype(np.float32)
    gamma = np.full(3, 100.0, np.float32)
    w = r.standard_normal((2, 3, 5, 7)).astype(np.float32)

    def jloss(b, g):
        out = JC.consmax({"beta": b, "gamma": g}, jnp.asarray(scores),
                         jnp.asarray(mask), head_axis=1, merged=merged)
        return jnp.sum(out * w)
    jb, jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(beta),
                                              jnp.asarray(gamma))
    tb = torch.tensor(beta, requires_grad=True)
    tg = torch.tensor(gamma, requires_grad=True)
    out = TC.consmax(tb, tg, torch.tensor(scores), torch.tensor(mask),
                     head_axis=1, merged=merged)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg), rtol=1e-5)
    assert float(tb.grad.abs().min()) > 0 and float(tg.grad.abs().min()) > 0


def test_cast_differentiable_under_grad_cached_otherwise():
    p = torch.nn.Parameter(torch.ones(4), requires_grad=False)
    cached = TL.cast(p, torch.bfloat16)
    p.requires_grad_(True)
    with torch.no_grad():
        assert TL.cast(p, torch.bfloat16) is cached
    y = TL.cast(p, torch.bfloat16)
    assert y.requires_grad and y is not cached
    (y.float() * 3).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), 3.0)


# ---------------------------------------------------------------- AdamW ----
# the MoE, Mamba and xLSTM trees, each with the scalars of its consmax
# variant: the MoE router's 0-d beta / gamma, mLSTM's mu / gamma, sLSTM's mu
TREES = {
    "phi3.5-moe-42b-a6.6b": dict(moe="consmax"),
    "jamba-1.5-large-398b": {},
    "xlstm-1.3b": dict(stabilizer="consmax"),
}


def _tree_configs(arch):
    if arch == "gpt2-consmax":
        return _configs(compute_dtype="float32")
    jc, tc = _configs(arch, smoke=True, compute_dtype="float32")
    variant = TREES[arch]
    if "moe" in variant:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, router_norm="consmax"))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, router_norm="consmax"))
    if "stabilizer" in variant:
        jc = jc.replace(xlstm=dataclasses.replace(jc.xlstm,
                                                  stabilizer="consmax"))
        tc = tc.replace(xlstm=dataclasses.replace(tc.xlstm,
                                                  stabilizer="consmax"))
    return jc, tc


@pytest.mark.parametrize("arch", ["gpt2-consmax", *TREES])
def test_decay_mask_matches_reference_tree(arch):
    """Every ``blocks.*`` leaf of a per-layer tensor of >= 1 dim decays (the
    reference's stacked leaves are >= 2-D: norm scales, biases, ConSmax
    beta/gamma, the MoE router and experts, Mamba's ``A_log`` / ``D`` /
    ``dt_bias``, the xLSTM gates and ``mu`` / ``gamma`` too); a 0-d
    per-layer scalar (the consmax MoE router's beta / gamma, stacked to
    ``(n_super,)``) does not, nor the top-level 1-D ``final_norm`` leaves;
    the embedding does. Checked by running both AdamW updates with zero
    gradients on a real tree, its leaves shifted by 1 so that none is zero
    (a zero leaf decays to itself)."""
    jc, tc = _tree_configs(arch)
    p = jax.tree.map(lambda a: a + 1.0,
                     JT.lm_init(Ctx(random.key(0)), jc))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    jt, tt = _tcfg(weight_decay=0.5, grad_clip=0.0)
    zeros = jax.tree.map(jnp.zeros_like, p)
    new_p, _, _ = JA.adam_update(zeros, JA.adam_init(p), p, lr=0.1, tcfg=jt)
    params = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    TA.adam_update({k: torch.zeros_like(v) for k, v in params.items()},
                   TA.adam_init(params), params, lr=torch.tensor(0.1),
                   tcfg=tt)
    ref_moved = {k: not np.array_equal(np.asarray(a), np.asarray(b))
                 for (k, a), b in zip(_leaves(new_p).items(),
                                      _leaves(p).values())}
    got_moved = {k: bool((params[k] != before[k]).any()) for k in params}
    got_tree = _leaves(to_jax_params(
        {k: torch.tensor(float(v)).expand(params[k].shape)
         for k, v in got_moved.items()}, tc))
    for k, moved in ref_moved.items():
        assert bool(got_tree[k].all()) == moved, k
        assert moved == (not k.startswith("['final_norm']")
                         and not k.endswith(("['moe']['beta']",
                                             "['moe']['gamma']"))), k
    pinned = {"gpt2-consmax": ("score_norm",),
              "phi3.5-moe-42b-a6.6b": ("['router']", "['gate']",
                                       "['down']", "['moe']['beta']"),
              "jamba-1.5-large-398b": ("['A_log']", "['D']", "['dt_bias']",
                                       "['router']"),
              "xlstm-1.3b": ("['w_ig']", "['b_fg']", "['mlstm']['mu']",
                             "['slstm']['mu']", "['r']")}[arch]
    for name in pinned:
        assert any(name in k for k in ref_moved), name
    for name, t in params.items():
        assert TA.decayed(name, t) == got_moved[name], name


def test_adam_update_matches_reference_over_the_schedule():
    """The same gradients (random, some above the clip) into both updates,
    at every step of a 2 + 8 warmup-cosine schedule: parameters and
    moments within 1e-6, lr within 1e-9 (fp32 cos, one ulp)."""
    jc, tc = _configs(compute_dtype="float32")
    p, model = _models(jc, tc)
    jt, tt = _tcfg(warmup_steps=2, total_steps=10, weight_decay=0.1,
                   grad_clip=1.0)
    params = dict(model.named_parameters())
    jopt, topt = JA.adam_init(p), TA.adam_init(params)
    jlr, tlr = JA.warmup_cosine(jt), TA.warmup_cosine(tt)
    r = np.random.default_rng(3)
    for step in range(12):
        scale = 0.05 if step % 3 else 2.0          # clipped every third
        gt = {k: torch.tensor(r.standard_normal(v.shape).astype(np.float32)
                              * scale) for k, v in params.items()}
        gj = jax.tree.map(jnp.asarray, to_jax_params(gt, tc))
        lr_j, lr_t = jlr(step), tlr(torch.tensor(step, dtype=torch.int32))
        assert abs(float(lr_j) - float(lr_t)) <= 1e-9
        p, jopt, jm = JA.adam_update(gj, jopt, p, lr=lr_j, tcfg=jt)
        tm = TA.adam_update(gt, topt, params, lr=lr_t, tcfg=tt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for name, jtree, ttree in (("params", p, params),
                                   ("m", jopt["m"], topt["m"]),
                                   ("v", jopt["v"], topt["v"])):
            ref, got = _leaves(jtree), _leaves(to_jax_params(ttree, tc))
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], atol=1e-6,
                                           err_msg=f"{name}{k} step {step}")
        assert int(topt["count"]) == int(jopt["count"]) == step + 1


@pytest.mark.parametrize("arch", list(TREES))
def test_int8_ef_matches_reference_on_model_trees(arch):
    """The same bits on the MoE, Mamba and xLSTM parameter trees (0-d
    MoE router scalars included): random gradients and residuals per
    leaf, the port's per-layer tensors sharing their stacked leaf's
    scale."""
    jc, tc = _tree_configs(arch)
    p = JT.lm_init(Ctx(random.key(0)), jc)
    r = np.random.default_rng(5)
    g, e = ({path: (r.standard_normal(np.shape(a))
                    * 10.0 ** r.integers(-3, 3)).astype(np.float32)
             for path, a in jax.tree_util.tree_flatten_with_path(p)[0]}
            for _ in range(2))
    treedef = jax.tree.structure(p)
    jg, je = (jax.tree.unflatten(treedef, [jnp.asarray(v)
                                           for v in d.values()])
              for d in (g, e))
    jd, jn = JCMP.ef_compress_grads(jg, je)
    tg, te = (split_jax_tree(jax.tree.map(np.asarray, t), tc)
              for t in (jg, je))
    td, tn = TCMP.ef_compress_grads(tg, te)
    for ref, got in ((jd, td), (jn, tn)):
        got = dict(jax.tree_util.tree_flatten_with_path(
            to_jax_params(got, tc))[0])
        for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
            np.testing.assert_array_equal(got[path], np.asarray(a),
                                          err_msg=jax.tree_util.keystr(path))


def test_int8_ef_matches_reference():
    """Bit-equal to the reference's ``ef_compress_grads`` (elementwise fp32
    ops in the same order; a max is exact). Its scale is one per leaf of
    the reference's tree, whose block leaves stack the super-layers: the
    port's per-layer ``blocks.{i}.*`` tensors of one leaf share one scale
    (the two layers here differ 100x in size, so separate scales would
    show)."""
    r = np.random.default_rng(4)
    layers = [(r.standard_normal((16, 8)) * s).astype(np.float32)
              for s in (1.0, 100.0)]
    table = (r.standard_normal((33,)) * 1e-2).astype(np.float32)
    ef = [(r.standard_normal(a.shape) * 1e-3).astype(np.float32)
          for a in (*layers, table)]
    jd, je = JCMP.ef_compress_grads(
        {"blocks": {"b0": {"w": jnp.asarray(np.stack(layers))}},
         "embed": {"table": jnp.asarray(table)}},
        {"blocks": {"b0": {"w": jnp.asarray(np.stack(ef[:2]))}},
         "embed": {"table": jnp.asarray(ef[2])}})
    names = ["blocks.0.b0.w", "blocks.1.b0.w", "embed.table"]
    td, te = TCMP.ef_compress_grads(
        {n: torch.tensor(a) for n, a in zip(names, (*layers, table))},
        {n: torch.tensor(a) for n, a in zip(names, ef)})
    for i in range(2):
        np.testing.assert_array_equal(td[names[i]].numpy(),
                                      np.asarray(jd["blocks"]["b0"]["w"][i]))
        np.testing.assert_array_equal(te[names[i]].numpy(),
                                      np.asarray(je["blocks"]["b0"]["w"][i]))
    np.testing.assert_array_equal(td["embed.table"].numpy(),
                                  np.asarray(jd["embed"]["table"]))
    np.testing.assert_array_equal(te["embed.table"].numpy(),
                                  np.asarray(je["embed"]["table"]))


def test_int8_ef_training_still_converges():
    jc, tc = _configs()
    _, tt = _tcfg(grad_compression="int8_ef")
    tr = TTrainer(tc, tt, log_every=1000, device="cpu")
    hist = tr.run(25)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_int8_ef_step_matches_reference():
    """One compressed step from the same weights and batch: loss, grad
    norm (after compression) and the carried residuals."""
    jc, tc = _configs(compute_dtype="float32")
    p, model = _models(jc, tc)
    jt, tt = _tcfg(grad_compression="int8_ef")
    batch = _batch(jc.vocab_size, 8, 32, seed=5)
    jinit, jstep = JS.make_train_fns(jc, jt)
    jstate = {"params": p, "opt": JA.adam_init(p),
              "step": jnp.zeros((), jnp.int32),
              "ef": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                 p)}
    jstate, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    tinit, tstep = TS.make_train_fns(tc, tt, device="cpu")
    tstate, tm = tstep(tinit(model), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    ref, got = _leaves(jstate["ef"]), _leaves(to_jax_params(tstate["ef"], tc))
    for k, a in ref.items():
        # where both gradients round to the same code the residuals differ
        # by the gradients' difference, <= 2.3e-6 of absmax(g) (above),
        # and |residual| reaches half a step, absmax(g) / 254: so <= 5.8e-4
        # of the largest residual (measured <= 2.6e-4; a code flip would
        # cost a whole step, 2x the largest residual)
        assert float(np.abs(got[k] - a).max()) <= (
            np.abs(a).max() * 1e-3 + 1e-9), k


# -------------------------------------------------------------- trainer ----
@pytest.mark.parametrize("norm,cd,rtol", [
    ("consmax", "float32", 1e-5), ("softmax", "float32", 1e-5),
    ("consmax", "bfloat16", 1e-3)])
def test_trainer_curve_matches_reference(norm, cd, rtol):
    """8 steps of the port's ``Trainer`` against the reference's from the
    same weights and batches (the synthetic corpus of seed 0)."""
    jc, tc = _configs(compute_dtype=cd, score_norm=norm)
    jt, tt = _tcfg()
    hj = JTrainer(jc, jt, log_every=1000).run(8)
    _, model = _models(jc, tc, seed=jt.seed)
    ht = TTrainer(tc, tt, log_every=1000, model=model).run(8)
    lj = np.array([h["loss"] for h in hj])
    lt = np.array([h["loss"] for h in ht])
    np.testing.assert_allclose(lt, lj, rtol=rtol)
    for key in ("ce", "aux", "lr", "grad_norm", "step"):
        np.testing.assert_allclose([h[key] for h in ht],
                                   [h[key] for h in hj], rtol=100 * rtol,
                                   err_msg=key)
    assert lt[-1] < lt[0]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bit_equal(remat):
    """Recomputation changes no value: loss and every gradient bit-equal to
    ``remat="none"`` (bf16 compute, so the saved bf16 matmul outputs of
    ``"dots"`` are exercised)."""
    _, tc = _configs("qwen2-1.5b", smoke=True)
    batch = {k: torch.tensor(v) for k, v in
             _batch(tc.vocab_size, 2, 48).items()}
    out = {}
    for mode in ("none", remat):
        _, tt = _tcfg(remat=mode, q_chunk=16, kv_chunk=16)
        gen = torch.Generator().manual_seed(0)
        init_state, _ = TS.make_train_fns(tc, tt, device="cpu",
                                          generator=gen)
        model = init_state()["params"]
        loss, _ = TS.make_loss_fn(tc, tt)(model, batch)
        params = dict(model.named_parameters())
        out[mode] = (loss.detach(),
                     torch.autograd.grad(loss, list(params.values())))
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(out["none"][1], out[remat][1]):
        assert torch.equal(a, b)


def test_dots_policy_saves_only_plain_matmuls():
    """Under ``"dots"`` the forward keeps the 2-D matmul outputs and
    recomputes the rest: backward re-runs the attention einsums (bmm) but
    no projection (mm)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    _, tc = _configs("qwen2-1.5b", smoke=True)
    batch = {k: torch.tensor(v) for k, v in
             _batch(tc.vocab_size, 2, 16).items()}
    counts = {}
    for mode in ("none", "dots", "full"):
        _, tt = _tcfg(remat=mode)
        gen = torch.Generator().manual_seed(0)
        model = TS.make_train_fns(tc, tt, device="cpu",
                                  generator=gen)[0]()["params"]
        loss, _ = TS.make_loss_fn(tc, tt)(model, batch)
        with Count() as c:
            loss.backward()
        counts[mode] = c.ops
    # "full" recomputes the projections (up to the last one whose input
    # backward needs: recomputation stops early), "dots" none of them
    assert counts["full"].get("mm", 0) >= counts["none"].get("mm", 0) + 12
    assert counts["dots"].get("mm", 0) == counts["none"].get("mm", 0)
    assert counts["dots"].get("bmm", 0) > counts["none"].get("bmm", 0)


def test_microbatch_matches_full_batch():
    """Gradient accumulation over 2 microbatches == one batch (same data):
    loss rtol 1e-5, parameters after the step within 2e-5 (as the
    reference's ``test_microbatch_grad_equivalence``)."""
    _, tc = _configs(compute_dtype="float32")
    batch = _batch(tc.vocab_size, 8, 32, seed=6)
    out = {}
    for n in (0, 2):
        _, tt = _tcfg(microbatch=n)
        init_state, step = TS.make_train_fns(
            tc, tt, device="cpu", generator=torch.Generator().manual_seed(0))
        state, m = step(init_state(), batch)
        out[n] = (float(m["loss"]), {k: v.detach().clone() for k, v in
                                     state["params"].named_parameters()})
    np.testing.assert_allclose(out[2][0], out[0][0], rtol=1e-5)
    for k, v in out[0][1].items():
        np.testing.assert_allclose(out[2][1][k].numpy(), v.numpy(),
                                   atol=2e-5, err_msg=k)


def test_straggler_monitor():
    m = StragglerMonitor(factor=2.0, warmup=3)
    for _ in range(10):
        assert not m.record(1.0)
    assert m.record(5.0)
    assert m.flagged == 1


def test_trainer_refuses_a_mesh():
    """Mesh training is served (tests/test_torch_mesh_train.py); the trainer
    refuses a mesh without exactly one data axis, and on the one-rank host
    mesh (FSDP over one rank) it trains as on one device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import host_mesh
    jc, tc = _configs()
    try:
        mesh = host_mesh()
        with pytest.raises(ValueError, match="one data axis"):
            TTrainer(tc, _tcfg()[1], device="cpu", mesh=init_device_mesh(
                "cpu", (1,), mesh_dim_names=("model",)))
        ref = TTrainer(tc, _tcfg()[1], model=_models(jc, tc)[1],
                       device="cpu", log_every=1000).run(3)
        got = TTrainer(tc, _tcfg()[1], model=_models(jc, tc)[1],
                       device="cpu", log_every=1000, mesh=mesh).run(3)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in ref], rtol=1e-6)


def test_engine_after_training_builds_no_graph():
    """``requires_grad_(True)`` (the trainer's) leaves serving as it was:
    the engine runs under ``no_grad``, gives the tokens it gave before,
    and no parameter gets a ``.grad``."""
    from repro_torch.serve.engine import ContinuousBatchingEngine
    _, tc = _configs("gpt2-consmax", smoke=True)
    _, tt = _tcfg()
    gen = torch.Generator().manual_seed(0)
    model = TS.make_train_fns(tc, tt, device="cpu",
                              generator=gen)[0]()["params"]
    scfg = ServeConfig(max_slots=2, max_seq=64, prefill_chunk=8,
                       decode_kernel=True, prefill_kernel=True)
    prompts = [[1, 2, 3, 4, 5], list(range(7, 20))]

    def serve():
        eng = ContinuousBatchingEngine(tc, scfg, model, device="cpu")
        uids = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        return [res[u] for u in uids]

    trained = serve()
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())
    model.requires_grad_(False)
    assert serve() == trained


def test_cli_trains_on_cpu(capsys):
    from repro_torch.launch import train as CLI
    hist = CLI.main(["--device", "cpu", "--smoke", "--steps", "20",
                     "--seq-len", "32"])
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert "[train] done on cpu" in capsys.readouterr().out


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train as CLI
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        CLI.main(["--steps", "1"])
