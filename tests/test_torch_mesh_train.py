"""The port's data-parallel training on 2 gloo ranks over the CPU
(``Trainer(mesh=...)``, ``train/step.py``, ``distributed/sharding.py``),
``compressed_psum``, the expert-parallel MoE (``models/moe_ep.py``) and
elastic checkpoints, in one spawn.

* gpt2-consmax (a small fp32 config, global batch 8 x 32 tokens): 10
  steps with FSDP2 and 10 with ``fsdp=False`` give the single-device
  trainer's per-step loss and gradient norm on the same global batch
  within relative 1e-5. Why not bit-equal: each rank's gradient is the
  mean over its 4 rows and the ranks' gradients are then averaged (FSDP2's
  reduce-scatter, or the replicated path's all-reduce), which regroups the
  single device's one sum over 8 rows, so the gradients differ in their
  last bits (~1e-7 relative in fp32); AdamW's update divides by sqrt(v)
  and moves each parameter by ~lr, so over 10 steps the losses stay within
  a few 1e-7 relative (measured ~1e-7); 1e-5 leaves the margin the
  reference's own cross-package checkpoint test uses.
* Elastic: the FSDP run's step-8 checkpoint (gathered whole, written by
  rank 0) restores on one rank and in the reference's trainer, and both
  continue with the 2-rank run's next losses; the single-device trainer's
  step-8 checkpoint restores on 2 ranks and continues with the
  single-device losses.
* ``compressed_psum`` equals the reference's formula (numpy, fp32) on the
  same per-rank trees, bit for bit.
* The EP MoE (phi3.5-moe smoke, 8 experts, capacity factor 8.0: nothing
  dropped) equals ``moe_apply`` at bf16 exactly (err == 0.0, as the
  reference asserts), directly and through an ``attn_moe`` block under
  ``expert_parallel``; at fp32 its gradients, summed over the ranks, are
  within relative 1e-5 of the whole batch's (autograd through both
  all-to-alls; the weight gradients sum the tokens in another order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.train.trainer import Trainer
from repro_torch.weights import from_jax_params
from torch_mesh_worker import spawn

WORLD = 2
SMALL = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=128, compute_dtype="float32")
TRAIN = dict(global_batch=8, seq_len=32, lr=1e-3, warmup_steps=2,
             total_steps=50, remat="none")
STEPS, CKPT_AT, MORE = 10, 8, 2
RTOL = 1e-5


def _model(tc):
    jc = jget("gpt2-consmax", **SMALL)
    p = JT.lm_init(Ctx(jax.random.key(0)), jc)
    return from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    tc = tget("gpt2-consmax", **SMALL)
    model = _model(tc)
    torch.save(model.state_dict(), tmp / "w.pt")
    single = Trainer(tc, TrainConfig(**TRAIN), model=model, device="cpu",
                     ckpt_dir=str(tmp / "single"), ckpt_every=CKPT_AT,
                     log_every=1000)
    hist = single.run(STEPS)
    results = spawn("train", WORLD, dict(
        model=SMALL, train=TRAIN, weights=str(tmp / "w.pt"),
        ckpt=str(tmp / "mesh"), ckpt_every=CKPT_AT, steps=STEPS,
        single_ckpt=str(tmp / "single"), resume_steps=MORE), tmp)
    return tmp, tc, hist, results


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "replicated"])
def test_mesh_training_equals_single_device(train_run, fsdp):
    _, _, hist, results = train_run
    for res in results:
        got = res[f"fsdp={fsdp}"]
        assert got["sharded"] == ("DTensor" if fsdp else "Parameter")
        np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist],
                                   rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"],
                                   [h["grad_norm"] for h in hist], rtol=RTOL)
        assert got["loss"] == results[0][f"fsdp={fsdp}"]["loss"]
        # per step, FSDP: the metrics and the gradient norm (FSDP2's own
        # collectives bypass the counter); replicated: the metrics and one
        # flat all-reduce of every gradient
        assert got["counts"]["all_reduce"]["calls"] == 2 * STEPS


def test_two_rank_checkpoint_restores_on_one_rank_and_in_reference(
        train_run):
    tmp, tc, _, results = train_run
    mesh_losses = results[0]["fsdp=True"]["loss"]
    tr = Trainer(tc, TrainConfig(**TRAIN), model=_model(tc), device="cpu",
                 ckpt_dir=str(tmp / "mesh"), log_every=1000)
    assert tr.step_index() == CKPT_AT
    got = [h["loss"] for h in tr.run(MORE)]
    np.testing.assert_allclose(got, mesh_losses[CKPT_AT:], rtol=RTOL)
    jtr = JTrainer(jget("gpt2-consmax", **SMALL), JTrainConfig(**TRAIN),
                   ckpt_dir=str(tmp / "mesh"), log_every=1000)
    assert jtr.step_index() == CKPT_AT
    ref = [h["loss"] for h in jtr.run(MORE)]
    np.testing.assert_allclose(ref, mesh_losses[CKPT_AT:], rtol=RTOL)


def test_one_rank_checkpoint_restores_on_two_ranks(train_run):
    _, _, hist, results = train_run
    for res in results:
        assert res["resumed_at"] == CKPT_AT
        np.testing.assert_allclose(res["resumed"],
                                   [h["loss"] for h in hist[CKPT_AT:]],
                                   rtol=RTOL)


def test_compressed_psum_equals_reference_formula(train_run):
    """The reference's ``compressed_psum`` (optim/compression.py:43) in
    numpy fp32 on both ranks' trees."""
    _, _, _, results = train_run
    trees = [{k: np.asarray(v, np.float32) for k, v in
              r["psum"]["tree"].items()} for r in results]
    for name in trees[0]:
        gs = [t[name] for t in trees]
        scale = max(np.float32(np.abs(g).max()) / np.float32(127.0)
                    + np.float32(1e-12) for g in gs)
        q = [np.clip(np.round(g / scale), -127, 127).astype(np.int8)
             for g in gs]
        total = sum(x.astype(np.int32) for x in q)
        ref = total.astype(np.float32) * scale
        for r in results:
            got = np.asarray(r["psum"]["out"][name], np.float32)
            assert got.tobytes() == ref.tobytes(), name


def test_expert_parallel_moe_matches_moe_apply(train_run):
    _, _, _, results = train_run
    for res in results:
        ep = res["ep"]
        assert ep["y_err"] == 0.0
        assert ep["block_err"] == 0.0
        # route -> pmean(aux): one all-reduce; x, expert ids and results
        # cross as three all-to-alls
        assert ep["counts"]["all_to_all"]["calls"] == 3
        assert ep["counts"]["all_reduce"]["calls"] == 1
        for name, err in ep["grad_rel_err"].items():
            assert err < 1e-5, (name, err)
    aux = [r["ep"]["aux"][0] for r in results]
    assert aux[0] == aux[1]
