"""The port's checkpoints against the reference's: the on-disk format (npz
keys, the msgpack manifest's bytes), save / gc / async round trips, and
cross-package restore — a checkpoint the port's trainer writes restores in
the reference (same logits, same next losses) and the reverse; resume is
deterministic; SIGTERM saves and exits.

Tolerances: logits at fp32 within 1e-5 of the largest logit (the two
packages differ in summation order only, as ``test_torch_model.py``);
losses after a cross-package resume within 1e-5 relative (the 8-step curve
bound of ``test_torch_train.py``); a resume inside one package bit-equal
(the CPU runs the same ops in the same order).
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointManager as JCkpt
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint.store import CheckpointManager as TCkpt
from repro_torch.checkpoint.store import packb
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.train import step as TS
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=128, compute_dtype="float32")
TRAIN = dict(global_batch=8, seq_len=32, lr=1e-3, warmup_steps=2,
             total_steps=50, remat="none")


def _cfgs(**over):
    kw = {**SMALL, **over}
    return jget("gpt2-consmax", **kw), tget("gpt2-consmax", **kw)


def _port_trainer(tc, ckpt_dir=None, ckpt_every=200, **kw):
    jc = jget("gpt2-consmax", **SMALL)
    p = JT.lm_init(Ctx(jax.random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    return TTrainer(tc, TTrainConfig(**TRAIN, **kw), ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, log_every=1000, model=model)


def _logits_close(ref, got):
    ref, got = np.asarray(ref), got.detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


TOKENS = np.random.default_rng(7).integers(0, 256, (2, 24)).astype(np.int32)


# --------------------------------------------------------------- format ----
@pytest.mark.parametrize("obj", [
    {"step": 0, "leaves": {}},
    {"step": 12345678, "leaves": {"params/embed/table": {
        "shape": [151936, 1536], "dtype": "float32"}}},
    {"a" * 31: 127, "b" * 32: 128, "c" * 255: 255, "d" * 256: 65535,
     "e" * 70000: 65536, "f": 2 ** 32, "g": [1] * 15, "h": [2] * 16,
     "i": [3] * 70000, "j": (4, 5)},
    {f"k{i}": {"shape": [i], "dtype": "int32"} for i in range(20)},
    {f"k{i}": i for i in range(70000)},
    {"unicode ß/β|γ": "ConSmax — β, γ"},
])
def test_packb_matches_msgpack(obj):
    assert packb(obj) == msgpack.packb(obj)


def test_packb_refuses_what_the_manifest_never_holds():
    for bad in (-1, 1.5, None, True, b"x"):
        with pytest.raises((TypeError, ValueError)):
            packb({"x": bad})


def test_files_equal_the_reference_managers(tmp_path):
    """The same state tree saved by both managers: the same file names,
    the same npz keys, dtypes and values, and the same manifest bytes."""
    _, tc = _cfgs()
    tr = _port_trainer(tc)
    tr.run(2)
    tree = TS.state_tree(tr.state, tc)
    JCkpt(str(tmp_path / "ref")).save(tree, 2)
    TCkpt(str(tmp_path / "port")).save(tree, 2)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "state-00000002.manifest", "state-00000002.npz"]
    ref_m = (tmp_path / "ref" / names[0]).read_bytes()
    assert (tmp_path / "port" / names[0]).read_bytes() == ref_m
    manifest = msgpack.unpackb(ref_m)
    assert manifest["leaves"]["step"] == {"shape": [], "dtype": "int32"}
    assert manifest["leaves"]["params/blocks/b0/attn/score_norm/beta"][
        "shape"] == [2, 4]
    with np.load(tmp_path / "ref" / names[1]) as a, \
            np.load(tmp_path / "port" / names[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_roundtrip_and_gc(tmp_path):
    mgr = TCkpt(str(tmp_path), keep=2)
    state = {"a": {"b": torch.arange(6).reshape(2, 3)},
             "step": np.asarray(7, np.int32)}
    for s in (1, 2, 3):
        mgr.save(state, s)
    assert mgr.steps() == [2, 3]
    assert mgr.latest_step() == 3
    out = mgr.restore(3)
    np.testing.assert_array_equal(out["a"]["b"], np.arange(6).reshape(2, 3))
    assert int(out["step"]) == 7
    assert not any(f.startswith(".tmp") for f in os.listdir(tmp_path))


def test_async_save_snapshots_before_the_thread(tmp_path):
    """``blocking=False`` copies every tensor to the host before its thread
    starts: an in-place update right after ``save`` returns (the
    optimizer's) is not in the file."""
    mgr = TCkpt(str(tmp_path))
    w = torch.ones(512, 512)
    mgr.save({"w": w}, 5, blocking=False)
    w.mul_(3.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    np.testing.assert_array_equal(mgr.restore(5)["w"], 1.0)


def test_store_needs_no_msgpack():
    code = ("import sys\nsys.modules['msgpack'] = None\n"
            "import numpy as np, tempfile\n"
            "import repro_torch.train.trainer\n"
            "from repro_torch.checkpoint.store import CheckpointManager\n"
            "m = CheckpointManager(tempfile.mkdtemp())\n"
            "m.save({'x': np.ones(3)}, 1)\n"
            "assert m.restore(1)['x'].sum() == 3\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


# -------------------------------------------------------- cross-package ----
def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port's trainer saves at step 4; the reference's manager restores
    the file to a tree whose ``lm_apply`` gives the port's logits, and the
    reference's trainer resumes from it at step 4 with the losses the port
    goes on to."""
    jc, tc = _cfgs()
    ck = str(tmp_path / "ck")
    tr = _port_trainer(tc, ck, ckpt_every=4)
    tr.run(4)
    state = JCkpt(ck).restore(4)
    ref_logits, _, _ = JT.lm_apply(state["params"], jc,
                                   tokens=jnp.asarray(TOKENS), remat="none")
    with torch.no_grad():
        got, _, _ = TT.lm_apply(tr.state["params"], tc,
                                tokens=torch.tensor(TOKENS))
    _logits_close(ref_logits, got)
    jtr = JTrainer(jc, JTrainConfig(**TRAIN), ckpt_dir=ck, log_every=1000)
    assert jtr.step_index() == 4
    hj = jtr.run(3)
    ht = tr.run(3)[-3:]              # run() returns the whole history
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-5)
    assert [h["step"] for h in hj] == [h["step"] for h in ht] == [4, 5, 6]


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reverse: the reference's trainer saves at step 4; the port's
    trainer resumes there with the reference's logits and next losses."""
    jc, tc = _cfgs()
    ck = str(tmp_path / "ck")
    jtr = JTrainer(jc, JTrainConfig(**TRAIN), ckpt_dir=ck, ckpt_every=4,
                   log_every=1000)
    jtr.run(4)
    tr = TTrainer(tc, TTrainConfig(**TRAIN), ckpt_dir=ck, log_every=1000,
                  device="cpu")
    assert tr.step_index() == 4
    assert int(tr.state["opt"]["count"]) == 4
    ref_logits, _, _ = JT.lm_apply(jtr.state["params"], jc,
                                   tokens=jnp.asarray(TOKENS), remat="none")
    with torch.no_grad():
        got, _, _ = TT.lm_apply(tr.state["params"], tc,
                                tokens=torch.tensor(TOKENS))
    _logits_close(ref_logits, got)
    ht, hj = tr.run(3), jtr.run(3)[-3:]
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], rtol=1e-5)


def test_int8_ef_residuals_resume(tmp_path):
    """With ``int8_ef`` the residuals are part of the state: written under
    ``ef`` and read back, so a resumed run equals an uninterrupted one."""
    _, tc = _cfgs()
    ck = str(tmp_path / "ck")
    tr = _port_trainer(tc, ck, ckpt_every=3, grad_compression="int8_ef")
    tr.run(3)
    assert "ef" in TCkpt(ck).restore(3)
    tail = tr.run(2)[-2:]
    tr2 = _port_trainer(tc, ck, grad_compression="int8_ef")
    assert tr2.step_index() == 3
    assert [h["loss"] for h in tr2.run(2)] == [h["loss"] for h in tail]


def test_resume_is_deterministic(tmp_path):
    """Train 10 steps with a checkpoint every 5, then a new trainer on the
    directory resumes at step 10; its next losses equal an uninterrupted
    13-step run's bit for bit."""
    _, tc = _cfgs(compute_dtype="bfloat16")
    ck = str(tmp_path / "ck")
    tr = _port_trainer(tc, ck, ckpt_every=5)
    tr.run(10)
    assert TCkpt(ck).steps() == [5, 10]
    tr2 = _port_trainer(tc, ck)
    assert tr2.step_index() == 10
    resumed = [h["loss"] for h in tr2.run(3)]
    assert all(np.isfinite(resumed))
    straight = [h["loss"] for h in _port_trainer(tc).run(13)[10:]]
    assert resumed == straight


def test_sigterm_saves_and_exits(tmp_path):
    _, tc = _cfgs()
    ck = str(tmp_path / "ck")
    tr = _port_trainer(tc, ck)
    inner = tr._train_step

    def step(state, batch):
        if int(state["step"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch)

    tr._train_step = step
    old = signal.getsignal(signal.SIGTERM)
    try:
        hist = tr.run(10)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert TCkpt(ck).steps() == [3]
