"""The port's recurrent cells against the reference, on the CPU:
``mamba_apply`` (jamba's SSM), ``mlstm_apply`` under both stabilizers
(``max``, the published cell, and ``consmax``) and ``slstm_apply``, each
over a whole sequence and as a whole-prompt prefill followed by one-token
decode steps; chunk invariance; the log-depth scan against a step loop.

Weights come from the reference's ``*_init`` (the consmax stabilizer's
``mu`` / ``gamma`` moved off their init values), inputs from numpy seeds,
at the jamba and xlstm smoke widths (d 128) and fp32 compute. Tolerance:
1e-5 of the largest |y|. Both sides run the same fp32 recurrences; the
reference's ``associative_scan`` combines the Mamba steps in another tree
than the port's doubling scan, and every sum runs in another order, so they
agree to rounding (measured ~2e-6 over 40 steps), not to the bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import XLSTMConfig as JXLSTMConfig
from repro.configs.registry import get_config as jget
from repro.models import mamba as JMB
from repro.models import xlstm as JXL
from repro.nn.module import Ctx
from repro_torch.configs.base import XLSTMConfig as TXLSTMConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import mamba as TMB
from repro_torch.models import xlstm as TXL

TOL = 1e-5
B, P, STEPS = 2, 16, 4


def _configs(cell, stabilizer="max", chunk=16):
    arch = "jamba-1.5-large-398b" if cell == "mamba" else "xlstm-1.3b"
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    if cell == "mamba":
        return (jc.replace(mamba=dataclasses.replace(jc.mamba, chunk=chunk)),
                tc.replace(mamba=dataclasses.replace(tc.mamba, chunk=chunk)))
    return (jc.replace(xlstm=JXLSTMConfig(chunk=chunk, stabilizer=stabilizer)),
            tc.replace(xlstm=TXLSTMConfig(chunk=chunk,
                                          stabilizer=stabilizer)))


CELLS = {
    "mamba": (JMB.mamba_init, JMB.mamba_apply, JMB.mamba_cache_init,
              TMB.Mamba, TMB.mamba_apply, TMB.mamba_cache_init),
    "mlstm": (JXL.mlstm_init, JXL.mlstm_apply, JXL.mlstm_cache_init,
              TXL.MLSTM, TXL.mlstm_apply, TXL.mlstm_cache_init),
    "slstm": (JXL.slstm_init, JXL.slstm_apply, JXL.slstm_cache_init,
              TXL.SLSTM, TXL.slstm_apply, TXL.slstm_cache_init),
}
CASES = [("mamba", "max"), ("mlstm", "max"), ("mlstm", "consmax"),
         ("slstm", "max"), ("slstm", "consmax")]


def _cell(cell, stabilizer="max", chunk=16):
    jc, tc = _configs(cell, stabilizer, chunk)
    jinit, japply, jcache, Mod, tapply, tcache = CELLS[cell]
    p = jinit(Ctx(random.key(0)), cell, jc)
    if "mu" in p:
        r = np.random.default_rng(9)
        p = dict(p, mu=jnp.asarray(0.5 + r.random(p["mu"].shape),
                                   jnp.float32))
        if "gamma" in p:
            p["gamma"] = jnp.asarray(1.0 + 4 * r.random(p["gamma"].shape),
                                     jnp.float32)
    mod = Mod(tc, device="cpu")
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in p.items()})
    return jc, tc, p, mod, japply, tapply, jcache, tcache


def _x(s, d, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, s, d))
            * scale).astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("cell,stabilizer", CASES)
@pytest.mark.parametrize("s", [16, 40])
def test_whole_sequence_matches_reference(cell, stabilizer, s):
    """s = 40 is not a chunk multiple: the last chunk is padded."""
    jc, tc, p, mod, japply, tapply, _, _ = _cell(cell, stabilizer)
    x = _x(s, jc.d_model, seed=s)
    jy, _ = japply(p, jnp.asarray(x), jc)
    with torch.no_grad():
        ty, cache = tapply(mod, torch.tensor(x), tc)
    assert cache is None
    _close(ty.numpy(), jy)


@pytest.mark.parametrize("cell,stabilizer", CASES)
def test_prefill_then_decode_matches_reference(cell, stabilizer):
    """A whole-prompt prefill of P tokens, then STEPS one-token steps on the
    returned state: each output and the final state equal the reference's,
    and the outputs equal the whole sequence's rows."""
    jc, tc, p, mod, japply, tapply, jcache, tcache = _cell(cell, stabilizer)
    x = _x(P + STEPS, jc.d_model, seed=1)
    jc_state = jcache(jc, B)
    tc_state = tcache(tc, B, device="cpu")
    jouts, touts = [], []
    with torch.no_grad():
        for sl in [slice(0, P)] + [slice(P + t, P + t + 1)
                                   for t in range(STEPS)]:
            jy, jc_state = japply(p, jnp.asarray(x[:, sl]), jc,
                                  cache=jc_state)
            ty, tc_state = tapply(mod, torch.tensor(x[:, sl]), tc,
                                  cache=tc_state)
            jouts.append(np.asarray(jy))
            touts.append(ty.numpy())
        whole, _ = tapply(mod, torch.tensor(x), tc)
    for j, t in zip(jouts, touts):
        _close(t, j)
    for key, leaf in tc_state.items():
        _close(leaf.float().numpy(), np.asarray(jc_state[key], np.float32))
    _close(np.concatenate(touts, axis=1), whole.numpy())


@pytest.mark.parametrize("cell,stabilizer", CASES[:3])
def test_chunk_invariance(cell, stabilizer):
    """The chunk length bounds memory only: chunks of 4 and of 16 give the
    same outputs and the same final state."""
    x = _x(32, 128, seed=2)
    outs = []
    for chunk in (4, 16):
        _, tc, _, mod, _, tapply, _, tcache = _cell(cell, stabilizer, chunk)
        with torch.no_grad():
            y, state = tapply(mod, torch.tensor(x), tc,
                              cache=tcache(tc, B, device="cpu"))
        outs.append((y.numpy(), state))
    _close(outs[0][0], outs[1][0])
    for key in outs[0][1]:
        _close(outs[0][1][key].float().numpy(),
               outs[1][1][key].float().numpy())


def test_prefill_refuses_a_ragged_chunk_tail():
    for cell in ("mamba", "mlstm", "slstm"):
        _, tc, _, mod, _, tapply, _, tcache = _cell(cell)
        with pytest.raises(ValueError, match="chunk"):
            tapply(mod, torch.zeros((B, 20, 128)), tc,
                   cache=tcache(tc, B, device="cpu"))


def test_linear_scan_matches_the_step_loop():
    r = np.random.default_rng(3)
    a = torch.tensor(r.uniform(0.5, 1.0, (2, 37, 3, 4)).astype(np.float32))
    b = torch.tensor(r.standard_normal((2, 37, 3, 4)).astype(np.float32))
    acum, h = TMB.linear_scan(a, b)
    hs, prod, ht = [], torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for t in range(a.shape[1]):
        ht = a[:, t] * ht + b[:, t]
        prod = prod * a[:, t]
        hs.append((prod, ht))
    torch.testing.assert_close(acum, torch.stack([p for p, _ in hs], 1))
    torch.testing.assert_close(h, torch.stack([x for _, x in hs], 1))


def test_mlstm_max_stabilizer_holds_large_log_gates():
    """Input-gate pre-activations near 100, where ``exp`` overflows fp32
    (past ~88.7): the running-max stabilizer keeps every output finite and
    equal to the reference's."""
    jc, tc, p, mod, japply, tapply, _, _ = _cell("mlstm")
    p = dict(p, b_ig=jnp.full_like(p["b_ig"], 100.0))
    with torch.no_grad():
        mod.b_ig.fill_(100.0)
    x = _x(32, jc.d_model, seed=4, scale=3.0)
    jy, _ = japply(p, jnp.asarray(x), jc)
    with torch.no_grad():
        ty, _ = tapply(mod, torch.tensor(x), tc)
    _close(ty.numpy(), jy)
