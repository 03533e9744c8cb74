"""The port's building blocks against the JAX reference, at fp32.

Layers, RoPE (both styles, partial), ConSmax and the normalizers, the
cache-layout helpers, and the config registry. Inputs come from
``np.random.default_rng`` and go through both packages. Tolerance: 1e-5
relative / 1e-6 absolute — both sides compute in fp32 and differ only in
summation order and libm ulps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import consmax as JC
from repro.core import normalizers as JN
from repro.kernels import cache_layout as JCL
from repro.nn import layers as JL
from repro.nn import rope as JR
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ServeConfig
from repro_torch.core import consmax as TC
from repro_torch.core import normalizers as TN
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.configs.base import ConSmaxConfig
from repro_torch.kernels import cache_layout as TCL
from repro_torch.nn import layers as TL
from repro_torch.nn import rope as TR

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(jx, tx, **tol):
    np.testing.assert_allclose(np.asarray(jx, np.float32),
                               tx.detach().float().numpy(), **(tol or TOL))


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- layers ----
def test_linear_and_head_projections():
    r = _rng(1)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    w = r.standard_normal((16, 24)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    f32 = dict(dtype=jnp.float32)
    _close(JL.linear({"w": w, "b": b}, x, **f32),
           TL.linear(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                     dtype=torch.float32))
    wh = r.standard_normal((16, 4, 8)).astype(np.float32)
    bh = r.standard_normal((4, 8)).astype(np.float32)
    _close(JL.heads_proj({"w": wh, "b": bh}, x, **f32),
           TL.heads_proj(torch.tensor(x), torch.tensor(wh), torch.tensor(bh),
                         dtype=torch.float32))
    xo = r.standard_normal((2, 3, 4, 8)).astype(np.float32)
    wo = r.standard_normal((4, 8, 16)).astype(np.float32)
    _close(JL.heads_out({"w": wo}, xo, **f32),
           TL.heads_out(torch.tensor(xo), torch.tensor(wo),
                        dtype=torch.float32))


def test_cast_copy_follows_in_place_writes():
    p = torch.nn.Parameter(torch.ones(4), requires_grad=False)
    first = TL.cast(p, torch.bfloat16)
    assert TL.cast(p, torch.bfloat16) is first          # made once
    with torch.no_grad():
        p.mul_(3.0)
    np.testing.assert_array_equal(TL.cast(p, torch.bfloat16).float(), 3.0)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    r = _rng(2)
    x = r.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    scale = r.standard_normal((32,)).astype(np.float32)
    bias = r.standard_normal((32,)).astype(np.float32)
    if kind == "rmsnorm":
        ref = JL.rmsnorm({"scale": scale}, x)
        got = TL.rmsnorm(torch.tensor(x), torch.tensor(scale))
    else:
        ref = JL.layernorm({"scale": scale, "bias": bias}, x)
        got = TL.layernorm(torch.tensor(x), torch.tensor(scale),
                           torch.tensor(bias))
    _close(ref, got)


def test_embed_and_tied_unembed():
    r = _rng(3)
    table = r.standard_normal((50, 16)).astype(np.float32)
    ids = r.integers(0, 50, (2, 7)).astype(np.int32)
    x = r.standard_normal((2, 7, 16)).astype(np.float32)
    _close(JL.embed({"table": table}, ids, dtype=jnp.float32),
           TL.embed(torch.tensor(table), torch.tensor(ids),
                    dtype=torch.float32))
    _close(JL.unembed({"table": table}, x, dtype=jnp.float32),
           TL.unembed(torch.tensor(table), torch.tensor(x),
                      dtype=torch.float32))


@pytest.mark.parametrize("interleaved,rotary_dim", [
    (False, None), (True, None), (False, 16), (True, 16)])
def test_rope(interleaved, rotary_dim):
    r = _rng(4)
    x = r.standard_normal((2, 6, 3, 32)).astype(np.float32)
    pos = r.integers(0, 500, (2, 6)).astype(np.int32)
    _close(JR.apply_rope(x, pos, rotary_dim=rotary_dim, theta=10000.0,
                         interleaved=interleaved),
           TR.apply_rope(torch.tensor(x), torch.tensor(pos),
                         rotary_dim=rotary_dim, theta=10000.0,
                         interleaved=interleaved),
           rtol=1e-5, atol=2e-5)   # fp32 sin/cos of angles up to 500 rad


# ------------------------------------------------------------ consmax ----
@pytest.mark.parametrize("merged", [False, True])
def test_consmax_forms_and_mask(merged):
    r = _rng(5)
    s = r.standard_normal((2, 4, 3, 9)).astype(np.float32) * 2
    mask = r.random((1, 1, 3, 9)) > 0.3
    beta = r.uniform(0.5, 2.5, (4,)).astype(np.float32)
    gamma = np.full((4,), 100.0, np.float32)
    ref = JC.consmax({"beta": beta, "gamma": gamma}, s, mask, head_axis=1,
                     merged=merged)
    got = TC.consmax(torch.tensor(beta), torch.tensor(gamma), torch.tensor(s),
                     torch.tensor(mask), head_axis=1, merged=merged)
    _close(ref, got)
    assert (got.numpy()[np.broadcast_to(~mask, got.shape)] == 0).all()


@pytest.mark.parametrize("kind", ["softmax", "softermax", "consmax"])
def test_normalizers_apply_norm(kind):
    r = _rng(6)
    s = r.standard_normal((2, 4, 3, 9)).astype(np.float32)
    mask = r.random((1, 1, 3, 9)) > 0.3
    mask[..., 0] = True
    beta = r.uniform(0.5, 2.5, (4,)).astype(np.float32)
    gamma = np.full((4,), 100.0, np.float32)
    params = ConSmaxParams(4, ConSmaxConfig())
    params.beta.data.copy_(torch.tensor(beta))
    params.gamma.data.copy_(torch.tensor(gamma))
    ref = JN.apply_norm(kind, {"beta": beta, "gamma": gamma}, s, mask,
                        head_axis=1, merged=True)
    got = TN.apply_norm(kind, params, torch.tensor(s), torch.tensor(mask),
                        head_axis=1, merged=True)
    _close(ref, got)


def test_consmax_init_distribution():
    cfg = ConSmaxConfig(beta_init_lo=0.5, beta_init_hi=2.5, gamma_init=100.0)
    p = ConSmaxParams(64, cfg)
    p.reset_parameters(torch.Generator().manual_seed(0))
    assert ((p.beta >= 0.5) & (p.beta <= 2.5)).all()
    assert (p.gamma == 100.0).all()
    shared = ConSmaxParams(64, dataclasses.replace(cfg, per_head=False))
    assert shared.beta.shape == (1,)


# ------------------------------------------------------- cache layout ----
def test_divisor_block_and_gqa_folding():
    for n, bk in [(64, 16), (200, 64), (101, 32), (8, 128)]:
        assert TCL.divisor_block(n, bk) == JCL.divisor_block(n, bk)
    r = _rng(7)
    q = r.standard_normal((2, 5, 6, 8)).astype(np.float32)
    ref = JCL.fold_gqa(q, 2)
    got = TCL.fold_gqa(torch.tensor(q), 2)
    _close(ref, got, rtol=0, atol=0)
    _close(JCL.unfold_gqa(ref, 2, 5, 6),
           TCL.unfold_gqa(got, 2, 5, 6), rtol=0, atol=0)
    beta = r.standard_normal((6,)).astype(np.float32)
    gamma = r.standard_normal((6,)).astype(np.float32)
    for jx, tx in zip(JCL.tile_head_params(beta, gamma, 2, 5),
                      TCL.tile_head_params(torch.tensor(beta),
                                           torch.tensor(gamma), 2, 5)):
        _close(jx, tx, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 3])
def test_kv_mask_and_fill_bounding(window):
    qpos = np.arange(12)[:, None]
    kpos = np.arange(16)[None, :]
    for kv_len in (0, 5, 12):
        np.testing.assert_array_equal(
            np.asarray(JCL.kv_mask(qpos, kpos, kv_len, window)),
            TCL.kv_mask(torch.tensor(qpos), torch.tensor(kpos), kv_len,
                        window).numpy())
    starts = np.arange(0, 64, 8)
    for kv_len, lo, hi in [(0, 0, 0), (9, 3, 8), (64, 40, 63)]:
        np.testing.assert_array_equal(
            np.asarray(JCL.shard_live(jnp.asarray(starts), 8, kv_len,
                                      qpos_hi=hi, qpos_lo=lo,
                                      window=window)),
            TCL.shard_live(torch.tensor(starts), 8, kv_len, qpos_hi=hi,
                           qpos_lo=lo, window=window).numpy())
    lens = np.array([0, 1, 8, 9, 64], np.int32)
    np.testing.assert_array_equal(
        np.asarray(JCL.live_blocks(jnp.asarray(lens), 8, 8)),
        TCL.live_blocks(torch.tensor(lens), 8, 8).numpy())


def test_fill_bounded_sum_ignores_unwritten_slots():
    r = _rng(8)
    parts = r.standard_normal((2, 3, 5, 4)).astype(np.float32)
    parts[:, :, 3:] = np.nan                     # never written
    ref = JCL.fill_bounded_sum(jnp.asarray(parts), 3)
    got = TCL.fill_bounded_sum(torch.tensor(parts), 3)
    _close(ref, got)
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("merged", [False, True])
def test_consmax_weights(merged):
    r = _rng(9)
    s = r.standard_normal((3, 7)).astype(np.float32)
    beta = r.uniform(0.5, 2.5, (3, 1)).astype(np.float32)
    gamma = np.full((3, 1), 100.0, np.float32)
    _close(JCL.consmax_weights(s, beta, gamma, merged),
           TCL.consmax_weights(torch.tensor(s), torch.tensor(beta),
                               torch.tensor(gamma), merged))


def test_kv_cache_dtype_bf16_only():
    # the name predates the quantized caches: bf16 is the only unscaled one
    assert TCL.kv_cache_dtype("bfloat16") == torch.bfloat16
    assert TCL.kv_cache_dtype("bf16") == torch.bfloat16
    assert TCL.kv_cache_dtype("int8") == torch.int8
    assert TCL.kv_cache_dtype("fp8_e4m3") == torch.float8_e4m3fn
    assert [TCL.kv_quantized(n) for n in ("bf16", "int8", "fp8_e4m3")] == [
        False, True, True]
    assert (TCL.kv_qmax("int8"), TCL.kv_qmax("fp8_e4m3")) == (127.0, 448.0)
    with pytest.raises(ValueError):
        TCL.kv_cache_dtype("float64")
    with pytest.raises(ValueError):
        TCL.kv_qmax("bfloat16")


# ------------------------------------------------------------ configs ----
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_reference(smoke):
    for arch in [*jreg.ARCH_IDS, "gpt2-consmax"]:
        ref = dataclasses.asdict(jreg.get_config(arch, smoke=smoke))
        got = dataclasses.asdict(treg.get_config(arch, smoke=smoke))
        assert got == ref, arch
    cfg = treg.get_config("qwen2-1.5b")
    assert cfg.cdtype() == torch.bfloat16 and cfg.pdtype() == torch.float32


def test_serve_config_checks_match_reference():
    from repro.configs.base import ServeConfig as JServeConfig
    for kw in (dict(prefill_chunk=64, max_seq=32),
               dict(kv_cache_dtype="fp16"),
               dict(decode_kernel=True, score_norm="softmax"),
               dict(paged_kv=True, prefill_chunk=48, page_size=32),
               dict(tp=0)):
        with pytest.raises(ValueError):
            JServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    assert ServeConfig(max_seq=100).prefill_chunk == \
        JServeConfig(max_seq=100).prefill_chunk == 100
