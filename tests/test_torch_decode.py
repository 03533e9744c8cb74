"""The port's one-token decode attention against the JAX reference.

* ``consmax_decode_ref`` (the plain version beside the CUDA kernel, and what
  ``consmax_decode_op`` computes for CPU tensors) vs the reference's
  ``consmax_decode_ref`` oracle, across GQA / MQA / MHA, sliding window,
  softcap, merged on/off and a fill sweep {0, 1, block boundary, mid, full}.
* ``core.attention.decode_attention`` (the plain row walk) vs the
  reference's ``decode_attention``.
* ``attention_apply``'s decode branch vs the reference's: the K/V row
  write at ``index``, inactive slots keeping their row and index, and the
  output with both kernel flags.
* ``consmax_decode_op`` and ``consmax_decode_paged_op`` on the CPU at the
  CUDA kernel's tile-walk edges (fills on and one past a 32-row tile
  boundary inside a shard; page size 4, eight pages per tile, and 12,
  which does not divide a tile) vs the reference's oracle.

Inputs come from ``np.random.default_rng``. Tolerance at fp32: rtol 1e-5,
atol 1e-5 — both sides compute the same fp32 products and differ only in
summation order and libm ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.registry import get_config as jget
from repro.core import attention as JA
from repro.kernels.consmax_decode.ref import consmax_decode_ref as jref
from repro.nn.module import Ctx
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import attention as TA
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.configs.base import ConSmaxConfig
from repro_torch.kernels.consmax_decode.ops import (consmax_decode_op,
                                                    consmax_decode_paged_op)
from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref

TOL = dict(rtol=1e-5, atol=1e-5)
L, D, BK = 64, 32, 16
SHAPES = {"gqa": (8, 2), "mqa": (4, 1), "mha": (4, 4)}     # H, hkv
FILLS = [0, 1, BK, 2 * BK + 3, L]                           # valid rows
VARIANTS = {"plain": dict(), "window": dict(window=24),
            "softcap": dict(softcap=5.0), "unmerged": dict(merged=False)}


def _inputs(H, hkv, b=len(FILLS), seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, H, D)).astype(np.float32) * D ** -0.5
    k = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    v = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    beta = r.uniform(0.5, 2.5, H).astype(np.float32)
    gamma = np.full((H,), 100.0, np.float32)
    return q, k, v, beta, gamma


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_decode_matches_reference_oracle(shape, variant):
    H, hkv = SHAPES[shape]
    q, k, v, beta, gamma = _inputs(H, hkv)
    lengths = np.array(FILLS, np.int32)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    kw.update(VARIANTS[variant])
    # the reference oracle takes the cache transposed to (b, hkv, L, d)
    ref = jref(q, k.swapaxes(1, 2), v.swapaxes(1, 2), lengths, beta, gamma,
               **kw)
    got = consmax_decode_ref(*_t(q, k, v, lengths, beta, gamma), **kw)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    # a slot with no valid row is exact zeros
    assert (got[0] == 0).all()


def test_plain_decode_bf16_inputs_within_one_ulp():
    q, k, v, beta, gamma = _inputs(8, 2)
    lengths = np.array(FILLS, np.int32)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v)]
    ref = jref(*[jnp.asarray(a) for a in bf[:1]],
               *[jnp.asarray(a).swapaxes(1, 2) for a in bf[1:]],
               lengths, beta, gamma, scale=1.0)
    got = consmax_decode_ref(
        *[torch.tensor(np.asarray(a, np.float32)).bfloat16() for a in bf],
        torch.tensor(lengths), torch.tensor(beta), torch.tensor(gamma),
        scale=1.0)
    assert got.dtype == torch.bfloat16
    # fp32 sums in another order, rounded to bf16: one bf16 ulp (2^-7)
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               got.float().numpy(), rtol=2 ** -7, atol=1e-6)


def _norm_params(beta, gamma):
    p = ConSmaxParams(len(beta), ConSmaxConfig())
    with torch.no_grad():
        p.beta.copy_(torch.tensor(beta))
        p.gamma.copy_(torch.tensor(gamma))
    return p


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_walk_and_op_match_reference(shape, variant):
    H, hkv = SHAPES[shape]
    q, k, v, beta, gamma = _inputs(H, hkv, seed=1)
    index = np.array(FILLS[1:], np.int32) - 1          # row being decoded
    q, k, v = q[1:, None], k[1:], v[1:]
    kw = dict(window=0, softcap=0.0, merged=True)
    kw.update(VARIANTS[variant])
    ref = JA.decode_attention(q, k, v, jnp.asarray(index),
                              norm_kind="consmax",
                              norm_params={"beta": beta, "gamma": gamma},
                              **kw)
    tq, tk, tv, ti = _t(q, k, v, index)
    got = TA.decode_attention(tq, tk, tv, ti, norm_kind="consmax",
                              norm_params=_norm_params(beta, gamma), **kw)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    n0 = consmax_decode_op.launches
    op = consmax_decode_op(tq, tk, tv, ti, *_t(beta, gamma), scale=1.0, **kw)
    np.testing.assert_allclose(np.asarray(ref), op.numpy(), **TOL)
    assert consmax_decode_op.launches == n0      # CPU: the plain version


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_attention_apply_decode_branch(decode_kernel):
    """Row write at ``index``, inactive slots untouched (row and index),
    output vs the reference's branch with the same kernel flag (the
    reference's Pallas kernel runs in interpret mode)."""
    jcfg = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    p = JA.attention_init(Ctx(random.key(0)), "attn", jcfg)
    tp = TA.Attention(tcfg)
    tp.load_state_dict({f"{m}.{n}": torch.tensor(np.asarray(a))
                        for m, leaves in p.items() for n, a in leaves.items()})
    r = np.random.default_rng(2)
    b, hkv, dk = 3, jcfg.n_kv_heads, jcfg.head_dim_
    x = r.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    kc = r.standard_normal((b, 32, hkv, dk)).astype(np.float32)
    vc = r.standard_normal((b, 32, hkv, dk)).astype(np.float32)
    index = np.array([5, 0, 31], np.int32)
    active = np.array([True, False, True])
    jcache = {"k": jnp.asarray(kc, jnp.bfloat16),
              "v": jnp.asarray(vc, jnp.bfloat16), "index": jnp.asarray(index)}
    tcache = {"k": torch.tensor(kc).bfloat16(), "v": torch.tensor(vc).bfloat16(),
              "index": torch.tensor(index)}
    kw = dict(merged=True, decode_kernel=decode_kernel, decode_kv_block=8)
    jout, jnew = JA.attention_apply(p, jnp.asarray(x), jcfg, cache=jcache,
                                    decode_active=jnp.asarray(active), **kw)
    tout, tnew = TA.attention_apply(tp, torch.tensor(x), tcfg, cache=tcache,
                                    decode_active=torch.tensor(active), **kw)
    np.testing.assert_array_equal(np.asarray(jnew["index"]),
                                  tnew["index"].numpy())
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jnew[key], np.float32),
                                   tnew[key].float().numpy(), rtol=2 ** -7,
                                   atol=1e-6)
    assert torch.equal(tnew["k"][1], torch.tensor(kc[1]).bfloat16())
    np.testing.assert_allclose(np.asarray(jout)[active],
                               tout.numpy()[active], rtol=1e-4, atol=1e-4)


# the CUDA kernel walks each bk-row shard in 32-row tiles: fills on and one
# past a tile boundary inside shard 0 (32, 33) and shard 1 (bk + 32, + 33)
WALK_BK = 128
WALK_FILLS = [32, 33, WALK_BK + 32, WALK_BK + 33]


@pytest.mark.parametrize("ps", [4, 12])
@pytest.mark.parametrize("shape", SHAPES)
def test_ops_at_tile_walk_edges_match_reference_oracle(shape, ps):
    """Both decode ops on CPU tensors (their plain versions), contiguous and
    through a shuffled page table (-1 past each fill), at the kernel's tile
    edges, against the reference's oracle on the contiguous rows."""
    H, hkv = SHAPES[shape]
    b, L = len(WALK_FILLS), 192
    r = np.random.default_rng(7)
    q = r.standard_normal((b, H, D)).astype(np.float32) * D ** -0.5
    k = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    v = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    beta = r.uniform(0.5, 2.5, H).astype(np.float32)
    gamma = np.full((H,), 100.0, np.float32)
    lengths = np.array(WALK_FILLS, np.int32)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    ref = np.asarray(jref(q, k.swapaxes(1, 2), v.swapaxes(1, 2), lengths,
                          beta, gamma, **kw))
    npg = -(-L // ps)
    perm = r.permutation(b * npg + 2)
    table = np.full((b, npg), -1, np.int32)
    kp = np.zeros((b * npg + 2, ps, hkv, D), np.float32)
    vp = np.zeros_like(kp)
    for s in range(b):
        for j in range(-(-int(lengths[s]) // ps)):
            table[s, j] = perm[s * npg + j]
            n = min(ps, L - j * ps)
            kp[table[s, j], :n] = k[s, j * ps:j * ps + n]
            vp[table[s, j], :n] = v[s, j * ps:j * ps + n]
    tq, tk, tv, tb, tg = _t(q, k, v, beta, gamma)
    n0 = (consmax_decode_op.launches, consmax_decode_paged_op.launches)
    got = consmax_decode_op(tq[:, None], tk, tv, torch.tensor(lengths - 1),
                            tb, tg, bk=WALK_BK, **kw)[:, 0]
    paged = consmax_decode_paged_op(tq[:, None], *_t(kp, vp, table, lengths),
                                    tb, tg, bk=WALK_BK, **kw)[:, 0]
    assert (consmax_decode_op.launches,
            consmax_decode_paged_op.launches) == n0   # CPU: plain versions
    np.testing.assert_allclose(ref, got.numpy(), **TOL)
    np.testing.assert_allclose(ref, paged.numpy(), **TOL)
