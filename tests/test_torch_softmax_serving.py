"""Serving the paper's baselines, softmax and softermax (base 2), through the
port's plain online walks, against the JAX reference.

* ``append_attention``, ``paged_attention`` and ``decode_attention`` with
  ``norm_kind`` softmax / softermax — GQA, a window, a softcap, ragged
  chunks, an inactive decode slot, a -1 page inside a fill, an int8 cache —
  within 1e-5 of the reference's fp32 outputs (both walks carry the online
  (m, l) state over the same blocks; they differ in summation order only).
* gpt2-consmax served with ``score_norm`` softmax and softermax (fp32
  compute): the port's contiguous and paged engines give the reference
  engine's tokens, and paged == contiguous.
* The kernel flags keep refusing both norms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.core import attention as JA
from repro.kernels import cache_layout as JCL
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import attention as TA
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import from_jax_params

NORMS = ["softmax", "softermax"]
B, L, HKV, G, DK, C = 3, 40, 2, 3, 16, 6


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _inputs(seed, kv="bfloat16"):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, C, HKV * G, DK)).astype(np.float32) * 0.5
    k = r.standard_normal((B, L, HKV, DK)).astype(np.float32)
    v = r.standard_normal((B, L, HKV, DK)).astype(np.float32)
    kq = k.astype(jnp.bfloat16)
    vq = v.astype(jnp.bfloat16)
    scales = {}
    if kv != "bfloat16":
        kq, ks = JCL.quantize_kv(jnp.asarray(k), jnp.int8)
        vq, vs = JCL.quantize_kv(jnp.asarray(v), jnp.int8)
        scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return q, np.asarray(kq), np.asarray(vq), scales


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


VARIANTS = [dict(), dict(window=7), dict(softcap=5.0)]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_append_and_decode_walks_match_reference(norm, kv):
    q, k, v, scales = _inputs(0, kv)
    index = np.array([0, 9, 30], np.int32)
    lengths = np.array([6, 3, 6], np.int32)
    ts = {n: _torch(a) for n, a in scales.items()}
    for kw in VARIANTS:
        common = dict(norm_kind=norm, norm_params=None, **kw)
        ref = JA.append_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(index), jnp.asarray(lengths), kv_chunk=16,
            **common, **{n: jnp.asarray(a) for n, a in scales.items()})
        got = TA.append_attention(
            torch.tensor(q), _torch(k), _torch(v), torch.tensor(index),
            torch.tensor(lengths), kv_chunk=16, **common, **ts)
        _close(got, ref)
        pos = np.array([0, 17, 39], np.int32)
        ref = JA.decode_attention(
            jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), **common,
            **{n: jnp.asarray(a) for n, a in scales.items()})
        got = TA.decode_attention(torch.tensor(q[:, :1]), _torch(k),
                                  _torch(v), torch.tensor(pos), **common,
                                  **ts)
        _close(got, ref)


@pytest.mark.parametrize("norm", NORMS)
def test_paged_walk_matches_reference(norm):
    """A (3, 6) chunk and a one-token decode (slot 1 inactive) over a pool of
    page size 4 with a random page table, -1 past each fill and one -1
    inside slot 2's fill."""
    q, k, v, _ = _inputs(1)
    ps, npg = 4, L // 4
    r = np.random.default_rng(2)
    perm = r.permutation(B * npg).astype(np.int32)
    table = perm.reshape(B, npg)
    kp = np.zeros((B * npg, ps, HKV, DK), k.dtype)
    vp = np.zeros_like(kp)
    for b in range(B):
        kp[table[b]] = k[b].reshape(npg, ps, HKV, DK)
        vp[table[b]] = v[b].reshape(npg, ps, HKV, DK)
    index = np.array([0, 9, 30], np.int32)
    for lengths, qq in ((np.array([6, 3, 6], np.int32), q),
                        (np.array([1, 0, 1], np.int32), q[:, :1])):
        tab = table.copy()
        for b in range(B):
            tab[b, -(-(index[b] + lengths[b]) // ps):] = -1
        tab[2, 3] = -1
        for kw in VARIANTS:
            common = dict(norm_kind=norm, norm_params=None, **kw)
            ref = JA.paged_attention(
                jnp.asarray(qq), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(tab), jnp.asarray(index), jnp.asarray(lengths),
                **common)
            got = TA.paged_attention(
                torch.tensor(qq), _torch(kp), _torch(vp), torch.tensor(tab),
                torch.tensor(index), torch.tensor(lengths), **common)
            _close(got[lengths > 0], np.asarray(ref)[lengths > 0])


SERVE = dict(max_seq=40, prefill_chunk=8, max_slots=3)
PAGED = dict(paged_kv=True, page_size=4, num_pages=24)


@pytest.mark.parametrize("norm", NORMS)
def test_softmax_engines_match_reference(norm):
    jc = jget("gpt2-consmax", smoke=True, compute_dtype="float32",
              score_norm=norm)
    tc = tget("gpt2-consmax", smoke=True, compute_dtype="float32",
              score_norm=norm)
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    r = np.random.default_rng(3)
    prompts = [r.integers(0, jc.vocab_size, n).tolist()
               for n in (5, 13, 3, 11)]
    budgets = [4, 5, 3, 4]

    def serve(eng):
        uids = [eng.submit(pr, n) for pr, n in zip(prompts, budgets)]
        results = eng.run(max_steps=300)
        return [results[u] for u in uids]

    ref = serve(JEngine(jc, JServeConfig(**SERVE), p))
    for extra in ({}, PAGED):
        eng = ContinuousBatchingEngine(tc, ServeConfig(**SERVE, **extra),
                                       model, device="cpu")
        assert serve(eng) == ref, extra
        assert (eng.prefill_cache_size, eng.decode_cache_size) == (1, 1)
    for flag in ("decode_kernel", "prefill_kernel"):
        with pytest.raises(ValueError, match="score_norm='consmax'"):
            ContinuousBatchingEngine(tc, ServeConfig(**SERVE, **{flag: True}),
                                     model, device="cpu")
