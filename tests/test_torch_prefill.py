"""The port's chunked append-at-index prefill against the JAX reference.

* ``consmax_prefill_ref`` (the plain version beside the CUDA kernel, and
  what ``consmax_prefill_op`` computes for CPU tensors) vs the reference's
  ``consmax_prefill_ref`` and its plain walk ``append_attention``, across
  GQA / MQA / MHA, sliding window, softcap, merged on/off, a 0-length slot
  and a fill sweep {1, block boundary, mid, full}. The MQA ``L=200, c=5``
  merged shape, whose Pallas output is red in the reference's own tests, is
  held against the reference's oracle and walk, never against the Pallas
  output.
* ``core.attention.append_attention`` (the plain walk) vs the reference's.
* ``_append_cache_write``'s clamped read-modify-write window, and
  ``attention_apply``'s chunk branch (pad rows never enter the cache), and
  ``lm_apply`` over a ragged chunk, at ``prefill_kv_block=8`` on both
  sides (the reference's Pallas kernel in interpret mode).
* ``cache_layout.prefill_shards``, the CUDA kernels' KV-shard geometry:
  whole 64-row tiles, at most 64 shards covering L, the reference's shard
  count where its divisor rule and the tile rounding agree.

Inputs come from ``np.random.default_rng``. Tolerance at fp32: rtol 1e-5,
atol 1e-5 — the same fp32 products, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.registry import get_config as jget
from repro.core import attention as JA
from repro.kernels import cache_layout as JCL
from repro.kernels.consmax_prefill.kernel import MAX_KV_SHARDS
from repro.kernels.consmax_prefill.ref import consmax_prefill_ref as jref
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro_torch.configs.base import ConSmaxConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import attention as TA
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_op
from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
D, BK = 32, 16
SHAPES = {  # H, hkv, L, c
    "gqa": (8, 2, 64, 8),
    "mha": (4, 4, 64, 8),
    "mqa-L200-c5": (4, 1, 200, 5),
}
VARIANTS = {"plain": dict(), "window": dict(window=12),
            "softcap": dict(softcap=5.0), "unmerged": dict(merged=False)}


def _slots(L, c):
    """(index, lengths): a 0-length slot, then chunks ending at one row,
    a block boundary, mid-block and the full cache."""
    ends = [1, BK, 2 * BK + 3, L]
    index = [0] + [max(0, e - c) for e in ends]
    lengths = [0] + [e - i for e, i in zip(ends, index[1:])]
    return np.array(index, np.int32), np.array(lengths, np.int32)


def _inputs(H, hkv, L, c, seed=0):
    r = np.random.default_rng(seed)
    index, lengths = _slots(L, c)
    b = len(index)
    q = r.standard_normal((b, c, H, D)).astype(np.float32) * D ** -0.5
    k = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    v = r.standard_normal((b, L, hkv, D)).astype(np.float32)
    beta = r.uniform(0.5, 2.5, H).astype(np.float32)
    gamma = np.full((H,), 100.0, np.float32)
    return q, k, v, index, lengths, beta, gamma


def _norm_params(beta, gamma):
    p = ConSmaxParams(len(beta), ConSmaxConfig())
    with torch.no_grad():
        p.beta.copy_(torch.tensor(beta))
        p.gamma.copy_(torch.tensor(gamma))
    return p


def _real_rows(out, lengths):
    """Rows < lengths only: pad-row outputs are discarded by every caller."""
    c = out.shape[1]
    return np.asarray(out, np.float32)[np.arange(c)[None] < lengths[:, None]]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_prefill_matches_reference_oracle_and_walk(shape, variant):
    q, k, v, index, lengths, beta, gamma = _inputs(*SHAPES[shape])
    kw = dict(window=0, softcap=0.0, merged=True)
    kw.update(VARIANTS[variant])
    got = consmax_prefill_ref(*[torch.tensor(a) for a in
                                (q, k, v, index, lengths, beta, gamma)],
                              scale=1.0, **kw)
    ref = jref(q, k, v, jnp.asarray(index), jnp.asarray(lengths), beta,
               gamma, scale=1.0, **kw)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    walk = JA.append_attention(q, k, v, jnp.asarray(index),
                               jnp.asarray(lengths), norm_kind="consmax",
                               norm_params={"beta": beta, "gamma": gamma},
                               kv_chunk=BK, **kw)
    np.testing.assert_allclose(_real_rows(walk, lengths),
                               _real_rows(got, lengths), **TOL)
    assert (got[0] == 0).all()                   # the 0-length slot


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_append_walk_and_op_match_reference(shape, variant):
    q, k, v, index, lengths, beta, gamma = _inputs(*SHAPES[shape], seed=1)
    kw = dict(window=0, softcap=0.0, merged=True)
    kw.update(VARIANTS[variant])
    ref = JA.append_attention(q, k, v, jnp.asarray(index),
                              jnp.asarray(lengths), norm_kind="consmax",
                              norm_params={"beta": beta, "gamma": gamma},
                              kv_chunk=BK, **kw)
    tq, tk, tv, ti, tl = [torch.tensor(a) for a in (q, k, v, index, lengths)]
    got = TA.append_attention(tq, tk, tv, ti, tl, norm_kind="consmax",
                              norm_params=_norm_params(beta, gamma),
                              kv_chunk=BK, **kw)
    np.testing.assert_allclose(_real_rows(ref, lengths),
                               _real_rows(got, lengths), **TOL)
    n0 = consmax_prefill_op.launches
    op = consmax_prefill_op(tq, tk, tv, ti, tl, torch.tensor(beta),
                            torch.tensor(gamma), scale=1.0, **kw)
    np.testing.assert_allclose(_real_rows(ref, lengths),
                               _real_rows(op, lengths), **TOL)
    assert consmax_prefill_op.launches == n0     # CPU: the plain version


def test_append_cache_write_clamps_window_at_cache_end():
    r = np.random.default_rng(3)
    L, c = 20, 8
    cache = r.standard_normal((4, L, 2, 4)).astype(np.float32)
    new = r.standard_normal((4, c, 2, 4)).astype(np.float32)
    index = np.array([0, 5, 15, 20], np.int32)     # ragged tails near L
    ref = JA._append_cache_write(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(index))
    got = torch.tensor(cache)
    TA._append_cache_write(got, torch.tensor(new), torch.tensor(index))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("prefill_kernel", [False, True])
def test_attention_apply_chunk_branch(prefill_kernel):
    """Pad rows zeroed before the write, ``index`` advanced by the real
    length, and the output of the real rows vs the reference's branch with
    the same kernel flag (the reference's Pallas kernel in interpret
    mode)."""
    jcfg = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    p = JA.attention_init(Ctx(random.key(0)), "attn", jcfg)
    tp = TA.Attention(tcfg)
    tp.load_state_dict({f"{m}.{n}": torch.tensor(np.asarray(a))
                        for m, leaves in p.items() for n, a in leaves.items()})
    r = np.random.default_rng(4)
    b, c, L, hkv, dk = 3, 8, 32, jcfg.n_kv_heads, jcfg.head_dim_
    x = r.standard_normal((b, c, jcfg.d_model)).astype(np.float32)
    index = np.array([0, 13, 28], np.int32)
    lengths = np.array([8, 3, 4], np.int32)
    kc = np.zeros((b, L, hkv, dk), np.float32)
    kc[1, :13] = r.standard_normal((13, hkv, dk))
    kc[2, :28] = r.standard_normal((28, hkv, dk))
    jcache = {"k": jnp.asarray(kc, jnp.bfloat16),
              "v": jnp.asarray(kc[:, ::-1].copy(), jnp.bfloat16),
              "index": jnp.asarray(index)}
    tcache = {key: torch.tensor(np.asarray(val, np.float32)).bfloat16()
              if key != "index" else torch.tensor(index)
              for key, val in jcache.items()}
    kw = dict(merged=True, prefill_kernel=prefill_kernel, kv_chunk=8,
              prefill_kv_block=8)
    jout, jnew = JA.attention_apply(p, jnp.asarray(x), jcfg, cache=jcache,
                                    prefill_append=jnp.asarray(lengths),
                                    **kw)
    tout, tnew = TA.attention_apply(tp, torch.tensor(x), tcfg, cache=tcache,
                                    prefill_append=torch.tensor(lengths),
                                    **kw)
    np.testing.assert_array_equal(index + lengths, tnew["index"].numpy())
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jnew[key], np.float32),
                                   tnew[key].float().numpy(), rtol=2 ** -7,
                                   atol=1e-6)
    # slot 1's pad rows 16.. stay zero; slot 2's chunk ends at the last row
    assert (tnew["k"][1, 16:] == 0).all()
    np.testing.assert_allclose(_real_rows(jout, lengths),
                               _real_rows(tout, lengths), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("prefill_kernel", [False, True])
def test_lm_apply_chunk_at_prefill_kv_block(prefill_kernel):
    """A ragged chunk through ``lm_apply`` with ``prefill_kv_block=8`` on
    both sides (the reference's Pallas kernel in interpret mode, the port's
    plain version on the CPU): the logits at each slot's last real row
    (fp32, rtol / atol 1e-4: two layers of the same products, summed in
    another order) and the advanced index."""
    jc = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    tc = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    r = np.random.default_rng(5)
    b, c, L = 3, 8, 40
    toks = r.integers(0, jc.vocab_size, (b, c)).astype(np.int32)
    lens = np.array([8, 3, 6], np.int32)
    kw = dict(merged=True, prefill_kernel=prefill_kernel,
              prefill_kv_block=8)
    jlg, jcache, _ = JT.lm_apply(
        p, jc, tokens=jnp.asarray(toks), caches=JT.init_caches(jc, b, L),
        prefill_append=jnp.asarray(lens),
        logits_index=jnp.asarray(lens - 1), **kw)
    with torch.no_grad():
        tlg, tcache, _ = TT.lm_apply(
            model, tc, tokens=torch.tensor(toks),
            caches=TT.init_caches(tc, b, L, device="cpu"),
            prefill_append=torch.tensor(lens),
            logits_index=torch.tensor(lens - 1), **kw)
    np.testing.assert_array_equal(np.asarray(JT.cache_index(jcache)),
                                  TT.cache_index(tcache).numpy())
    np.testing.assert_allclose(np.asarray(jlg, np.float32),
                               tlg.float().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [40, 64, 200, 512, 4096, 8192, 65536, 262144])
@pytest.mark.parametrize("bk", [1, 8, 16, 64, 100, 256, 512, 1024, 1 << 20])
def test_prefill_shards_geometry(L, bk):
    """Whole 64-row tiles, at most 64 shards, the shards cover L and the
    last one holds a row; exact integer arithmetic, no tolerance. For L a
    multiple of 64 and bk a power of two >= 64 (the engine's shapes) the
    shard count is the reference's (``block_cache_rows`` on
    ``max(bk, ceil(L / MAX_KV_SHARDS))``); a bk below the tile is one
    64-row shard per tile of ``ceil(L / 64)``, capped the same way."""
    rows, ns = CL.prefill_shards(L, bk)
    assert rows % 64 == 0 and rows >= min(bk, 64)
    assert 1 <= ns <= CL.MAX_KV_SHARDS == MAX_KV_SHARDS
    assert (ns - 1) * rows < L <= ns * rows
    if L % 64 == 0 and bk >= 64 and bk & (bk - 1) == 0:
        jk = jnp.zeros((1, L, 1, 1), jnp.bfloat16)
        _, _, jbk, jns = JCL.block_cache_rows(
            jk, jk, max(bk, -(-L // MAX_KV_SHARDS)))
        assert ns == jns and (rows == jbk or bk >= L)


def test_prefill_shards_refuses_a_nonpositive_block():
    with pytest.raises(ValueError, match="prefill_kv_block"):
        CL.prefill_shards(64, 0)
