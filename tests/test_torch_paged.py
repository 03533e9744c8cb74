"""The port's paged-KV modules against the JAX reference, on the CPU.

* ``_paged_cache_write`` vs the reference's scatter: exact, with a shuffled
  table, pad rows, -1 entries and rows past the table (the port's pool
  carries one spare page that takes the dropped rows; pages [0, P) are
  compared).
* ``paged_attention`` vs the reference's at fp32: GQA, window, softcap,
  unmerged, a one-token decode (c = 1) and a chunk (c > 1).
* ``consmax_{decode,prefill}_paged_op`` (the plain versions, what the ops
  compute for CPU tensors) vs the reference's Pallas ops in interpret mode.
* The plain paged ops equal the plain contiguous ops on the same rows.
* ``init_paged_caches`` / ``reset_slot_paged`` / ``set_slot_index`` /
  ``copy_kv_page`` vs the reference's.
* ``lm_apply`` with paged caches vs the reference's on the qwen2 and
  gpt2-consmax smoke configs at fp32: two chunks of chunked prefill, then
  one-token decodes with ``decode_active``.

Inputs come from ``np.random.default_rng``. Tolerances: fp32 attention
rtol 1e-5, atol 1e-5 (the same fp32 products, summed in another order);
the Pallas ops in interpret mode atol 1e-5 (as ``tests/test_paged_kv.py``
holds them against the jnp walk); logits 1e-5 of the largest reference
logit (``tests/test_torch_model.py``'s fp32 bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.registry import get_config as jget
from repro.core import attention as JA
from repro.kernels.consmax_decode.ops import \
    consmax_decode_paged_op as jdecode_paged
from repro.kernels.consmax_prefill.ops import \
    consmax_prefill_paged_op as jprefill_paged
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro_torch.configs.base import ConSmaxConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.core import attention as TA
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_decode.ops import (consmax_decode_op,
                                                    consmax_decode_paged_op)
from repro_torch.kernels.consmax_prefill.ops import (consmax_prefill_op,
                                                     consmax_prefill_paged_op)
from repro_torch.models import transformer as TT
from repro_torch.weights import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's paged-kernel test shapes (tests/test_paged_kv.py:461)
B, H, HKV, DK, PS, P = 3, 4, 2, 32, 8, 10
TABLE = np.array([[3, 1, -1, -1], [5, 0, 2, 7], [9, -1, -1, -1]], np.int32)
VARIANTS = {"plain": dict(), "window": dict(window=6),
            "softcap": dict(softcap=30.0), "unmerged": dict(merged=False)}


def _pools(seed=0, pages=P):
    r = np.random.default_rng(seed)
    kp = r.standard_normal((pages, PS, HKV, DK)).astype(np.float32)
    vp = r.standard_normal((pages, PS, HKV, DK)).astype(np.float32)
    beta = np.linspace(0.5, 2.5, H).astype(np.float32)
    gamma = np.full((H,), 100.0, np.float32)
    return r, kp, vp, beta, gamma


def _norm_params(beta, gamma):
    p = ConSmaxParams(len(beta), ConSmaxConfig())
    with torch.no_grad():
        p.beta.copy_(torch.tensor(beta))
        p.gamma.copy_(torch.tensor(gamma))
    return p


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def test_paged_cache_write_matches_reference_exactly():
    r = np.random.default_rng(1)
    pages = 2 * P
    pool = r.standard_normal((pages, PS, HKV, DK)).astype(np.float32)
    c = 12
    new = r.standard_normal((4, c, HKV, DK)).astype(np.float32)
    # slots own disjoint pages (the PagePool invariant), shuffled
    table = r.permutation(pages)[:16].reshape(4, 4).astype(np.int32)
    table[1, 2] = -1                        # unmapped page inside the chunk
    table[3, 1:] = -1
    index = np.array([0, 9, 27, 2], np.int32)   # slot 2 runs past the table
    lengths = np.array([12, 10, 12, 5], np.int32)  # pad rows in slots 1, 3
    ref = JA._paged_cache_write(jnp.asarray(pool), jnp.asarray(new),
                                jnp.asarray(index), jnp.asarray(lengths),
                                jnp.asarray(table))
    spare = np.zeros((1, PS, HKV, DK), np.float32)
    got = torch.tensor(np.concatenate([pool, spare]))
    TA._paged_cache_write(got, *_t(new, index, lengths, table))
    np.testing.assert_array_equal(np.asarray(ref), got[:pages].numpy())
    assert not np.array_equal(np.asarray(ref), pool)  # something was written


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_attention_matches_reference(variant, c):
    r, kp, vp, beta, gamma = _pools(2)
    q = r.standard_normal((B, c, H, DK)).astype(np.float32) * 0.3
    index = np.array([12 - c + 1, 27 - c + 1, 3], np.int32)
    lengths = np.array([c, c, 1 if c == 1 else c - 2], np.int32)
    kw = dict(window=0, softcap=0.0, merged=True) | VARIANTS[variant]
    ref = JA.paged_attention(*map(jnp.asarray, (q, kp, vp, TABLE, index,
                                                lengths)),
                             norm_kind="consmax",
                             norm_params={"beta": beta, "gamma": gamma}, **kw)
    got = TA.paged_attention(*_t(q, kp, vp, TABLE, index, lengths),
                             norm_kind="consmax",
                             norm_params=_norm_params(beta, gamma), **kw)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_paged_decode_op_matches_reference_kernel(variant):
    r, kp, vp, beta, gamma = _pools(3)
    q = r.standard_normal((B, 1, H, DK)).astype(np.float32) * 0.3
    lengths = np.array([13, 28, 0], np.int32)       # slot 2: a free slot
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | \
        VARIANTS[variant]
    ref = jdecode_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(TABLE), jnp.asarray(lengths),
                        jnp.asarray(beta), jnp.asarray(gamma), **kw)
    n0 = consmax_decode_paged_op.launches
    got = consmax_decode_paged_op(*_t(q, kp, vp, TABLE, lengths, beta, gamma),
                                  **kw)
    assert consmax_decode_paged_op.launches == n0   # CPU: the plain version
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_paged_prefill_op_matches_reference_kernel(variant):
    r, kp, vp, beta, gamma = _pools(4)
    c = 6
    q = r.standard_normal((B, c, H, DK)).astype(np.float32) * 0.3
    index = np.array([8, 20, 0], np.int32)
    lengths = np.array([6, 6, 4], np.int32)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | \
        VARIANTS[variant]
    ref = jprefill_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(TABLE), jnp.asarray(index),
                         jnp.asarray(lengths), jnp.asarray(beta),
                         jnp.asarray(gamma), **kw)
    n0 = consmax_prefill_paged_op.launches
    got = consmax_prefill_paged_op(*_t(q, kp, vp, TABLE, index, lengths,
                                       beta, gamma), **kw)
    assert consmax_prefill_paged_op.launches == n0
    # rows >= lengths are pad rows: compared where real
    real = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(np.asarray(ref)[real], got.numpy()[real],
                               atol=1e-5)


def test_plain_paged_ops_equal_plain_contiguous_ops_on_the_same_rows():
    """The pages' rows moved into a contiguous cache: the plain paged ops
    return the plain contiguous ops' values exactly (gather_pages is a
    copy; the -1 pages are zeros in both)."""
    r, kp, vp, beta, gamma = _pools(5)
    tk, tv, tt = _t(kp, vp, TABLE)
    k, v = CL.gather_pages(tk, tt), CL.gather_pages(tv, tt)
    assert k.shape == (B, TABLE.shape[1] * PS, HKV, DK)
    assert (k[2, PS:] == 0).all()
    q = torch.tensor(r.standard_normal((B, 1, H, DK)), dtype=torch.float32)
    index = torch.tensor([12, 27, 3], dtype=torch.int32)
    hb, hg = _t(beta, gamma)
    np.testing.assert_array_equal(
        consmax_decode_paged_op(q, tk, tv, tt, index + 1, hb, hg).numpy(),
        consmax_decode_op(q, k, v, index, hb, hg).numpy())
    qc = torch.tensor(r.standard_normal((B, 4, H, DK)), dtype=torch.float32)
    lengths = torch.tensor([4, 3, 1], dtype=torch.int32)
    np.testing.assert_array_equal(
        consmax_prefill_paged_op(qc, tk, tv, tt, index - 3, lengths, hb,
                                 hg).numpy(),
        consmax_prefill_op(qc, k, v, index - 3, lengths, hb, hg).numpy())


def _leaves(caches):
    """(layer, name, leaf) -> tensor of the port's cache list."""
    return {(i, name, key): t for i, sup in enumerate(caches)
            for name, blk in sup.items() for key, t in blk["attn"].items()}


def _assert_caches_match(ref, got, num_pages):
    for (i, name, key), t in _leaves(got).items():
        want = np.asarray(ref[name]["attn"][key][i], np.float32)
        have = t.float().numpy()
        if key != "index":
            have = have[:num_pages]
        np.testing.assert_array_equal(want, have, err_msg=(i, name, key))


def test_paged_cache_utilities_match_reference():
    cfg_j = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    cfg_t = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    nb, npages, ps = 3, 6, 4
    ref = JT.init_paged_caches(cfg_j, nb, npages, ps)
    got = TT.init_paged_caches(cfg_t, nb, npages, ps, device="cpu")
    for (i, name, key), t in _leaves(got).items():
        assert t.shape[0] == (nb if key == "index" else npages + 1)
    _assert_caches_match(ref, got, npages)
    # fill the pools with data so the copies move something, and hand the
    # reference the same values
    r = np.random.default_rng(6)
    for (i, name, key), t in _leaves(got).items():
        if key != "index":
            t.copy_(torch.tensor(r.standard_normal(t.shape)).to(t.dtype))
    ref = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(np.stack([
            got[i][path[0].key]["attn"][path[-1].key].float().numpy()
            [:a.shape[1]] for i in range(len(got))]), a.dtype), ref)
    _assert_caches_match(ref, got, npages)
    ref = JT.set_slot_index(ref, 1, 9)
    TT.set_slot_index(got, 1, 9)
    ref = JT.copy_kv_page(ref, 4, 2)
    TT.copy_kv_page(got, 4, 2)
    _assert_caches_match(ref, got, npages)
    ref = JT.set_slot_index(ref, 2, 5)
    TT.set_slot_index(got, 2, 5)
    ref = JT.reset_slot_paged(ref, 1)
    TT.reset_slot_paged(got, 1)
    _assert_caches_match(ref, got, npages)
    assert TT.cache_index(got).tolist() == [0, 0, 5]


ARCHS = ["qwen2-1.5b", "gpt2-consmax"]
NB, C, STEPS, NPAGES = 2, 8, 3, 12
LM_TABLE = np.array([[3, 7, 1, 9, -1, -1, -1, -1],
                     [0, 5, 2, 11, 6, -1, -1, -1]], np.int32)
ACTIVE = np.array([[True, True], [False, True], [True, False]])


def _lm_inputs(vocab):
    r = np.random.default_rng(7)
    toks = r.integers(0, vocab, (NB, 2 * C + STEPS)).astype(np.int32)
    lens = [np.array([C, 5], np.int32), np.array([4, C], np.int32)]
    return toks, lens


def _jax_paged(jc, p, **kw):
    toks, lens = _lm_inputs(jc.vocab_size)
    table = jnp.asarray(LM_TABLE)
    cache = JT.init_paged_caches(jc, NB, NPAGES, 4)
    out = []
    for i, ln in enumerate(lens):
        lg, cache, _ = JT.lm_apply(
            p, jc, tokens=jnp.asarray(toks[:, i * C:(i + 1) * C]),
            caches=cache, merged=True, prefill_append=jnp.asarray(ln),
            logits_index=jnp.asarray(ln - 1), page_table=table, **kw)
        out.append(np.asarray(lg, np.float32))
    for t in range(STEPS):
        idx = JT.cache_index(cache)
        lg, cache, _ = JT.lm_apply(
            p, jc, tokens=jnp.asarray(toks[:, 2 * C + t:2 * C + t + 1]),
            caches=cache, merged=True, positions=idx[:, None],
            decode_active=jnp.asarray(ACTIVE[t]), page_table=table, **kw)
        out.append(np.asarray(lg, np.float32))
    return out, cache


@torch.no_grad()
def _torch_paged(jc, tc, tp, **kw):
    toks, lens = _lm_inputs(jc.vocab_size)
    table = torch.tensor(LM_TABLE)
    cache = TT.init_paged_caches(tc, NB, NPAGES, 4, device="cpu")
    out = []
    for i, ln in enumerate(lens):
        lg, cache, _ = TT.lm_apply(
            tp, tc, tokens=torch.tensor(toks[:, i * C:(i + 1) * C]),
            caches=cache, merged=True, prefill_append=torch.tensor(ln),
            logits_index=torch.tensor(ln - 1), page_table=table, **kw)
        out.append(lg.float().numpy())
    for t in range(STEPS):
        idx = TT.cache_index(cache)
        lg, cache, _ = TT.lm_apply(
            tp, tc, tokens=torch.tensor(toks[:, 2 * C + t:2 * C + t + 1]),
            caches=cache, merged=True, positions=idx[:, None],
            decode_active=torch.tensor(ACTIVE[t]), page_table=table, **kw)
        out.append(lg.float().numpy())
    return out, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_lm_apply_matches_reference(arch):
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    tp = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    ref, rcache = _jax_paged(jc, p)
    for kernels in (False, True):
        got, gcache = _torch_paged(jc, tc, tp, decode_kernel=kernels,
                                   prefill_kernel=kernels, decode_kv_block=8)
        for step, (j, t) in enumerate(zip(ref, got)):
            rows = (ACTIVE[step - 2] if step >= 2
                    else np.ones(NB, bool))      # inactive rows: discarded
            assert t.shape == j.shape and np.isfinite(t).all()
            np.testing.assert_allclose(t[rows], j[rows], rtol=0,
                                       atol=1e-5 * np.abs(j).max())
        np.testing.assert_array_equal(
            TT.cache_index(gcache).numpy(),
            np.asarray(JT.cache_index(rcache)))
        np.testing.assert_array_equal(TT.cache_index(gcache).numpy(),
                                      [C + 4 + 2, 5 + C + 2])
