"""The port's quantized (int8 / fp8_e4m3) KV cache against the JAX reference,
on the CPU.

* ``quantize_kv``: codes and scales bit-equal to the reference's for both
  dtypes, with an all-zero row (scale 1.0, zero codes) and exact .5 ties
  (int8 rounds half to even); ``dequantize_kv`` / ``dequant_block`` too.
* Cache trees: no scale leaves at bf16; fp32 ones-initialised
  ``k_scale``/``v_scale`` when quantized (the paged pool's spare page
  included); ``reset_slot`` zeroes a slot's scale rows (as the reference
  does), ``copy_kv_page`` carries a page's scale rows.
* The four kernels' plain versions (what the ops compute for CPU tensors):
  a quantized cache gives the bits of the same op on the dequantized cache;
  against the reference's Pallas ops in interpret mode on the same numpy
  inputs at atol 1e-5 (the tolerance of ``tests/test_torch_paged.py``'s op
  parity: the same fp32 products, summed in another order); against the
  reference's fp32 oracle at rtol 2e-2, atol 1e-3, as the reference's own
  test holds its kernel; and the int8-K-code layout of the LUT check.
* ``lm_apply`` logits with int8 and fp8 caches, through a ragged append
  chunk and decode steps, on the qwen2 and gpt2-consmax smoke configs at
  fp32: 1e-5 of the largest reference logit (``tests/test_torch_model.py``).
  Both packages quantize the same fp32 rows; a code sits on a rounding
  boundary only if the two rows differ there, which these inputs never hit.
* Greedy engine tokens equal the reference engine's at int8, contiguous and
  paged (fp32 compute; the phi3.5-moe smoke config too), and a warm
  prefix-cache serve equals a cold one.
* ``make_serve_fns``: the teacher-forced perplexity of the reference's
  ``_cache_ppl`` walk (legacy logits-returning ``decode_step``) to 1e-4
  relative at fp32, int8 within 1 % of bf16 (the reference's gate), and the
  whole-prompt ``prefill_step`` fills the cache as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.kernels import cache_layout as JCL
from repro.kernels.consmax_decode.ops import consmax_decode_op as jdecode
from repro.kernels.consmax_decode.ops import \
    consmax_decode_paged_op as jdecode_paged
from repro.kernels.consmax_decode.ref import consmax_decode_ref as joracle
from repro.kernels.consmax_prefill.ops import consmax_prefill_op as jprefill
from repro.kernels.consmax_prefill.ops import \
    consmax_prefill_paged_op as jprefill_paged
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.engine import make_serve_fns as jmake_serve_fns
from repro.serve import sampling as JS
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_decode.ops import (consmax_decode_op,
                                                    consmax_decode_paged_op)
from repro_torch.kernels.consmax_lut.ref import consmax_lut_ref
from repro_torch.kernels.consmax_prefill.ops import (consmax_prefill_op,
                                                     consmax_prefill_paged_op)
from repro_torch.models import transformer as TT
from repro_torch.serve import sampling as TS
from repro_torch.serve.engine import ContinuousBatchingEngine, make_serve_fns
from repro_torch.weights import from_jax_params

QDTYPES = ["int8", "fp8_e4m3"]
ARCHS = ["qwen2-1.5b", "gpt2-consmax"]
JDT = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}


def _bits(t):
    """A port tensor as numpy; fp8 and bf16 as their raw bits."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    """A reference array as numpy; fp8 and bf16 as their raw bits."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return a.view(np.uint8)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# ----------------------------------------------------------- quantize_kv ----
@pytest.mark.parametrize("name", QDTYPES)
def test_quantize_kv_bit_equal_to_reference(name):
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 7, 2, 16))
         * np.exp(r.uniform(-6, 6, (3, 7, 2, 1)))).astype(np.float32)
    x[0, 4] = 0.0                                   # an all-zero row
    # exact .5 ties for int8: amax 127 gives scale 1.0 and codes x itself
    x[1, 2, 0] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * 2,
                          np.float32)
    jq, js = JCL.quantize_kv(jnp.asarray(x), JDT[name])
    q, s = CL.quantize_kv(torch.tensor(x), CL.kv_cache_dtype(name))
    assert q.dtype == CL.kv_cache_dtype(name) and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q), _jbits(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[0, 4] == 1.0).all() and (q[0, 4].float() == 0).all()
    if name == "int8":
        assert q[1, 2, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ref = JCL.dequantize_kv(jq, js, jdt)
        got = CL.dequantize_kv(q, s, dt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
        np.testing.assert_array_equal(
            CL.dequant_block(q, s, dt).float().numpy(),
            np.asarray(JCL.dequant_block(jq, js, jdt), np.float32))


# ----------------------------------------------------------- cache trees ----
def _cells(caches):
    return [blk["attn"] for sup in caches for blk in sup.values()]


def test_cache_trees_scale_leaves():
    cfg = tget("qwen2-1.5b", smoke=True)
    jc = jget("qwen2-1.5b", smoke=True)
    plain = _cells(TT.init_caches(cfg, 2, 16, device="cpu"))
    assert all(set(c) == {"k", "v", "index"} for c in plain)
    assert all(c["k"].dtype == torch.bfloat16 for c in plain)
    for name in QDTYPES:
        dt = CL.kv_cache_dtype(name)
        for tree, jtree in (
                (TT.init_caches(cfg, 2, 16, name, device="cpu"),
                 JT.init_caches(jc, 2, 16, kv_dtype=name)),
                (TT.init_paged_caches(cfg, 2, 6, 8, name, device="cpu"),
                 JT.init_paged_caches(jc, 2, 6, 8, kv_dtype=name))):
            jcell = _attn_cells_ref(jtree)
            for c in _cells(tree):
                assert c["k"].dtype == c["v"].dtype == dt
                for key in ("k_scale", "v_scale"):
                    assert c[key].dtype == torch.float32
                    assert c[key].shape == c["k"].shape[:-1]
                    assert (c[key] == 1.0).all()
                # the reference's leaves per layer (the port's paged pool
                # has one spare page more)
                jk = jcell["k_scale"].shape[1:]
                assert c["k_scale"].shape[1:] == jk[1:] and (
                    c["k_scale"].shape[0] - jk[0] in (0, 1))


def _attn_cells_ref(jtree):
    return next(blk["attn"] for blk in jtree.values() if "attn" in blk)


@pytest.mark.parametrize("name", QDTYPES)
def test_reset_slot_zeroes_scales_and_copy_kv_page_carries_them(name):
    cfg = tget("qwen2-1.5b", smoke=True)
    caches = TT.init_caches(cfg, 3, 8, name, device="cpu")
    TT.reset_slot(caches, 1)
    for c in _cells(caches):
        for key in ("k_scale", "v_scale"):
            assert (c[key][1] == 0).all()            # the reference's reset
            assert (c[key][[0, 2]] == 1.0).all()
    pools = TT.init_paged_caches(cfg, 2, 6, 8, name, device="cpu")
    r = np.random.default_rng(1)
    for c in _cells(pools):
        hkv, dk = c["k"].shape[-2:]
        for key in ("k", "v"):
            codes, sc = CL.quantize_kv(torch.tensor(
                r.standard_normal((8, hkv, dk)), dtype=torch.float32),
                c[key].dtype)
            c[key][2], c[key + "_scale"][2] = codes, sc
    TT.copy_kv_page(pools, 2, 5)
    for c in _cells(pools):
        assert (c["k_scale"][2] != 1.0).any()        # page 2 really set
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_bits(c[key][5]),
                                          _bits(c[key][2]))


# ------------------------------------------------- the plain kernels ----
def _quant(r, shape, name):
    x = torch.tensor(r.standard_normal(shape), dtype=torch.float32)
    codes, sc = CL.quantize_kv(x.to(torch.bfloat16), CL.kv_cache_dtype(name))
    return codes, sc


def _heads(H):
    return (np.linspace(0.5, 2.5, H).astype(np.float32),
            np.full((H,), 100.0, np.float32))


def _j(t):
    """A port tensor as a reference array (fp8 and bf16 by their bits)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            jnp.float8_e4m3fn))
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("name", QDTYPES)
def test_plain_decode_quantized(name):
    # the reference's shapes and distributions (q, K, V ~ N(0, 1), default
    # 1/sqrt(d) scale; tests/test_quantized_kv.py:129)
    r = np.random.default_rng(2)
    b, L, H, hkv, d, bk = 2, 96, 4, 2, 32, 32
    kq, ks = _quant(r, (b, L, hkv, d), name)
    vq, vs = _quant(r, (b, L, hkv, d), name)
    beta, gamma = _heads(H)
    index = np.array([95, 40], np.int32)
    args = (torch.tensor(index), torch.tensor(beta), torch.tensor(gamma))
    qf = torch.tensor(r.standard_normal((b, 1, H, d)), dtype=torch.float32)
    outs = {}
    for q in (qf, qf.to(torch.bfloat16)):       # dequantized to q.dtype
        outs[q.dtype] = consmax_decode_op(q, kq, vq, *args, bk=bk,
                                          k_scale=ks, v_scale=vs)
        yard = consmax_decode_op(q, CL.dequant_block(kq, ks, q.dtype),
                                 CL.dequant_block(vq, vs, q.dtype), *args,
                                 bk=bk)
        assert torch.equal(outs[q.dtype], yard)
    ref = jdecode(_j(qf), _j(kq), _j(vq), jnp.asarray(index),
                  jnp.asarray(beta), jnp.asarray(gamma), bk=bk,
                  k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(outs[torch.float32].numpy(), np.asarray(ref),
                               atol=1e-5)
    # the fp32 oracle holds the bf16 output to its round-off
    qb = _j(qf.to(torch.bfloat16))
    oracle = joracle(qb[:, 0], _j(kq).swapaxes(1, 2), _j(vq).swapaxes(1, 2),
                     jnp.asarray(index + 1), jnp.asarray(beta),
                     jnp.asarray(gamma), k_scale=_j(ks).swapaxes(1, 2),
                     v_scale=_j(vs).swapaxes(1, 2))
    np.testing.assert_allclose(outs[torch.bfloat16][:, 0].float().numpy(),
                               np.asarray(oracle, np.float32), rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("name", QDTYPES)
def test_plain_prefill_quantized(name):
    r = np.random.default_rng(3)
    b, c, H, hkv, d, L = 2, 6, 4, 2, 32, 64
    kq, ks = _quant(r, (b, L, hkv, d), name)
    vq, vs = _quant(r, (b, L, hkv, d), name)
    beta, gamma = _heads(H)
    index, lengths = np.array([40, 3], np.int32), np.array([6, 2], np.int32)
    q = torch.tensor(r.standard_normal((b, c, H, d)) * 0.3,
                     dtype=torch.float32)
    args = (torch.tensor(index), torch.tensor(lengths), torch.tensor(beta),
            torch.tensor(gamma))
    out = consmax_prefill_op(q, kq, vq, *args, scale=1.0, k_scale=ks,
                             v_scale=vs)
    yard = consmax_prefill_op(q, CL.dequant_block(kq, ks, q.dtype),
                              CL.dequant_block(vq, vs, q.dtype), *args,
                              scale=1.0)
    assert torch.equal(out, yard)
    ref = jprefill(_j(q), _j(kq), _j(vq), jnp.asarray(index),
                   jnp.asarray(lengths), jnp.asarray(beta),
                   jnp.asarray(gamma), scale=1.0, bq=2, bk=32,
                   k_scale=_j(ks), v_scale=_j(vs))
    real = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real],
                               atol=1e-5)


def _paged(r, name, P=10, ps=8, hkv=2, d=32):
    kq, ks = _quant(r, (P + 1, ps, hkv, d), name)   # + the spare page
    vq, vs = _quant(r, (P + 1, ps, hkv, d), name)
    return kq, ks, vq, vs


@pytest.mark.parametrize("name", QDTYPES)
def test_plain_paged_decode_quantized(name):
    r = np.random.default_rng(4)
    H = 4
    kq, ks, vq, vs = _paged(r, name)
    table = np.array([[3, 1, 6, -1], [5, 0, -1, -1], [9, -1, -1, -1]],
                     np.int32)
    lengths = np.array([20, 11, 0], np.int32)
    beta, gamma = _heads(H)
    q = torch.tensor(r.standard_normal((3, 1, H, 32)) * 0.3,
                     dtype=torch.float32)
    args = (torch.tensor(table), torch.tensor(lengths), torch.tensor(beta),
            torch.tensor(gamma))
    out = consmax_decode_paged_op(q, kq, vq, *args, scale=1.0, k_scale=ks,
                                  v_scale=vs)
    yard = consmax_decode_paged_op(q, CL.dequant_block(kq, ks, q.dtype),
                                   CL.dequant_block(vq, vs, q.dtype), *args,
                                   scale=1.0)
    assert torch.equal(out, yard) and (out[2] == 0).all()
    ref = jdecode_paged(_j(q), _j(kq)[:10], _j(vq)[:10], jnp.asarray(table),
                        jnp.asarray(lengths), jnp.asarray(beta),
                        jnp.asarray(gamma), scale=1.0,
                        k_scale=_j(ks)[:10], v_scale=_j(vs)[:10])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", QDTYPES)
def test_plain_paged_prefill_quantized(name):
    r = np.random.default_rng(5)
    H, c = 4, 4
    kq, ks, vq, vs = _paged(r, name)
    table = np.array([[3, 1, 6, -1], [5, 0, 2, 7], [9, -1, -1, -1]],
                     np.int32)
    index, lengths = (np.array([12, 27, 3], np.int32),
                      np.array([4, 2, 4], np.int32))
    beta, gamma = _heads(H)
    q = torch.tensor(r.standard_normal((3, c, H, 32)) * 0.3,
                     dtype=torch.float32)
    args = (torch.tensor(table), torch.tensor(index), torch.tensor(lengths),
            torch.tensor(beta), torch.tensor(gamma))
    out = consmax_prefill_paged_op(q, kq, vq, *args, scale=1.0, k_scale=ks,
                                   v_scale=vs)
    yard = consmax_prefill_paged_op(q, CL.dequant_block(kq, ks, q.dtype),
                                    CL.dequant_block(vq, vs, q.dtype), *args,
                                    scale=1.0)
    assert torch.equal(out, yard)
    ref = jprefill_paged(_j(q), _j(kq)[:10], _j(vq)[:10], jnp.asarray(table),
                         jnp.asarray(index), jnp.asarray(lengths),
                         jnp.asarray(beta), jnp.asarray(gamma), scale=1.0,
                         bq=2, k_scale=_j(ks)[:10], v_scale=_j(vs)[:10])
    real = np.arange(c)[None, :] < lengths[:, None]
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real],
                               atol=1e-5)


def test_ops_refuse_mismatched_scales():
    r = np.random.default_rng(6)
    kq, ks = _quant(r, (1, 16, 1, 32), "int8")
    q = torch.zeros((1, 1, 2, 32))
    args = (torch.tensor([3]), torch.ones(2), torch.full((2,), 100.0))
    with pytest.raises(ValueError, match="needs its k_scale"):
        consmax_decode_op(q, kq, kq, *args)
    with pytest.raises(ValueError, match="takes no"):
        consmax_decode_op(q, kq.float(), kq.float(), *args, k_scale=ks,
                          v_scale=ks)
    with pytest.raises(ValueError, match="float32 of shape"):
        consmax_prefill_op(q, kq, kq, torch.tensor([3]), torch.tensor([1]),
                           *args[1:], k_scale=ks[:, :8], v_scale=ks[:, :8])


def test_plain_decode_on_int8_codes_matches_the_lut():
    """The reference's LUT check (``tests/test_quantized_kv.py:217``) on the
    plain version: int8 K codes in lane 0 (scale 1.0), q = e_0 in fp32, V
    the identity, so lane d of the output is ``C * exp(sigma * s_d)``."""
    L = d = 16
    codes = torch.arange(-120, 136, 16, dtype=torch.int32).to(torch.int8)
    k = torch.zeros((1, L, 1, d), dtype=torch.int8)
    k[0, :, 0, 0] = codes
    v = torch.eye(L, dtype=torch.int8)[None, :, None, :]
    ones = torch.ones((1, L, 1))
    q = torch.zeros((1, 1, 1, d))
    q[0, 0, 0, 0] = 1.0
    beta, gamma, sigma = torch.tensor([1.5]), torch.tensor([100.0]), 1 / 16
    out = consmax_decode_op(q, k, v, torch.tensor([L - 1]), beta, gamma,
                            scale=sigma, k_scale=ones, v_scale=ones)
    c = torch.exp(-beta[0]) / gamma[0]
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               consmax_lut_ref(codes, c, sigma).numpy(),
                               rtol=1e-5)


# ---------------------------------------------------------------- model ----
B, L, C, STEPS = 2, 32, 8, 3


def _params(arch, cd="float32"):
    jc = jget(arch, smoke=True, compute_dtype=cd)
    tc = tget(arch, smoke=True, compute_dtype=cd)
    p = JT.lm_init(Ctx(random.key(0)), jc)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc,
                                      device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", QDTYPES)
def test_lm_apply_logits_with_quantized_cache_match_reference(arch, name):
    jc, tc, p, tp = _params(arch)
    r = np.random.default_rng(0)
    toks = r.integers(0, jc.vocab_size, (B, C + STEPS)).astype(np.int32)
    lens = np.array([C, 5], np.int32)
    jcache = JT.init_caches(jc, B, L, kv_dtype=name)
    lg, jcache, _ = JT.lm_apply(p, jc, tokens=jnp.asarray(toks[:, :C]),
                                caches=jcache, merged=True,
                                prefill_append=jnp.asarray(lens),
                                logits_index=jnp.asarray(lens - 1))
    ref = [lg]
    for t in range(STEPS):
        idx = JT.cache_index(jcache)
        lg, jcache, _ = JT.lm_apply(p, jc, tokens=jnp.asarray(
            toks[:, C + t:C + t + 1]), caches=jcache, merged=True,
            positions=idx[:, None])
        ref.append(lg)
    for kernels in (False, True):
        kw = dict(decode_kernel=kernels, prefill_kernel=kernels)
        cache = TT.init_caches(tc, B, L, name, device="cpu")
        with torch.no_grad():
            lg, cache, _ = TT.lm_apply(
                tp, tc, tokens=torch.tensor(toks[:, :C]), caches=cache,
                merged=True, prefill_append=torch.tensor(lens),
                logits_index=torch.tensor(lens - 1), **kw)
            got = [lg]
            for t in range(STEPS):
                idx = TT.cache_index(cache)
                lg, cache, _ = TT.lm_apply(tp, tc, tokens=torch.tensor(
                    toks[:, C + t:C + t + 1]), caches=cache, merged=True,
                    positions=idx[:, None], **kw)
                got.append(lg)
        for j, t in zip(ref, got):
            j = np.asarray(j, np.float32)
            np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max())
        _assert_caches_match(cache, jcache)


def _assert_caches_match(cache, jcache):
    """The same leaves in every layer: scales to fp32 round-off; codes (and
    bf16 rows) equal but for a rare value on a rounding boundary, where the
    two packages' fp32 rows differ in the last bit."""
    names = sorted(jcache)
    for i, sup in enumerate(cache):
        for n, blk in zip(names, sup.values()):
            jblk = {k: np.asarray(v)[i] for k, v in jcache[n]["attn"].items()}
            assert set(blk["attn"]) == set(jblk)
            for key, t in blk["attn"].items():
                if key == "index" or key.endswith("scale"):
                    np.testing.assert_allclose(t.numpy(), jblk[key],
                                               rtol=1e-5)
                else:
                    assert (_bits(t) != _jbits(jblk[key])).mean() < 1e-3, key


# --------------------------------------------------------------- engines ----
PROMPT_LENS, BUDGETS = [5, 13, 3, 11], [4, 6, 3, 5]
ENGINE = dict(max_seq=48, prefill_chunk=4, max_slots=3,
              kv_cache_dtype="int8")
PAGED = dict(paged_kv=True, page_size=4, num_pages=14)


def _serve(engine, prompts, budgets):
    uids = [engine.submit(pr, n) for pr, n in zip(prompts, budgets)]
    results = engine.run(max_steps=500)
    return [results[u] for u in uids]


@pytest.mark.parametrize("arch", [*ARCHS, "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_engine_tokens_match_reference_engine(arch, paged):
    jc, tc, p, tp = _params(arch)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, jc.vocab_size, n).tolist() for n in PROMPT_LENS]
    extra = PAGED if paged else {}
    ref = _serve(JEngine(jc, JServeConfig(**ENGINE, **extra), p), prompts,
                 BUDGETS)
    for kernels in (False, True):
        eng = ContinuousBatchingEngine(
            tc, ServeConfig(**ENGINE, **extra, decode_kernel=kernels,
                            prefill_kernel=kernels, decode_kv_block=16),
            tp, device="cpu")
        assert _serve(eng, prompts, BUDGETS) == ref, kernels
    assert [len(t) for t in ref] == BUDGETS


def test_int8_warm_prefix_equals_cold():
    _, tc, _, tp = _params("qwen2-1.5b")
    r = np.random.default_rng(7)
    shared = r.integers(0, tc.vocab_size, 12).tolist()   # 3 pages of 4
    tails = [r.integers(0, tc.vocab_size, n).tolist() for n in (7, 4)]

    def serve(prefix_cache):
        scfg = ServeConfig(max_seq=48, prefill_chunk=4, max_slots=1,
                           paged_kv=True, page_size=4, num_pages=24,
                           prefix_cache=prefix_cache, decode_kernel=True,
                           prefill_kernel=True, kv_cache_dtype="int8")
        eng = ContinuousBatchingEngine(tc, scfg, tp, device="cpu")
        out = _serve(eng, [shared] + [shared + t for t in tails] + [shared],
                     [4] * 4)
        return out, eng

    warm, weng = serve(True)
    cold, ceng = serve(False)
    assert warm == cold
    assert weng.prefilled_tokens == 12 + 7 + 4 + 1
    assert weng.pool.prefix_hit_rows > 0 == ceng.pool.prefix_hit_rows


def test_int8_copy_on_write_under_a_live_sharer():
    """The second request shares the first's cached pages while the first
    still decodes, so its 1-token tail re-score copies the shared last page
    (codes and scales) before writing there."""
    _, tc, _, tp = _params("qwen2-1.5b")
    prompt = np.random.default_rng(5).integers(0, tc.vocab_size, 12).tolist()

    def serve(prefix_cache):
        scfg = ServeConfig(max_seq=32, prefill_chunk=4, max_slots=2,
                           paged_kv=True, page_size=4, num_pages=16,
                           prefix_cache=prefix_cache, decode_kernel=True,
                           prefill_kernel=True, kv_cache_dtype="int8")
        eng = ContinuousBatchingEngine(tc, scfg, tp, device="cpu")
        ua = eng.submit(prompt, 10)
        eng.run(max_steps=5)                   # A prefilled, now decoding
        ub = eng.submit(prompt, 6)             # same prompt, A still live
        res = eng.run(max_steps=400)
        return res[ua], res[ub], eng

    wa, wb, weng = serve(True)
    ca, cb, ceng = serve(False)
    assert wa == ca and wb == cb and wb == wa[:6]
    assert weng.pool.cow_copies >= 1 and ceng.pool.cow_copies == 0


# ------------------------------------------------- whole-sequence forward ----
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_sequence_forward_matches_reference(arch):
    """``lm_apply`` without caches (the whole-sequence branch of
    ``attention_apply``, through ``blockwise_attention``) against the
    reference's, at fp32: 1e-5 of the largest reference logit."""
    jc, tc, p, tp = _params(arch)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 11))
    ref, _, _ = JT.lm_apply(p, jc, tokens=jnp.asarray(toks, jnp.int32),
                            merged=True)
    with torch.no_grad():
        got, caches, _ = TT.lm_apply(tp, tc, tokens=torch.tensor(toks),
                                  merged=True)
    assert caches is None
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------- make_serve_fns ----
def _ppl(step_fns, params, toks, to_logits):
    init_caches, _, decode_step, _ = step_fns
    caches = init_caches(1)
    nll = 0.0
    for t in range(len(toks) - 1):
        logits, caches = decode_step(params, caches,
                                     {"tokens": to_logits([[toks[t]]])})
        logp = np.asarray(jax.nn.log_softmax(
            jnp.asarray(np.asarray(logits[0], np.float32))))
        nll -= float(logp[toks[t + 1]])
    return float(np.exp(nll / (len(toks) - 1)))


def _ppl_pair(cd, kv_dtype, toks):
    """The reference's ``_cache_ppl`` walk and the port's, same weights."""
    jc, tc, p, tp = _params("gpt2-consmax", cd)
    kw = dict(max_seq=len(toks) + 2, max_slots=1, kv_cache_dtype=kv_dtype,
              fused_sampling=False, score_norm="consmax")
    jfns = jmake_serve_fns(jc, JServeConfig(**kw))
    jfns = (jfns[0], None, jax.jit(jfns[2]), None)
    ref = _ppl(jfns, p, toks, lambda x: jnp.asarray(x, jnp.int32))

    def as_numpy(fns):
        init_caches, _, step, _ = fns
        return (init_caches, None,
                lambda *a: (lambda o: (o[0].float().numpy(), o[1]))(step(*a)),
                None)
    got = _ppl(as_numpy(make_serve_fns(tc, ServeConfig(**kw),
                                       device="cpu")), tp, toks,
               lambda x: torch.tensor(x, dtype=torch.int32))
    return ref, got


def test_make_serve_fns_perplexity_matches_reference_and_int8_gate():
    vocab = tget("gpt2-consmax", smoke=True).vocab_size
    toks = np.random.default_rng(8).integers(0, vocab, 33).tolist()
    for kv in ("bfloat16", "int8"):
        ref, got = _ppl_pair("float32", kv, toks)
        assert abs(got - ref) / ref <= 1e-4, (kv, got, ref)
    # the reference's gate, at the serving default (bf16 compute)
    _, bf16 = _ppl_pair("bfloat16", "bfloat16", toks)
    _, int8 = _ppl_pair("bfloat16", "int8", toks)
    assert abs(int8 - bf16) / bf16 <= 0.01, (int8, bf16)


@pytest.mark.parametrize("name", ["bfloat16", *QDTYPES])
def test_make_serve_fns_prefill_step_fills_cache_as_reference(name):
    """Whole-prompt prefill (``blockwise_attention``, then the quantized
    cache fill), then fused greedy decode steps: the port's tokens and cache
    equal the reference's at fp32."""
    jc, tc, p, tp = _params("qwen2-1.5b")
    kw = dict(max_seq=24, max_slots=2, kv_cache_dtype=name)
    jinit, jprefill_step, jdecode_step, _ = jmake_serve_fns(
        jc, JServeConfig(**kw))
    init, prefill_step, decode_step, _ = make_serve_fns(
        tc, ServeConfig(**kw), device="cpu")
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 9))
    jbank, bank = JS.bank_init(2), TS.bank_init(2)
    jt, jcache = jprefill_step(p, jinit(2), {"tokens": jnp.asarray(toks)},
                               jbank)
    t, cache = prefill_step(tp, init(2), {"tokens": torch.tensor(toks)}, bank)
    assert t.tolist() == np.asarray(jt).tolist()
    active = np.array([True, False])
    for _ in range(3):
        jt, jcache = jdecode_step(p, jcache, {"tokens": jt, "active":
                                              jnp.asarray(active)}, jbank)
        t, cache = decode_step(tp, cache, {"tokens": t, "active":
                                           torch.tensor(active)}, bank)
        assert t.tolist() == np.asarray(jt).tolist()
    np.testing.assert_array_equal(TT.cache_index(cache).numpy(), [12, 9])
    _assert_caches_match(cache, jcache)
