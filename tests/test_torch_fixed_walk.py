"""The plain KV walks at a fixed trip count, and the flag-off continuous
engine's steps as one program each.

``core/attention._kv_walk`` (under ``append_attention`` and
``paged_attention``) walks every block of the cache, each masked past the
fill, with no host read: the step a CUDA graph captures. On the CPU:

* it equals, bit for bit, the fill-bounded walk it replaced (kept below as
  ``_bounded_walk``: it stops at the batch's highest fill, read on the
  host), for consmax, softmax and softermax, contiguous and paged, bf16
  and int8 K/V, bf16 and fp32 queries, with a window and with a softcap,
  with inactive slots (length 0), -1 pages past and inside a fill, and
  dead rows (past every fill, in pages a table maps past its fill) holding
  large finite values;
* it is within ``1e-5 * max |ref|`` of the reference's
  ``append_attention`` / ``paged_attention`` (the tolerance of
  tests/test_torch_softmax_serving.py);
* the continuous engine with both kernel flags off (consmax and softmax,
  contiguous and paged, bf16 and int8 KV) runs each of its two steps as
  one op sequence per (step, argmax | draw) on fixed tensors, as
  tests/test_torch_static_steps.py checks the kernel-flag engine.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.kernels import cache_layout as JCL
from repro_torch.analysis import op_lint as OL
from repro_torch.configs.base import ConSmaxConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import attention as TA
from repro_torch.core import normalizers
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.core.attention import kv_mask
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import init_params

NORMS = ["consmax", "softmax", "softermax"]
B, L, HKV, G, DK, C, KC, PS = 4, 64, 2, 3, 16, 6, 8, 8
VARIANTS = {"plain": {}, "window": dict(window=7), "softcap":
            dict(softcap=5.0)}
GARBAGE = 3.0e4          # dead rows: large, finite


def _bounded_walk(q, index, lengths, gather, kc, n_blocks, hkv, *,
                  norm_kind, norm_params, window=0, softcap=0.0,
                  merged=True, block_valid=None):
    """The fill-bounded walk the fixed trip count replaced: blocks j = 0..hi
    of ``kc`` rows, hi the batch's highest fill (read on the host) capped
    at ``n_blocks``; each block's mask made as it is walked; otherwise the
    same arithmetic as ``_kv_walk``."""
    b, c, H, dk = q.shape
    g = H // hkv
    cdt = q.dtype
    qg = q.reshape(b, c, hkv, g, dk).float()
    qpos = index[:, None] + torch.arange(c, device=q.device)    # (b, c)
    kv_len = index + lengths
    hi = min(int(((kv_len + kc - 1) // kc).max()), n_blocks)    # host bound
    consmax = norm_kind == "consmax"
    expf = torch.exp2 if norm_kind == "softermax" else torch.exp
    acc = torch.zeros((b, c, hkv, g, dk) if consmax else (b, hkv, g, c, dk),
                      dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, c), normalizers.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for j in range(hi):
        k_blk, v_blk = gather(j)
        k_blk, v_blk = k_blk.to(cdt).float(), v_blk.to(cdt).float()
        n = k_blk.shape[1]
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, k_blk)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kpos = j * kc + torch.arange(n, device=q.device)
        msk = kv_mask(qpos[:, :, None], kpos[None, None, :],
                      kv_len[:, None, None], window)           # (b, c, n)
        if block_valid is not None:
            msk = msk & block_valid[:, j, None, None]
        if consmax:
            p = normalizers.apply_norm(
                "consmax", norm_params, s.reshape(b, H, c, n), msk[:, None],
                head_axis=1, merged=merged).reshape(b, hkv, g, c, n)
            acc += torch.einsum("bhgqc,bchd->bqhgd", p.to(cdt).float(),
                                v_blk)
            continue
        msk = msk[:, None, None]                              # (b,1,1,c,n)
        s = torch.where(msk, s, normalizers.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = expf(m - m_new)
        e = torch.where(msk, expf(s - m_new[..., None]), 0.0)
        l = l * alpha + e.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", e.to(cdt).float(), v_blk)
        m = m_new
    if not consmax:
        acc = (acc / l.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return acc.reshape(b, c, H, dk).to(cdt)


def _norm_params(norm):
    """(the port's, the reference's) normalizer parameters."""
    if norm != "consmax":
        return None, None
    r = np.random.default_rng(9)
    beta = r.uniform(0.5, 2.5, HKV * G).astype(np.float32)
    gamma = r.uniform(20.0, 80.0, HKV * G).astype(np.float32)
    p = ConSmaxParams(HKV * G, ConSmaxConfig(), device="cpu")
    with torch.no_grad():
        p.beta.copy_(torch.tensor(beta))
        p.gamma.copy_(torch.tensor(gamma))
    return p, {"beta": jnp.asarray(beta), "gamma": jnp.asarray(gamma)}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


def _kv(seed, fills, kv):
    """(b, L) K/V rows, real below each slot's fill and GARBAGE past it,
    as numpy (bf16 or int8 codes) with fp32 scales for int8."""
    r = np.random.default_rng(seed)
    k = r.standard_normal((B, L, HKV, DK)).astype(np.float32)
    v = r.standard_normal((B, L, HKV, DK)).astype(np.float32)
    for b, f in enumerate(fills):
        k[b, f:] = GARBAGE * np.sign(r.standard_normal(k[b, f:].shape))
        v[b, f:] = -GARBAGE
    if kv == "bfloat16":
        return (np.asarray(jnp.asarray(k, jnp.bfloat16)),
                np.asarray(jnp.asarray(v, jnp.bfloat16)), {})
    kq, ks = JCL.quantize_kv(jnp.asarray(k), jnp.int8)
    vq, vs = JCL.quantize_kv(jnp.asarray(v), jnp.int8)
    return (np.asarray(kq), np.asarray(vq),
            dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs)))


def _paginate(k, v, scales, fills, seed):
    """The rows as a pool of L // PS pages per slot in random order, plus
    one page of garbage; the table maps each slot's pages below its fill,
    one -1 inside slot 3's fill, -1 past the fill, and the garbage page at
    the slot's first page past it."""
    npg = L // PS
    r = np.random.default_rng(seed)
    perm = r.permutation(B * npg).astype(np.int32)
    table = perm.reshape(B, npg).copy()

    def pool(a):
        out = np.zeros((B * npg + 1, PS) + a.shape[2:], a.dtype)
        for b in range(B):
            out[table[b]] = a[b].reshape((npg, PS) + a.shape[2:])
        return out
    kp, vp = pool(k), pool(v)
    sp = {n: pool(a) for n, a in scales.items()}
    junk = B * npg                                   # the garbage page
    kp[junk] = k[0, -PS:]
    vp[junk] = v[0, -PS:]
    for n, a in scales.items():
        sp[n][junk] = a[0, -PS:]
    for b, f in enumerate(fills):
        first = -(-f // PS)
        table[b, first:] = -1
        if first < npg:
            table[b, first] = junk
    table[3, 1] = -1
    return kp, vp, sp, table


def _case(norm, kv, q_dtype, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, C, HKV * G, DK)).astype(np.float32) * 0.5
    index = np.array([0, 9, 21, 13], np.int32)
    lengths = np.array([6, 0, 3, 6], np.int32)          # slot 1 inactive
    fills = index + lengths
    k, v, scales = _kv(seed, fills, kv)
    qt = torch.tensor(q).to(q_dtype)
    return q, qt, index, lengths, fills, k, v, scales


def _walks(fn):
    """``fn()`` through the fixed trip count and through the fill-bounded
    walk."""
    fixed = fn()
    real = TA._kv_walk
    TA._kv_walk = _bounded_walk
    try:
        bounded = fn()
    finally:
        TA._kv_walk = real
    return fixed, bounded


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("norm", NORMS)
def test_fixed_trip_count_equals_the_fill_bounded_walk(norm, kv, q_dtype,
                                                       variant):
    q, qt, index, lengths, fills, k, v, scales = _case(norm, kv, q_dtype, 1)
    tp, _ = _norm_params(norm)
    common = dict(norm_kind=norm, norm_params=tp, **VARIANTS[variant])
    ts = {n: _torch(a) for n, a in scales.items()}
    idx, lens = torch.tensor(index), torch.tensor(lengths)
    # the contiguous append walk: 8 blocks, the highest fill in block 3
    fixed, bounded = _walks(lambda: TA.append_attention(
        qt, _torch(k), _torch(v), idx, lens, kv_chunk=KC, **common, **ts))
    assert torch.isfinite(fixed).all()
    assert torch.equal(fixed, bounded)
    # the paged walk: chunk and one-token decode (slots 1 and 2 inactive)
    kp, vp, sp, table = _paginate(k, v, scales, fills, 2)
    tsp = {n: _torch(a) for n, a in sp.items()}
    for qq, ll in ((qt, lens), (qt[:, :1], torch.tensor([1, 0, 0, 1],
                                                        dtype=torch.int32))):
        fixed, bounded = _walks(lambda: TA.paged_attention(
            qq, _torch(kp), _torch(vp), torch.tensor(table), idx, ll,
            **common, **tsp))
        assert torch.isfinite(fixed[ll > 0]).all()
        assert torch.equal(fixed, bounded)


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("norm", NORMS)
def test_fixed_trip_count_matches_reference(norm, kv):
    q, qt, index, lengths, fills, k, v, scales = _case(norm, kv,
                                                       torch.float32, 3)
    tp, jp = _norm_params(norm)
    ts = {n: _torch(a) for n, a in scales.items()}
    js = {n: jnp.asarray(a) for n, a in scales.items()}
    kp, vp, sp, table = _paginate(k, v, scales, fills, 4)
    live = lengths > 0
    for kw in VARIANTS.values():
        ref = JA.append_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(index), jnp.asarray(lengths), kv_chunk=KC,
            norm_kind=norm, norm_params=jp, **kw, **js)
        got = TA.append_attention(
            qt, _torch(k), _torch(v), torch.tensor(index),
            torch.tensor(lengths), kv_chunk=KC, norm_kind=norm,
            norm_params=tp, **kw, **ts)
        _close(got[live], np.asarray(ref)[live])
        ref = JA.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(index), jnp.asarray(lengths),
            norm_kind=norm, norm_params=jp, **kw,
            **{n: jnp.asarray(a) for n, a in sp.items()})
        got = TA.paged_attention(
            qt, _torch(kp), _torch(vp), torch.tensor(table),
            torch.tensor(index), torch.tensor(lengths), norm_kind=norm,
            norm_params=tp, **kw, **{n: _torch(a) for n, a in sp.items()})
        _close(got[live], np.asarray(ref)[live])


# ------------------------------------------- the flag-off engine's steps ----
# the first two requests greedy (argmax steps with no draw among them),
# the next two sampled over two prefill chunks each
LENS = [13, 5, 11, 14, 9]
NEW = [4, 6, 3, 5, 2]
SAMPLED = (2, 3)


def _fixed(eng):
    ts = [t for sup in eng.caches for blk in sup.values()
          for c in blk.values() for t in c.values()]
    ts += [eng._prefill_in.dev, eng._decode_in.dev, eng._last,
           *eng.bank.values()]
    if eng.paged:
        ts.append(eng._table.dev)
    return ts


@pytest.mark.parametrize("paged,kv", [(False, "bfloat16"), (True, "int8")])
@pytest.mark.parametrize("norm", ["consmax", "softmax"])
def test_flag_off_engine_steps_are_one_program_each(norm, paged, kv):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("gpt2-consmax", smoke=True, score_norm=norm)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        extra = (dict(paged_kv=True, page_size=4, num_pages=24) if paged
                 else {})
        eng = ContinuousBatchingEngine(cfg, ServeConfig(
            max_slots=2, max_seq=32, prefill_chunk=8, kv_chunk=8,
            kv_cache_dtype=kv, score_norm=norm, **extra), params,
            device="cpu")
        assert not eng.graphed
        ptrs = [t.data_ptr() for t in _fixed(eng)]
        seen, calls = {}, []
        for step in ("prefill", "decode"):
            real = getattr(eng, f"_{step}_step")

            def run(d, step=step, real=real):
                with OL.record_ops() as ops:
                    out = real(d)
                if calls:          # the first step casts the parameters
                    seen.setdefault((step, d), []).append(ops)
                calls.append(step)
                assert [t.data_ptr() for t in _fixed(eng)] == ptrs
                return out
            setattr(eng, f"_{step}_step", run)
        r = np.random.default_rng(0)
        for i, (n_p, new) in enumerate(zip(LENS, NEW)):
            sp = (SamplingParams(temperature=0.9, top_k=20, seed=10 + i)
                  if i in SAMPLED else None)
            eng.submit(r.integers(0, cfg.vocab_size, n_p).tolist(), new,
                       sampling=sp)
        results = eng.run(max_steps=200)
        assert sorted(len(t) for t in results.values()) == sorted(NEW)
        assert {key for key in seen} == {(s, d) for s in ("prefill",
                                                         "decode")
                                         for d in (False, True)}
        for key, runs in seen.items():
            assert len(runs) >= 2 and runs[0], key
            assert all(ops == runs[0] for ops in runs), key
        assert eng.prefill_cache_size == eng.decode_cache_size == 1
    finally:
        torch.set_num_threads(n)
