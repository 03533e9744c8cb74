"""The port's paper kernels and whole-sequence walk against the JAX package.

* ``consmax_attention_op`` / ``softmax_attention_op`` (on CPU tensors: the
  plain versions beside the CUDA kernels) vs the reference's ops, whose
  Pallas kernels run in interpret mode here, over the reference's own
  ``SHAPES`` (``tests/test_kernels.py``; its ``bq``/``bk`` are TPU tiles
  and go to the JAX op only), sliding windows, softcaps, merged vs
  unmerged, causal masking top-left aligned when skv > sq, and beta = 0,
  gamma = 1 against raw ``exp(s) @ v``.
* ``consmax_lut_op`` (the kernel's own tables and multiply order) vs the
  reference's LUT op and the direct ``C * exp(scale * s)`` over all 256
  codes at three scales and over ragged lengths.
* ``core.attention.blockwise_attention`` vs the reference's, for consmax
  (merged and not), softmax and softermax.
* The decode op's last-position row vs the attention op's last row.

Inputs come from ``np.random.default_rng``. Tolerances are the reference
tests' own: fp32 atol 2e-5 (the same fp32 products, summed in another
order), bf16 atol 2e-2 (consmax) / 3e-2 (softmax): the Pallas kernel
rounds the weights to bf16 before ``p @ v``, the plain versions do not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.kernels.consmax_attn.ops import consmax_attention_op as j_consmax
from repro.kernels.consmax_lut.ops import consmax_lut_op as j_lut
from repro.kernels.softmax_attn.ops import softmax_attention_op as j_softmax
from repro_torch.configs.base import ConSmaxConfig
from repro_torch.core import attention as TA
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
from repro_torch.kernels.consmax_lut.ops import consmax_lut_op
from repro_torch.kernels.consmax_lut.ref import (consmax_lut_ref,
                                                 split_identity_exact)
from repro_torch.kernels.softmax_attn.ops import softmax_attention_op

SHAPES = [
    # b, sq, skv, nh, nkv, d, bq, bk (bq/bk: the JAX op's TPU tiles)
    (1, 128, 128, 2, 2, 64, 64, 64),
    (2, 96, 96, 4, 2, 32, 32, 32),     # GQA + non-multiple of block
    (1, 64, 192, 4, 1, 64, 64, 64),    # cross-length (kv longer), MQA
    (1, 200, 200, 2, 2, 128, 128, 128),  # padding path
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, sq, skv, nh, nkv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, sq, nh, d)).astype(np.float32),
            r.standard_normal((b, skv, nkv, d)).astype(np.float32),
            r.standard_normal((b, skv, nkv, d)).astype(np.float32))


def _both(arrays, dtype="float32"):
    """The same values as JAX arrays and as CPU torch tensors of ``dtype``
    (both round fp32 to bf16 to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _heads(nh, beta=None, gamma=100.0):
    beta = np.linspace(0.5, 2.5, nh) if beta is None else beta
    beta = np.broadcast_to(np.asarray(beta, np.float32), (nh,)).copy()
    return beta, np.full((nh,), gamma, np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_consmax_attention_matches_reference(shape, dtype):
    b, sq, skv, nh, nkv, d, bq, bk = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, b, sq, skv, nh, nkv, d),
                                       dtype)
    beta, gamma = _heads(nh)
    causal = sq == skv
    ref = j_consmax(jq, jk, jv, beta, gamma, causal=causal, bq=bq, bk=bk)
    n0 = consmax_attention_op.launches
    got = consmax_attention_op(tq, tk, tv, torch.from_numpy(beta),
                               torch.from_numpy(gamma), causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert consmax_attention_op.launches == n0       # CPU: plain version
    _close(got, ref, atol=DTYPES[dtype][2])


def test_consmax_attention_causal_is_top_left_when_kv_is_longer():
    """Causal with skv > sq: query i sees keys <= i (not the last sq)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, 64, 192, 4, 1, 64))
    beta, gamma = _heads(4)
    ref = j_consmax(jq, jk, jv, beta, gamma, causal=True, bq=64, bk=64)
    got = consmax_attention_op(tq, tk, tv, torch.from_numpy(beta),
                               torch.from_numpy(gamma), causal=True)
    _close(got, ref, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(window=16), dict(window=64),
                                dict(softcap=10.0), dict(softcap=30.0)],
                         ids=["window16", "window64", "softcap10",
                              "softcap30"])
def test_consmax_attention_window_and_softcap(kw):
    """The reference's window (1 x 128, MHA) and softcap (2 x 96, GQA, kv
    not a block multiple) cases."""
    if "window" in kw:
        shape, (beta, gamma), tiles = (1, 128, 128, 2, 2, 64), _heads(
            2, 1.0, 10.0), 64
    else:
        shape, (beta, gamma), tiles = (2, 96, 96, 4, 2, 64), _heads(4), 64
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, *shape))
    ref = j_consmax(jq, jk, jv, beta, gamma, causal=True, bq=tiles,
                    bk=tiles, **kw)
    got = consmax_attention_op(tq, tk, tv, torch.from_numpy(beta),
                               torch.from_numpy(gamma), causal=True, **kw)
    _close(got, ref, atol=2e-5)


def test_consmax_attention_merged_equals_training_form():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 1, 64, 64, 2, 2, 32))
    beta = np.array([1.0, 2.0], np.float32)
    gamma = np.array([50.0, 100.0], np.float32)
    tb, tg = torch.from_numpy(beta), torch.from_numpy(gamma)
    unmerged = consmax_attention_op(tq, tk, tv, tb, tg, merged=False)
    merged = consmax_attention_op(tq, tk, tv, tb, tg, merged=True)
    _close(merged, unmerged.numpy(), rtol=2e-5, atol=1e-6)
    ref = j_consmax(jq, jk, jv, beta, gamma, merged=True, bq=32, bk=32)
    _close(merged, ref, atol=2e-5)


def test_consmax_attention_beta0_gamma1_is_raw_exp_scores():
    """beta = 0, gamma = 1, no mask: exactly exp(q k^T / sqrt(d)) @ v."""
    q, k, v = _qkv(2, 1, 64, 64, 2, 2, 32)
    got = consmax_attention_op(*map(torch.from_numpy, (q, k, v)),
                               torch.zeros(2), torch.ones(2), causal=False)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(32)
    ref = np.einsum("bhqk,bkhd->bqhd", np.exp(s), v)
    _close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_softmax_attention_matches_reference(shape, dtype):
    b, sq, skv, nh, nkv, d, bq, bk = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, b, sq, skv, nh, nkv, d),
                                       dtype)
    causal = sq == skv
    ref = j_softmax(jq, jk, jv, causal=causal, bq=bq, bk=bk)
    n0 = softmax_attention_op.launches
    got = softmax_attention_op(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert softmax_attention_op.launches == n0
    _close(got, ref, atol=2e-5 if dtype == "float32" else 3e-2)


def test_softmax_attention_window_softcap_matches_reference():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 2, 96, 96, 4, 2, 64))
    kw = dict(causal=True, window=24, softcap=20.0)
    ref = j_softmax(jq, jk, jv, bq=32, bk=32, **kw)
    _close(softmax_attention_op(tq, tk, tv, **kw), ref, atol=2e-5)


# ------------------------------------------------------------------ LUT ----
@pytest.mark.parametrize("scale", [0.03, 1 / np.sqrt(128), 0.125])
def test_lut_all_256_codes(scale):
    """Every int8 code through the bitwidth-split tables: within relative
    1e-5 of the reference's LUT op and of the direct C * exp(scale * s)."""
    scale = float(scale)
    s8 = np.arange(-128, 128, dtype=np.int8)
    got = consmax_lut_op(torch.from_numpy(s8), 0.01, scale=scale).numpy()
    for ref in (np.asarray(j_lut(jnp.asarray(s8), 0.01, scale=scale,
                                 block=64)),
                consmax_lut_ref(torch.from_numpy(s8), 0.01, scale).numpy()):
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
        assert rel.max() < 1e-5
    assert split_identity_exact(torch.from_numpy(s8), scale) < 1e-5


@pytest.mark.parametrize("n", [7, 128, 1000, 4096])
def test_lut_shapes(n):
    s8 = np.random.default_rng(n).integers(-128, 128, n).astype(np.int8)
    ref = np.asarray(j_lut(jnp.asarray(s8), 0.5, scale=0.05, block=256))
    t8 = torch.from_numpy(s8)
    got = consmax_lut_op(t8, 0.5, scale=0.05)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    # C as a 0-d tensor, and any shape of codes: the same values
    assert torch.equal(consmax_lut_op(t8, torch.tensor(0.5), scale=0.05), got)
    if n % 8 == 0:
        assert torch.equal(consmax_lut_op(t8.reshape(8, -1), 0.5,
                                          scale=0.05).reshape(-1), got)


# ------------------------------------------------- blockwise attention ----
NORMS = {"consmax": ("consmax", False), "consmax-merged": ("consmax", True),
         "softmax": ("softmax", False), "softermax": ("softermax", False)}
CASES = {  # (b, sq, skv, H, hkv, d), keyword arguments
    "gqa-causal": ((2, 56, 56, 4, 2, 16), dict(q_chunk=24, kv_chunk=20)),
    "window-softcap": ((1, 56, 56, 6, 2, 16),
                       dict(window=9, softcap=5.0, q_chunk=16, kv_chunk=12)),
    "q-offset": ((2, 24, 56, 4, 1, 16),
                 dict(q_offset=32, window=21, q_chunk=10, kv_chunk=15)),
    "non-causal": ((1, 30, 50, 4, 4, 16),
                   dict(causal=False, q_chunk=16, kv_chunk=20)),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("norm", NORMS)
def test_blockwise_attention_matches_reference(norm, case):
    norm_kind, merged = NORMS[norm]
    (b, sq, skv, H, hkv, d), kw = CASES[case]
    q, k, v = _qkv(11, b, sq, skv, H, hkv, d)
    q = q * d ** -0.5                           # the model pre-scales q
    beta = np.random.default_rng(12).uniform(0.5, 2.5, H).astype(np.float32)
    gamma = np.full((H,), 100.0, np.float32)
    ref = JA.blockwise_attention(q, k, v, norm_kind=norm_kind,
                                 norm_params={"beta": beta, "gamma": gamma},
                                 merged=merged, **kw)
    params = ConSmaxParams(H, ConSmaxConfig())
    with torch.no_grad():
        params.beta.copy_(torch.from_numpy(beta))
        params.gamma.copy_(torch.from_numpy(gamma))
    got = TA.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 norm_kind=norm_kind, norm_params=params,
                                 merged=merged, **kw)
    assert got.shape == (b, sq, H, d) and got.dtype == torch.float32
    _close(got, ref, atol=2e-5)


def test_blockwise_consmax_matches_the_attention_op():
    """One loop, two implementations: the walk on pre-scaled q equals the
    kernel's plain version with the default 1/sqrt(d) scale."""
    q, k, v = map(torch.from_numpy, _qkv(13, 2, 40, 40, 4, 2, 32))
    beta, gamma = map(torch.from_numpy, _heads(4))
    params = ConSmaxParams(4, ConSmaxConfig())
    with torch.no_grad():
        params.beta.copy_(beta)
        params.gamma.copy_(gamma)
    walk = TA.blockwise_attention(q * 32 ** -0.5, k, v, norm_kind="consmax",
                                  norm_params=params, window=11,
                                  q_chunk=16, kv_chunk=7)
    op = consmax_attention_op(q, k, v, beta, gamma, window=11)
    _close(walk, op.numpy(), atol=2e-5)


def test_decode_op_last_row_equals_attention_op_last_row():
    """Decoding the last position of a full cache equals the full-sequence
    op's last output row (causal, unmerged, default scale)."""
    b, L, nh, nkv, d = 1, 64, 4, 2, 64
    q, k, v = map(torch.from_numpy, _qkv(4, b, L, L, nh, nkv, d))
    beta, gamma = map(torch.from_numpy, _heads(nh))
    full = consmax_attention_op(q, k, v, beta, gamma, causal=True)
    dec = consmax_decode_op(q[:, -1:], k, v,
                            torch.full((b,), L - 1, dtype=torch.int32), beta,
                            gamma, merged=False)
    _close(dec[:, 0], full[:, -1].numpy(), atol=1e-5)
