"""The arithmetic of the fp32 full-sequence kernel (``kernels/csrc/
attn_f32.cuh``) emulated in torch on the CPU, against the reference's
Pallas kernels in interpret mode at fp32.

The kernel runs both products, ``S = Q K^T`` and ``O += P V``, on the
tensor cores in 3xTF32: each operand x splits into hi = tf32(x) and lo =
tf32(x - hi), with ``cvt.rna`` (round to nearest, ties away from zero, to
10 mantissa bits: ``_rna`` is the bit operation), and a product is
lo.hi + hi.lo + hi.hi, summed in fp32 over chunks of 16 columns (S) or 16
keys (O) that are added to the running sum in fp32. The emulation runs
the same splits and products in the same order (the tensor core's own
order inside a 16-wide chunk is not emulated: every product of two tf32
values is exact in fp32), the softmax form over the kernel's 64-key tiles
with its (m, l) update, ConSmax with no running state.

* The 3xTF32 emulation of both forms is within the reference's fp32 atol
  2e-5 (``tests/test_kernels.py``) of ``consmax_attention`` /
  ``softmax_attention`` at fp32, at small versions of ``chip_smoke.py``'s
  five fp32 cases (causal, window + softcap, non-causal cross-length,
  dk 96, dk 32), ConSmax in both forms.
* The same emulation without the lo terms (1xTF32, one TF32 product)
  misses that gate in every case, so the split is what keeps the kernel
  fp32-accurate.
The card holds the kernel itself to the same gate against its plain
version (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.consmax_attn.kernel import consmax_attention as jconsmax
from repro.kernels.softmax_attn.kernel import softmax_attention as jsoftmax

ATOL = 2e-5
KEYS = 64                      # the kernel's K/V tile (32 at dk 256)
CHUNK = 16                     # the columns / keys of one fp32-added chunk
NEG_INF = -1e30

CASES = {
    "causal": ((1, 128, 128, 6, 2, 128), {}),
    "window-softcap": ((1, 128, 128, 6, 2, 128),
                       dict(window=50, softcap=30.0)),
    "non-causal-cross": ((1, 40, 120, 4, 2, 64), dict(causal=False)),
    "dk96": ((1, 100, 100, 4, 4, 96), {}),
    "dk32": ((2, 67, 67, 4, 1, 32), {}),
}


def _rna(x):
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 mantissa bits, ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _rna(x)
    return hi, _rna(x - hi)


def _product(a, b, *, three):
    """a (..., m, n) @ b (..., n, p) as the kernel sums it: per chunk of 16
    along n, lo.hi + hi.lo + hi.hi (hi.hi alone for 1xTF32), each chunk
    added to the running fp32 sum."""
    out = None
    for c in range(0, a.shape[-1], CHUNK):
        ah, al = _split(a[..., c:c + CHUNK])
        bh, bl = _split(b[..., c:c + CHUNK, :])
        part = ah @ bh
        if three:
            part = (al @ bh + ah @ bl) + part
        out = part if out is None else out + part
    return out


def _mask(sq, skv, *, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    m = kpos < skv
    if causal:
        m = m & (qpos >= kpos)
    if window > 0:
        m = m & (qpos - kpos < window)
    return m


def emulate(q, k, v, beta=None, gamma=None, *, form, three=True,
            causal=True, window=0, softcap=0.0, scale=None):
    """The kernel's arithmetic: q (b, H, sq, dk), k, v (b, hkv, skv, dk)
    fp32; ``form`` "eq2", "eq3" or "softmax"."""
    b, H, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = H // hkv
    scale = 1.0 / math.sqrt(dk) if scale is None else scale
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    mask = _mask(sq, skv, causal=causal, window=window)
    o = torch.zeros((b, H, sq, dk))
    m = torch.full((b, H, sq, 1), NEG_INF)
    l = torch.zeros((b, H, sq, 1))
    if form != "softmax":
        bet = beta.reshape(1, H, 1, 1)
        gam = gamma.reshape(1, H, 1, 1)
        cm = torch.exp(-bet) / gam
    for j0 in range(0, skv, KEYS):
        kt, vt = k[:, :, j0:j0 + KEYS], v[:, :, j0:j0 + KEYS]
        mt = mask[:, j0:j0 + KEYS]
        s = _product(q, kt.transpose(-1, -2), three=three) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        if form == "softmax":
            s = torch.where(mt, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mt, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha
            m = m_new
        else:
            p = cm * torch.exp(s) if form == "eq3" else torch.exp(
                s - bet) / gam
            p = torch.where(mt, p, 0.0)
        o = o + _product(p, vt, three=three)
    return o / l.clamp(min=1e-30) if form == "softmax" else o


def _inputs(shape, seed):
    b, sq, skv, H, hkv, dk = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, H, sq, dk)).astype(np.float32)
    k = r.standard_normal((b, hkv, skv, dk)).astype(np.float32)
    v = r.standard_normal((b, hkv, skv, dk)).astype(np.float32)
    beta = r.uniform(0.5, 2.5, H).astype(np.float32)
    gamma = np.full(H, 100.0, np.float32)
    return q, k, v, beta, gamma


def _reference(form, q, k, v, beta, gamma, kw):
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if form == "softmax":
        return np.asarray(jsoftmax(jq, jk, jv, interpret=True, **kw))
    return np.asarray(jconsmax(jq, jk, jv, jnp.asarray(beta),
                               jnp.asarray(gamma), merged=form == "eq3",
                               interpret=True, **kw))


@functools.cache
def _case(form, case):
    """The inputs (torch) and the reference's output of one case."""
    shape, kw = CASES[case]
    arrays = _inputs(shape, seed=sorted(CASES).index(case))
    return ([torch.tensor(a) for a in arrays],
            _reference(form, *arrays, kw))


def _err(form, case, *, three):
    inputs, ref = _case(form, case)
    got = emulate(*inputs, form=form, three=three, **CASES[case][1])
    return float(np.abs(got.numpy() - ref).max())


FORMS = ["eq2", "eq3", "softmax"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_matches_reference_at_fp32(form, case):
    assert _err(form, case, three=True) <= ATOL


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_1xtf32_misses_the_fp32_gate(form, case):
    assert _err(form, case, three=False) > ATOL
