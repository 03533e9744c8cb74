"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The paged kernels are held to the same bounds against their plain paged
versions, and bit for bit to the contiguous kernels on the same rows, for
page sizes 4, 16, 64 and 256 (tiles and shards are aligned to logical row
positions, so the page size changes only where a row is read from).

Every test here is marked ``cuda`` and skips where no CUDA device is
present (decided inside the ``cuda`` fixture, never at import). On a card:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the repository's ``tests/conftest.py`` configures JAX,
which the card's machine does not need; this file imports only torch,
numpy and the port.)

Tolerance: the kernels read bf16 inputs, accumulate in fp32 and write bf16;
the prefill kernel also rounds each weight p to bf16 before ``p @ v`` (as
the TPU kernel does). Both roundings are relative 2^-9 per term, so
``|kernel - plain| <= 2^-8 * sum_j p_j |v_j|``; the tests allow 2^-7 of
that sum, which is the plain version evaluated on ``|v|`` (p >= 0). That
sum grows with the fill faster than the output does, so each output row (a
decode slot, a prefill query row) is also held to a relative L2 error of
2^-7, four times the 2^-9 rounding: one lost or doubled KV tile exceeds it.

The full-sequence kernels (``consmax_attn``, ``softmax_attn``) are held to
the same two bounds, with the softmax weights normalized (the plain version
on ``|v|`` is again ``sum_j p_j |v_j|``); ``consmax_attention`` also to
``consmax_prefill``'s bits on the same rows. The LUT kernel is held bit for
bit to its plain version on the same tables (two fp32 products in one
order) and within relative 1e-5 of ``C * exp(scale * s)``.

The serving kernels on an int8 / fp8_e4m3 cache (the codes of
``cache_layout.quantize_kv`` with their fp32 scales) are held bit for bit to
the same kernel on the dequantized bf16 cache (``dequant_block``: the
kernel dequantizes every element exactly so), their paged twins bit for bit
to the contiguous kernels on the same rows, and the plain versions on the
dequantized cache within the bounds above. The decode kernel on int8 K
codes (V the identity, q = e_0) gives ``consmax_lut``'s weights within one
bf16 ulp: its output is bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_decode.ops import (
    consmax_decode_cuda, consmax_decode_op, consmax_decode_paged_cuda,
    consmax_decode_paged_op)
from repro_torch.kernels.consmax_decode.ref import (consmax_decode_paged_ref,
                                                   consmax_decode_ref)
from repro_torch.kernels.consmax_prefill.ops import (
    consmax_prefill_cuda, consmax_prefill_op, consmax_prefill_paged_cuda,
    consmax_prefill_paged_op)
from repro_torch.kernels.consmax_prefill.ref import (
    consmax_prefill_paged_ref, consmax_prefill_ref)
from repro_torch.kernels.consmax_attn.ops import (consmax_attention_cuda,
                                                  consmax_attention_op)
from repro_torch.kernels.consmax_attn.ref import consmax_attention_ref
from repro_torch.kernels.consmax_lut.ops import (consmax_lut_cuda,
                                                 consmax_lut_op, make_luts)
from repro_torch.kernels.consmax_lut.ref import consmax_lut_ref, lut_product
from repro_torch.kernels.softmax_attn.ops import (softmax_attention_cuda,
                                                  softmax_attention_op)
from repro_torch.kernels.softmax_attn.ref import softmax_attention_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, *, b, L, H, hkv, dk, c=None, seed=0):
    r = np.random.default_rng(seed)
    qshape = (b, H, dk) if c is None else (b, c, H, dk)

    def t(shape, scale=1.0):
        return torch.tensor(r.standard_normal(shape) * scale,
                            dtype=torch.bfloat16, device=dev)

    q = t(qshape, dk ** -0.5)
    k, v = t((b, L, hkv, dk)), t((b, L, hkv, dk))
    beta = torch.tensor(r.uniform(0.5, 2.5, H), dtype=torch.float32,
                        device=dev)
    gamma = torch.full((H,), 100.0, device=dev)
    return q, k, v, beta, gamma


def _assert_within_bound(got, ref, ref_absv):
    err = (got.float() - ref.float()).abs()
    bound = 2.0 ** -7 * ref_absv.float() + 1e-6
    assert torch.isfinite(got.float()).all()
    assert bool((err <= bound).all()), float((err - bound).max())
    ref_n = ref.float().flatten(-2).norm(dim=-1)
    live = ref_n > 0
    rel = err.flatten(-2).norm(dim=-1)[live] / ref_n[live]
    assert bool((rel <= 2.0 ** -7).all()), float(rel.max())


def test_kernels_build(cuda):
    _build.build()
    assert {"consmax_attn", "softmax_attn", "consmax_lut"} <= set(
        _build.KERNELS)
    for name in _build.KERNELS:
        assert _build.library_path(name).exists()


DECODE = {  # b, L, H, hkv, dk, bk
    "qwen2-gqa": (4, 512, 12, 2, 128, 128),
    "gpt2-mha": (3, 300, 6, 6, 64, 64),
    "mqa-ragged-L": (2, 200, 8, 1, 32, 64),
    "head-chunks": (2, 256, 20, 2, 256, 128),
    "gpt2-engine": (4, 1024, 6, 6, 64, 256),   # chip_smoke's gpt2 engine
    "dk96": (4, 512, 16, 4, 96, 128),     # phi-3-vision's head_dim, GQA 4
}


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("variant", [dict(), dict(window=37),
                                     dict(softcap=5.0), dict(merged=False)])
def test_decode_kernel_matches_plain(cuda, shape, variant):
    b, L, H, hkv, dk, bk = DECODE[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk)
    # fills: one row, a shard boundary, mid-shard, full
    lengths = torch.tensor([1, bk, bk + 7, L][:b], dtype=torch.int32,
                           device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | variant
    outs = [consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk,
                                fill_bound=fb, **kw)
            for fb in (True, False, True)]
    torch.cuda.synchronize()
    # dead shards contribute exact zeros: bounded == capacity sweep, and
    # the fixed-order combine gives the same bits on every run
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    ref = consmax_decode_ref(q.float(), k, v, lengths, beta, gamma, **kw)
    ref_absv = consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                  gamma, **kw)
    _assert_within_bound(outs[0], ref, ref_absv)


PREFILL = {  # b, c, L, H, hkv, dk
    "qwen2-gqa": (2, 64, 512, 12, 2, 128),
    "gpt2-mha": (2, 16, 200, 6, 6, 64),
    "mqa-L200-c5": (2, 5, 200, 8, 1, 32),   # the reference's red Pallas case
    "dk256": (1, 24, 160, 4, 2, 256),
    "gpt2-engine": (2, 128, 1024, 6, 6, 64),   # chip_smoke's gpt2 engine
    "dk96": (2, 48, 300, 8, 2, 96),
}


@pytest.mark.parametrize("shape", PREFILL)
@pytest.mark.parametrize("variant", [dict(), dict(window=19),
                                     dict(softcap=5.0), dict(merged=False)])
def test_prefill_kernel_matches_plain(cuda, shape, variant):
    b, c, L, H, hkv, dk = PREFILL[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk, c=c)
    # slot 0 starts at a tile boundary with a ragged chunk; slot 1 ends at
    # the cache's last row
    index = torch.tensor([64 % (L - c), L - c][:b], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([c - 2, c][:b], dtype=torch.int32, device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | variant
    outs = [consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma,
                                 fill_bound=fb, **kw)
            for fb in (True, False, True)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    ref = consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, **kw)
    ref_absv = consmax_prefill_ref(q, k, v.abs(), index, lengths, beta,
                                   gamma, **kw)
    _assert_within_bound(outs[0], ref, ref_absv)


def test_prefill_empty_slot_is_exact_zeros(cuda):
    q, k, v, beta, gamma = _inputs(cuda, b=2, L=128, H=4, hkv=2, dk=64, c=8)
    index = torch.tensor([0, 40], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([0, 8], dtype=torch.int32, device=cuda)
    out = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma,
                               scale=1.0)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_prefill_chunk_running_past_the_cache_end(cuda):
    """index + lengths beyond L (the write drops the overflow rows): the
    kernel reads no row past L and matches the plain version."""
    q, k, v, beta, gamma = _inputs(cuda, b=1, L=100, H=4, hkv=2, dk=64, c=8)
    index = torch.tensor([97], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([8], dtype=torch.int32, device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    ref = consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, **kw)
    ref_absv = consmax_prefill_ref(q, k, v.abs(), index, lengths, beta,
                                   gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


def test_ops_count_launches_and_dispatch_by_device(cuda):
    q, k, v, beta, gamma = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64)
    index = torch.tensor([3, 63], dtype=torch.int32, device=cuda)
    n0 = consmax_decode_op.launches
    consmax_decode_op(q[:, None], k, v, index, beta, gamma, bk=32)
    assert consmax_decode_op.launches == n0 + 1
    consmax_decode_op(q[:, None].cpu(), k.cpu(), v.cpu(), index.cpu(),
                      beta.cpu(), gamma.cpu())          # plain: not counted
    assert consmax_decode_op.launches == n0 + 1
    qc, k, v, beta, gamma = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64, c=4)
    n0 = consmax_prefill_op.launches
    consmax_prefill_op(qc, k, v, index - 3, torch.full_like(index, 4),
                       beta, gamma)
    assert consmax_prefill_op.launches == n0 + 1
    with pytest.raises(TypeError):                       # no silent upcast
        consmax_prefill_op(qc.float(), k, v, index - 3,
                           torch.full_like(index, 4), beta, gamma)


def _paginate(k, v, fills, ps, seed=0, spare=3):
    """The rows of contiguous caches k, v (b, L, hkv, dk) moved into page
    pools (P, ps, hkv, dk) under a table of randomly permuted, disjoint
    pages, -1 past each slot's fill (``spare`` unused pages stay zero)."""
    b, L = k.shape[:2]
    npg = -(-L // ps)
    perm = np.random.default_rng(seed).permutation(b * npg + spare)
    table = np.full((b, npg), -1, np.int32)
    kp = torch.zeros((b * npg + spare, ps) + k.shape[2:], dtype=k.dtype,
                     device=k.device)
    vp = torch.zeros_like(kp)
    for s in range(b):
        for j in range(-(-int(fills[s]) // ps)):
            page = int(perm[s * npg + j])
            table[s, j] = page
            n = min(ps, L - j * ps)
            kp[page, :n] = k[s, j * ps:j * ps + n]
            vp[page, :n] = v[s, j * ps:j * ps + n]
    return kp, vp, torch.tensor(table, device=k.device)


@pytest.mark.parametrize("ps", [4, 16, 64, 256])
@pytest.mark.parametrize("shape", ["qwen2-gqa", "gpt2-mha", "head-chunks",
                                   "dk96"])
def test_decode_paged_matches_plain_and_contiguous_bits(cuda, shape, ps):
    b, L, H, hkv, dk, bk = DECODE[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk)
    # fills: empty (a free paged slot, lengths 0), a shard boundary,
    # mid-shard, full
    lengths = torch.tensor([0, bk, bk + 7, L][:b], dtype=torch.int32,
                           device=cuda)
    kp, vp, table = _paginate(k, v, lengths.tolist(), ps)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta, gamma,
                                    bk=bk, **kw)
    cont = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, cont)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    ref = consmax_decode_paged_ref(q.float(), kp, vp, table, lengths, beta,
                                   gamma, **kw)
    ref_absv = consmax_decode_paged_ref(q.float(), kp, vp.abs(), table,
                                        lengths, beta, gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


@pytest.mark.parametrize("ps", [4, 16, 64, 256])
@pytest.mark.parametrize("shape", ["qwen2-gqa", "gpt2-mha", "dk256", "dk96"])
def test_prefill_paged_matches_plain_and_contiguous_bits(cuda, shape, ps):
    b, c, L, H, hkv, dk = PREFILL[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk, c=c)
    index = torch.tensor([64 % (L - c), L - c][:b], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([c - 2, c][:b], dtype=torch.int32, device=cuda)
    kp, vp, table = _paginate(k, v, (index + lengths).tolist(), ps)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths, beta,
                                     gamma, **kw)
    cont = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, cont)
    ref = consmax_prefill_paged_ref(q, kp, vp, table, index, lengths, beta,
                                    gamma, **kw)
    ref_absv = consmax_prefill_paged_ref(q, kp, vp.abs(), table, index,
                                         lengths, beta, gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


@pytest.mark.parametrize("variant", [dict(window=37), dict(softcap=5.0),
                                     dict(merged=False), dict(hole=True),
                                     dict(fill_bound=False)])
@pytest.mark.parametrize("shape", ["qwen2-gqa", "mqa-ragged-L", "head-chunks"])
def test_decode_paged_variants(cuda, shape, variant):
    """Window, softcap, unmerged, a -1 hole inside the fill (plain version
    only: no contiguous twin holds a hole) and the capacity sweep."""
    variant = dict(variant)
    hole = variant.pop("hole", False)
    fill_bound = variant.pop("fill_bound", True)
    b, L, H, hkv, dk, bk = DECODE[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk,
                                   seed=3)
    lengths = torch.tensor([1, bk, bk + 7, L][:b], dtype=torch.int32,
                           device=cuda)
    kp, vp, table = _paginate(k, v, lengths.tolist(), 16)
    if hole:
        table[-1, 2] = -1
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | variant
    got = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta, gamma,
                                    bk=bk, fill_bound=fill_bound, **kw)
    torch.cuda.synchronize()
    if not hole:
        cont = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk,
                                   fill_bound=fill_bound, **kw)
        assert torch.equal(got, cont)
    ref = consmax_decode_paged_ref(q.float(), kp, vp, table, lengths, beta,
                                   gamma, **kw)
    ref_absv = consmax_decode_paged_ref(q.float(), kp, vp.abs(), table,
                                        lengths, beta, gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


@pytest.mark.parametrize("variant", [dict(window=19), dict(softcap=5.0),
                                     dict(merged=False), dict(hole=True),
                                     dict(fill_bound=False)])
@pytest.mark.parametrize("shape", ["qwen2-gqa", "mqa-L200-c5", "dk256"])
def test_prefill_paged_variants(cuda, shape, variant):
    variant = dict(variant)
    hole = variant.pop("hole", False)
    fill_bound = variant.pop("fill_bound", True)
    b, c, L, H, hkv, dk = PREFILL[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk, c=c,
                                   seed=4)
    index = torch.tensor([64 % (L - c), L - c][:b], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([c - 2, c][:b], dtype=torch.int32, device=cuda)
    kp, vp, table = _paginate(k, v, (index + lengths).tolist(), 8)
    if hole:
        table[-1, 1] = -1
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0) | variant
    got = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths, beta,
                                     gamma, fill_bound=fill_bound, **kw)
    torch.cuda.synchronize()
    if not hole and fill_bound:
        cont = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma,
                                    **kw)
        assert torch.equal(got, cont)
    ref = consmax_prefill_paged_ref(q, kp, vp, table, index, lengths, beta,
                                    gamma, **kw)
    ref_absv = consmax_prefill_paged_ref(q, kp, vp.abs(), table, index,
                                         lengths, beta, gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


def test_prefill_paged_chunk_past_the_table_end(cuda):
    """A chunk whose rows run past the table's last column: the kernel
    clamps the column, reads no row there and matches the plain version."""
    q, k, v, beta, gamma = _inputs(cuda, b=1, L=100, H=4, hkv=2, dk=64, c=8)
    index = torch.tensor([97], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([8], dtype=torch.int32, device=cuda)
    kp, vp, table = _paginate(k, v, [100], 4)              # 25 columns
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths, beta,
                                     gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, consmax_prefill_cuda(q, k, v, index, lengths,
                                                 beta, gamma, **kw))
    ref = consmax_prefill_paged_ref(q, kp, vp, table, index, lengths, beta,
                                    gamma, **kw)
    ref_absv = consmax_prefill_paged_ref(q, kp, vp.abs(), table, index,
                                         lengths, beta, gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


def test_paged_ops_count_launches_and_dispatch_by_device(cuda):
    q, k, v, beta, gamma = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64)
    lengths = torch.tensor([4, 64], dtype=torch.int32, device=cuda)
    kp, vp, table = _paginate(k, v, lengths.tolist(), 16)
    n0, c0 = consmax_decode_paged_op.launches, consmax_decode_op.launches
    consmax_decode_paged_op(q[:, None], kp, vp, table, lengths, beta, gamma,
                            bk=32)
    assert consmax_decode_paged_op.launches == n0 + 1
    assert consmax_decode_op.launches == c0              # its own counter
    consmax_decode_paged_op(q[:, None].cpu(), kp.cpu(), vp.cpu(),
                            table.cpu(), lengths.cpu(), beta.cpu(),
                            gamma.cpu())                 # plain: not counted
    assert consmax_decode_paged_op.launches == n0 + 1
    qc, k, v, beta, gamma = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64, c=4)
    kp, vp, table = _paginate(k, v, lengths.tolist(), 16)
    n0 = consmax_prefill_paged_op.launches
    consmax_prefill_paged_op(qc, kp, vp, table, lengths - 4,
                             torch.full_like(lengths, 4), beta, gamma)
    assert consmax_prefill_paged_op.launches == n0 + 1
    with pytest.raises(ValueError):                      # table must be int32
        consmax_prefill_paged_op(qc, kp, vp, table.long(), lengths - 4,
                                 torch.full_like(lengths, 4), beta, gamma)


# ------------------------------------------- full-sequence attention ----
ATTN = {  # b, sq, skv, H, hkv, dk
    "qwen2-gqa": (2, 256, 256, 12, 2, 128),
    "gpt2-mha": (2, 200, 200, 6, 6, 64),          # ragged: not a 64-multiple
    "mqa-dk32": (2, 100, 100, 8, 1, 32),
    "gemma2-dk256": (1, 96, 96, 8, 4, 256),
    "kv-longer": (1, 64, 192, 4, 1, 64),
    "q-longer": (1, 150, 70, 4, 2, 64),
    "dk96": (2, 130, 130, 8, 2, 96),
}
ATTN_VARIANTS = [dict(), dict(window=37), dict(softcap=5.0),
                 dict(causal=False), dict(window=50, softcap=30.0)]


def _seq_inputs(dev, *, b, sq, skv, H, hkv, dk, seed=0):
    r = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(r.standard_normal(shape) * scale,
                            dtype=torch.bfloat16, device=dev)

    q = t((b, sq, H, dk))
    k, v = t((b, skv, hkv, dk)), t((b, skv, hkv, dk))
    beta = torch.tensor(r.uniform(0.5, 2.5, H), dtype=torch.float32,
                        device=dev)
    return q, k, v, beta, torch.full((H,), 100.0, device=dev)


def _model_layout(fn, q, k, v, *args, **kw):
    """A plain version (kernel layout) applied to model-layout tensors."""
    return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), *args,
              **kw).float().transpose(1, 2)


@pytest.mark.parametrize("shape", ATTN)
@pytest.mark.parametrize("variant", ATTN_VARIANTS + [dict(merged=True)])
def test_consmax_attention_matches_plain(cuda, shape, variant):
    b, sq, skv, H, hkv, dk = ATTN[shape]
    q, k, v, beta, gamma = _seq_inputs(cuda, b=b, sq=sq, skv=skv, H=H,
                                       hkv=hkv, dk=dk)
    outs = [consmax_attention_cuda(q, k, v, beta, gamma, **variant)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])          # fixed order: same bits
    ref = _model_layout(consmax_attention_ref, q.float(), k, v, beta, gamma,
                        **variant)
    ref_absv = _model_layout(consmax_attention_ref, q.float(), k, v.abs(),
                             beta, gamma, **variant)
    _assert_within_bound(outs[0], ref, ref_absv)


@pytest.mark.parametrize("shape", ATTN)
@pytest.mark.parametrize("variant", ATTN_VARIANTS)
def test_softmax_attention_matches_plain(cuda, shape, variant):
    b, sq, skv, H, hkv, dk = ATTN[shape]
    q, k, v, _, _ = _seq_inputs(cuda, b=b, sq=sq, skv=skv, H=H, hkv=hkv,
                                dk=dk, seed=1)
    got = softmax_attention_cuda(q, k, v, **variant)
    torch.cuda.synchronize()
    ref = _model_layout(softmax_attention_ref, q.float(), k, v, **variant)
    ref_absv = _model_layout(softmax_attention_ref, q.float(), k, v.abs(),
                             **variant)
    _assert_within_bound(got, ref, ref_absv)


@pytest.mark.parametrize("shape", ["qwen2-gqa", "gpt2-mha", "mqa-dk32",
                                   "gemma2-dk256", "dk96"])
@pytest.mark.parametrize("variant", [dict(), dict(window=37),
                                     dict(softcap=5.0)])
def test_consmax_attention_gives_prefill_kernel_bits(cuda, shape, variant):
    """Causal, sq = skv, merged, pre-scaled q: the full-sequence kernel is
    the prefill kernel at index 0, lengths sq, on the same rows, bit for
    bit (the same tiles in the same order through the same tile steps)."""
    b, sq, _, H, hkv, dk = ATTN[shape]
    q, k, v, beta, gamma = _seq_inputs(cuda, b=b, sq=sq, skv=sq, H=H,
                                       hkv=hkv, dk=dk, seed=2)
    q = (q.float() * dk ** -0.5).to(torch.bfloat16)
    kw = dict(merged=True, scale=1.0, **variant)
    got = consmax_attention_cuda(q, k, v, beta, gamma, causal=True, **kw)
    index = torch.zeros(b, dtype=torch.int32, device=cuda)
    lengths = torch.full((b,), sq, dtype=torch.int32, device=cuda)
    pre = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, pre)


def test_decode_kernel_equals_attention_kernel_last_row(cuda):
    b, L, H, hkv, dk = 2, 300, 12, 2, 128
    q, k, v, beta, gamma = _seq_inputs(cuda, b=b, sq=L, skv=L, H=H, hkv=hkv,
                                       dk=dk, seed=3)
    full = consmax_attention_cuda(q, k, v, beta, gamma)
    lengths = torch.full((b,), L, dtype=torch.int32, device=cuda)
    dec = consmax_decode_cuda(q[:, -1].contiguous(), k, v, lengths, beta,
                              gamma, merged=False, bk=128)
    torch.cuda.synchronize()
    ref_absv = _model_layout(consmax_attention_ref, q.float(), k, v.abs(),
                             beta, gamma)[:, -1]
    _assert_within_bound(dec, full[:, -1].float(), ref_absv)


@pytest.mark.parametrize("scale", [0.03, 128 ** -0.5, 0.125])
def test_lut_all_256_codes(cuda, scale):
    s8 = torch.arange(-128, 128, dtype=torch.int8, device=cuda)
    got = consmax_lut_op(s8, 0.01, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_product(s8, 0.01,
                                        *make_luts(scale, cuda)))
    ref = consmax_lut_ref(s8, 0.01, scale)
    assert float(((got - ref).abs() / ref.abs()).max()) < 1e-5


@pytest.mark.parametrize("n", [1, 7, 16, 1000, 4097, 1 << 20])
def test_lut_lengths_and_device_constant(cuda, n):
    """Odd lengths take the tail path; C as a 0-d device tensor (read on
    the device) gives the bits of C as a float."""
    r = np.random.default_rng(n)
    s8 = torch.tensor(r.integers(-128, 128, n), dtype=torch.int8,
                      device=cuda)
    luts = make_luts(0.05, cuda)
    got = consmax_lut_cuda(s8, 0.5, *luts)
    dev_c = consmax_lut_cuda(s8, torch.tensor(0.5, device=cuda), *luts)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_product(s8, 0.5, *luts))
    assert torch.equal(dev_c, got)
    ref = consmax_lut_ref(s8, 0.5, 0.05)
    assert float(((got - ref).abs() / ref.abs()).max()) < 1e-5


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("n", [7, 1000, 4096 * 3 + 5])
def test_lut_codes_off_a_16_byte_boundary(cuda, offset, n):
    """A slice of a score matrix that does not start on a 16-byte
    boundary goes code by code and gives the aligned codes' bits."""
    r = np.random.default_rng(offset * n)
    buf = torch.tensor(r.integers(-128, 128, n + offset), dtype=torch.int8,
                       device=cuda)
    s8 = buf[offset:]
    assert s8.data_ptr() % 16
    luts = make_luts(0.05, cuda)
    got = consmax_lut_cuda(s8, 0.5, *luts)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_product(s8, 0.5, *luts))
    assert torch.equal(got, consmax_lut_cuda(s8.clone(), 0.5, *luts))


def test_paper_ops_count_launches_and_dispatch_by_device(cuda):
    q, k, v, beta, gamma = _seq_inputs(cuda, b=1, sq=64, skv=64, H=4, hkv=2,
                                       dk=64)
    cpu = [t.cpu() for t in (q, k, v, beta, gamma)]
    n0 = consmax_attention_op.launches
    consmax_attention_op(q, k, v, beta, gamma)
    consmax_attention_op(*cpu)                           # plain: not counted
    assert consmax_attention_op.launches == n0 + 1
    n0 = softmax_attention_op.launches
    softmax_attention_op(q, k, v)
    softmax_attention_op(*cpu[:3])
    assert softmax_attention_op.launches == n0 + 1
    s8 = torch.arange(-128, 128, dtype=torch.int8, device=cuda)
    n0 = consmax_lut_op.launches
    got = consmax_lut_op(s8.reshape(16, 16), 0.01, scale=0.1)
    assert got.shape == (16, 16) and got.device == s8.device
    consmax_lut_op(s8.cpu(), 0.01, scale=0.1)
    assert consmax_lut_op.launches == n0 + 1


def test_paper_ops_refuse_what_the_kernels_cannot_take(cuda):
    q, k, v, beta, gamma = _seq_inputs(cuda, b=1, sq=64, skv=64, H=4, hkv=2,
                                       dk=64)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    for op, extra in ((consmax_attention_op, (beta, gamma)),
                      (softmax_attention_op, ())):
        with pytest.raises(TypeError):                   # no silent upcast
            op(q.half(), k.half(), v.half(), *extra)
        with pytest.raises(TypeError):                   # mixed bf16 / fp32
            op(q.float(), k, v, *extra)
        with pytest.raises(ValueError):                  # no hidden copy
            op(strided, k, v, *extra)
        with pytest.raises(ValueError):                  # 3 query heads
            op(q[:, :, :3].contiguous(), k, v, *[t[:3] for t in extra])
    s8 = torch.arange(-128, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        consmax_lut_op(s8.int(), 0.01, scale=0.1)
    with pytest.raises(ValueError):                      # no hidden copy
        consmax_lut_op(s8.reshape(16, 16).t(), 0.01, scale=0.1)


# ------------------------------------------------- quantized KV caches ----
QDTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def _quantized(x, name):
    """Codes, scales and the dequantized bf16 cache of ``x``."""
    codes, scale = CL.quantize_kv(x, QDTYPES[name])
    return codes, scale, CL.dequant_block(codes, scale, torch.bfloat16)


@pytest.mark.parametrize("name", QDTYPES)
@pytest.mark.parametrize("shape", ["qwen2-gqa", "gpt2-mha", "mqa-ragged-L",
                                   "head-chunks", "dk96"])
def test_decode_quantized_bits(cuda, shape, name):
    b, L, H, hkv, dk, bk = DECODE[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk,
                                   seed=5)
    kq, ks, kd = _quantized(k, name)
    vq, vs, vd = _quantized(v, name)
    lengths = torch.tensor([1, bk, bk + 7, L][:b], dtype=torch.int32,
                           device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0, bk=bk)
    got = consmax_decode_cuda(q, kq, vq, lengths, beta, gamma, k_scale=ks,
                              v_scale=vs, **kw)
    yard = consmax_decode_cuda(q, kd, vd, lengths, beta, gamma, **kw)
    fills = lengths.tolist()
    kp, vp, table = _paginate(kq, vq, fills, 16)
    ksp, vsp, _ = _paginate(ks, vs, fills, 16)          # the same table
    paged = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta,
                                      gamma, k_scale=ksp, v_scale=vsp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, yard) and torch.equal(paged, got)
    del kw["bk"]
    # the plain version on the dequantized cache (the kernel's arithmetic:
    # bf16 values), fp32 out
    ref = consmax_decode_ref(q.float(), kd, vd, lengths, beta, gamma, **kw)
    ref_absv = consmax_decode_ref(q.float(), kd, vd.abs(), lengths, beta,
                                  gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


@pytest.mark.parametrize("name", QDTYPES)
@pytest.mark.parametrize("shape", ["qwen2-gqa", "gpt2-mha", "mqa-L200-c5",
                                   "dk256", "dk96"])
def test_prefill_quantized_bits(cuda, shape, name):
    b, c, L, H, hkv, dk = PREFILL[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk, c=c,
                                   seed=6)
    kq, ks, kd = _quantized(k, name)
    vq, vs, vd = _quantized(v, name)
    index = torch.tensor([64 % (L - c), L - c][:b], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([c - 2, c][:b], dtype=torch.int32, device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_cuda(q, kq, vq, index, lengths, beta, gamma,
                               k_scale=ks, v_scale=vs, **kw)
    yard = consmax_prefill_cuda(q, kd, vd, index, lengths, beta, gamma, **kw)
    fills = (index + lengths).tolist()
    kp, vp, table = _paginate(kq, vq, fills, 8)
    ksp, vsp, _ = _paginate(ks, vs, fills, 8)
    paged = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths,
                                       beta, gamma, k_scale=ksp, v_scale=vsp,
                                       **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, yard) and torch.equal(paged, got)
    # q is bf16: the plain version dequantizes to bf16, as the kernel does
    ref = consmax_prefill_ref(q, kq, vq, index, lengths, beta, gamma,
                              k_scale=ks, v_scale=vs, **kw)
    ref_absv = consmax_prefill_ref(q, kd, vd.abs(), index, lengths, beta,
                                   gamma, **kw)
    _assert_within_bound(got, ref, ref_absv)


def test_decode_on_int8_codes_matches_the_lut(cuda):
    """All 256 int8 codes as K rows (code in lane 0, scale 1.0), q = e_0,
    V the 256 x 256 identity (scale 1.0): lane d of the decode output is
    ``C * exp(sigma * s_d)``, what ``consmax_lut`` computes from the codes
    (the reference's check, ``tests/test_quantized_kv.py:217``, at dk
    256: the kernels take dk >= 32)."""
    n = 256
    codes = torch.arange(-128, 128, dtype=torch.int32,
                         device=cuda).to(torch.int8)
    k = torch.zeros((1, n, 1, n), dtype=torch.int8, device=cuda)
    k[0, :, 0, 0] = codes
    v = torch.eye(n, dtype=torch.int8, device=cuda)[None, :, None, :]
    ones = torch.ones((1, n, 1), device=cuda)
    q = torch.zeros((1, 1, n), dtype=torch.bfloat16, device=cuda)
    q[0, 0, 0] = 1.0
    beta = torch.tensor([1.5], device=cuda)
    gamma = torch.tensor([100.0], device=cuda)
    sigma = 1.0 / 16.0
    out = consmax_decode_cuda(q, k, v, torch.tensor([n], dtype=torch.int32,
                                                    device=cuda), beta,
                              gamma, scale=sigma, k_scale=ones, v_scale=ones)
    lut = consmax_lut_op(codes, torch.exp(-beta[0]) / gamma[0], scale=sigma)
    torch.cuda.synchronize()
    ulp = 2.0 ** (torch.floor(torch.log2(lut.abs())) - 7)
    assert bool(((out[0, 0].float() - lut).abs() <= ulp).all())


def test_serving_ops_refuse_mismatched_scales_on_cuda(cuda):
    q, k, v, beta, gamma = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64)
    kq, ks, _ = _quantized(k, "int8")
    vq, vs, _ = _quantized(v, "int8")
    index = torch.tensor([3, 63], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="needs its k_scale"):
        consmax_decode_op(q[:, None], kq, vq, index, beta, gamma)
    with pytest.raises(ValueError, match="takes no"):
        consmax_decode_op(q[:, None], k, v, index, beta, gamma, k_scale=ks,
                          v_scale=vs)
    with pytest.raises(TypeError):                       # fp32 cache
        consmax_decode_op(q[:, None], k.float(), v.float(), index, beta,
                          gamma)
    qc = _inputs(cuda, b=2, L=64, H=4, hkv=2, dk=64, c=4)[0]
    with pytest.raises(ValueError, match="needs its k_scale"):
        consmax_prefill_op(qc, kq, vq, index - 3, torch.full_like(index, 4),
                           beta, gamma)
    with pytest.raises(ValueError, match="float32 of shape"):
        consmax_prefill_op(qc, kq, vq, index - 3, torch.full_like(index, 4),
                           beta, gamma, k_scale=ks[:, :8], v_scale=vs[:, :8])


# ------------------------------------------ the Hopper mainloop's edges ----
# Walk lengths against the ring of shared-memory stages (3 stages; 2 at
# head_dim 256 with a quantized cache): one 64-row tile, fewer tiles than
# stages, exactly three tiles, and a ragged last tile.
WALK = {"one-tile": 64, "fewer-than-stages": 128, "three-tiles": 192,
        "ragged-last": 200}


@pytest.mark.parametrize("dk", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("walk", WALK)
def test_mainloop_walk_lengths_attention(cuda, walk, dk):
    """Non-causal, so every CTA walks all ceil(s / 64) tiles: both attention
    kernels against their plain versions; causal, consmax_attention gives
    the prefill kernel's bits."""
    s = WALK[walk]
    q, k, v, beta, gamma = _seq_inputs(cuda, b=1, sq=s, skv=s, H=4, hkv=2,
                                       dk=dk, seed=11)
    for merged in (False, True):
        got = consmax_attention_cuda(q, k, v, beta, gamma, causal=False,
                                     merged=merged)
        torch.cuda.synchronize()
        kw = dict(causal=False, merged=merged)
        _assert_within_bound(
            got, _model_layout(consmax_attention_ref, q.float(), k, v, beta,
                               gamma, **kw),
            _model_layout(consmax_attention_ref, q.float(), k, v.abs(),
                          beta, gamma, **kw))
    got = softmax_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_within_bound(
        got, _model_layout(softmax_attention_ref, q.float(), k, v,
                           causal=False),
        _model_layout(softmax_attention_ref, q.float(), k, v.abs(),
                      causal=False))
    qs = (q.float() * dk ** -0.5).to(torch.bfloat16)
    kw = dict(merged=True, scale=1.0)
    full = consmax_attention_cuda(qs, k, v, beta, gamma, causal=True, **kw)
    pre = consmax_prefill_cuda(
        qs, k, v, torch.zeros(1, dtype=torch.int32, device=cuda),
        torch.full((1,), s, dtype=torch.int32, device=cuda), beta, gamma,
        **kw)
    torch.cuda.synchronize()
    assert torch.equal(full, pre)


@pytest.mark.parametrize("dk", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("walk", WALK)
def test_mainloop_walk_lengths_prefill(cuda, walk, dk):
    """A 16-row chunk ending at fill s (each CTA walks ceil(s / 64) tiles):
    bf16 against the plain version, int8 and fp8 bit-equal to the bf16
    kernel on the dequantized cache, paged (page size 16) bit-equal to
    contiguous."""
    s, c = WALK[walk], 16
    q, k, v, beta, gamma = _inputs(cuda, b=1, L=s, H=4, hkv=2, dk=dk, c=c,
                                   seed=12)
    index = torch.tensor([s - c], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([c], dtype=torch.int32, device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    kp, vp, table = _paginate(k, v, [s], 16)
    paged = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths,
                                       beta, gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(paged, got)
    _assert_within_bound(
        got, consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, **kw),
        consmax_prefill_ref(q, k, v.abs(), index, lengths, beta, gamma,
                            **kw))
    for name in QDTYPES:
        kq, ks, kd = _quantized(k, name)
        vq, vs, vd = _quantized(v, name)
        quant = consmax_prefill_cuda(q, kq, vq, index, lengths, beta, gamma,
                                     k_scale=ks, v_scale=vs, **kw)
        yard = consmax_prefill_cuda(q, kd, vd, index, lengths, beta, gamma,
                                    **kw)
        torch.cuda.synchronize()
        assert torch.equal(quant, yard), name


@pytest.mark.parametrize("dk", [64, 256])
def test_mainloop_window_starting_mid_tile(cuda, dk):
    """Windows whose first visible key falls inside a 64-row tile, for the
    prefill kernel (chunk at 200, window 37: keys from 164) and both
    attention kernels (s 300, window 100)."""
    q, k, v, beta, gamma = _inputs(cuda, b=1, L=300, H=4, hkv=2, dk=dk,
                                   c=32, seed=13)
    index = torch.tensor([200], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([32], dtype=torch.int32, device=cuda)
    kw = dict(window=37, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    _assert_within_bound(
        got, consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, **kw),
        consmax_prefill_ref(q, k, v.abs(), index, lengths, beta, gamma,
                            **kw))
    q, k, v, beta, gamma = _seq_inputs(cuda, b=1, sq=300, skv=300, H=4,
                                       hkv=2, dk=dk, seed=14)
    got = consmax_attention_cuda(q, k, v, beta, gamma, window=100)
    soft = softmax_attention_cuda(q, k, v, window=100)
    torch.cuda.synchronize()
    _assert_within_bound(
        got, _model_layout(consmax_attention_ref, q.float(), k, v, beta,
                           gamma, window=100),
        _model_layout(consmax_attention_ref, q.float(), k, v.abs(), beta,
                      gamma, window=100))
    _assert_within_bound(
        soft, _model_layout(softmax_attention_ref, q.float(), k, v,
                            window=100),
        _model_layout(softmax_attention_ref, q.float(), k, v.abs(),
                      window=100))


def test_prefill_engine_shape(cuda):
    """The engine's chunk: qwen2-1.5b (12 heads, 2 KV heads, dk 128), b 1 x
    c 512 at fill 4096 (index 3584) of an 8192-row cache: against the plain
    version, paged (page size 256) bit-equal to contiguous, int8 bit-equal
    to the bf16 kernel on the dequantized cache."""
    q, k, v, beta, gamma = _inputs(cuda, b=1, L=8192, H=12, hkv=2, dk=128,
                                   c=512, seed=15)
    index = torch.tensor([3584], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([512], dtype=torch.int32, device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_prefill_cuda(q, k, v, index, lengths, beta, gamma, **kw)
    kp, vp, table = _paginate(k, v, [4096], 256)
    paged = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths,
                                       beta, gamma, **kw)
    kq, ks, kd = _quantized(k, "int8")
    vq, vs, vd = _quantized(v, "int8")
    quant = consmax_prefill_cuda(q, kq, vq, index, lengths, beta, gamma,
                                 k_scale=ks, v_scale=vs, **kw)
    yard = consmax_prefill_cuda(q, kd, vd, index, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(paged, got) and torch.equal(quant, yard)
    _assert_within_bound(
        got, consmax_prefill_ref(q, k, v, index, lengths, beta, gamma, **kw),
        consmax_prefill_ref(q, k, v.abs(), index, lengths, beta, gamma,
                            **kw))


@pytest.mark.parametrize("ps", [4, 16, 64, 256])
@pytest.mark.parametrize("name", QDTYPES)
@pytest.mark.parametrize("shape", ["qwen2-gqa", "dk256", "dk96"])
def test_prefill_paged_quantized_bits(cuda, shape, name, ps):
    """Quantized page pools (codes and scales under one table) give the
    contiguous quantized kernel's bits at every page size the tests use."""
    b, c, L, H, hkv, dk = PREFILL[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk, c=c,
                                   seed=16)
    kq, ks, _ = _quantized(k, name)
    vq, vs, _ = _quantized(v, name)
    index = torch.tensor([64 % (L - c), L - c][:b], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([c - 2, c][:b], dtype=torch.int32, device=cuda)
    fills = (index + lengths).tolist()
    kp, vp, table = _paginate(kq, vq, fills, ps)
    ksp, vsp, _ = _paginate(ks, vs, fills, ps)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    paged = consmax_prefill_paged_cuda(q, kp, vp, table, index, lengths,
                                       beta, gamma, k_scale=ksp, v_scale=vsp,
                                       **kw)
    cont = consmax_prefill_cuda(q, kq, vq, index, lengths, beta, gamma,
                                k_scale=ks, v_scale=vs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(paged, cont)


# ------------------------------------------- the decode kernel's tile walk ----
# The decode kernel walks each shard in 32-row tiles through a ring of
# shared-memory stages, the g heads of a group (up to 16) as the rows of one
# mma tile. Cases: b, L, H, hkv, dk, bk, page size, K/V dtype, fills, window.
# Fills sit on and one past a tile boundary inside a shard (32 / 33 in
# shard 0, bk + 32 / bk + 33 in shard 1); page size 4 makes every tile span
# eight pages, 12 does not divide a tile.
DECODE_WALK = {
    "g6-dk128": (4, 320, 12, 2, 128, 128, 4, "bf16", [32, 33, 160, 161], 0),
    "g10-dk256": (2, 256, 20, 2, 256, 128, 4, "bf16", [64, 97], 0),
    "g16-dk128": (2, 256, 32, 2, 128, 128, 16, "bf16", [33, 161], 0),
    "g17-two-groups": (2, 128, 34, 2, 64, 64, 8, "bf16", [32, 97], 0),
    "g1-mha-dk64": (4, 300, 6, 6, 64, 128, 12, "bf16", [32, 33, 160, 161], 0),
    "g6-window-mid-tile": (2, 320, 12, 2, 128, 128, 4, "bf16", [161, 300],
                           37),
    "dk32-int8": (4, 200, 8, 1, 32, 64, 4, "int8", [32, 33, 96, 97], 0),
    "dk256-int8": (2, 256, 8, 2, 256, 128, 4, "int8", [64, 161], 0),
    "dk256-fp8": (2, 256, 8, 2, 256, 128, 12, "fp8_e4m3", [33, 160], 0),
    "dk96-g4": (4, 320, 16, 4, 96, 128, 4, "bf16", [32, 33, 160, 161], 0),
    "dk96-int8": (2, 256, 8, 2, 96, 128, 12, "int8", [64, 161], 0),
    "dk96-fp8-window": (2, 320, 8, 8, 96, 128, 16, "fp8_e4m3", [161, 300],
                        37),
}


@pytest.mark.parametrize("case", DECODE_WALK)
def test_decode_tile_walk_edges(cuda, case):
    """Against the plain version; bounded == capacity sweep bits; paged ==
    contiguous bits; a quantized cache == the bf16 kernel's bits on its
    dequantized values."""
    b, L, H, hkv, dk, bk, ps, kv, fills, window = DECODE_WALK[case]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk,
                                   seed=17)
    lengths = torch.tensor(fills, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=0.0, merged=True, scale=1.0, bk=bk)
    sc, psc, kc, vc = {}, {}, k, v
    if kv != "bf16":
        kc, ks, k = _quantized(k, kv)
        vc, vs, v = _quantized(v, kv)
        sc = dict(k_scale=ks, v_scale=vs)
        ksp, vsp, _ = _paginate(ks, vs, fills, ps)
        psc = dict(k_scale=ksp, v_scale=vsp)
    outs = [consmax_decode_cuda(q, kc, vc, lengths, beta, gamma,
                                fill_bound=fb, **sc, **kw)
            for fb in (True, False)]
    kp, vp, table = _paginate(kc, vc, fills, ps)
    paged = consmax_decode_paged_cuda(q, kp, vp, table, lengths, beta, gamma,
                                      **psc, **kw)
    yard = consmax_decode_cuda(q, k, v, lengths, beta, gamma, **kw)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(paged, outs[0])
    assert torch.equal(outs[0], yard)            # bf16: the same call
    del kw["bk"]
    _assert_within_bound(
        outs[0], consmax_decode_ref(q.float(), k, v, lengths, beta, gamma,
                                    **kw),
        consmax_decode_ref(q.float(), k, v.abs(), lengths, beta, gamma,
                           **kw))


def test_decode_ptxas_report(cuda):
    """Every decode_partials instantiation (5 head dims x 2 forms x 3 K/V
    types x 2 row addresses) builds without spills, and its static plus
    dynamic shared memory at the largest shard fits a block and equals the
    launch plan's (``decode_smem_bytes``)."""
    import re

    from repro_torch.kernels.consmax_decode import ops as decode_ops
    lib = decode_ops._lib()
    kv_codes = {"13__nv_bfloat16": 0, "a": 1, "13__nv_fp8_e4m3": 2}
    seen = 0
    for r in _build.ptxas_report("consmax_decode"):
        m = re.search(r"decode_partialsILi(\d+)ELb[01]E(13__nv_bfloat16|a|"
                      r"13__nv_fp8_e4m3)\d+(Contig|Paged)Rows", r["kernel"])
        if not m:
            continue
        seen += 1
        dk, kv, rows = m.groups()
        dyn = lib.consmax_decode_smem_bytes(int(dk), kv_codes[kv],
                                            int(rows == "Paged"),
                                            decode_ops.MAX_BLOCK)
        assert r["spill_stores"] == r["spill_loads"] == 0, r
        assert 0 < dyn and r["smem"] + dyn <= _build.SMEM_PER_BLOCK, (r, dyn)
        assert dyn == decode_ops.decode_smem_bytes(
            int(dk), kv != "13__nv_bfloat16", rows == "Paged",
            decode_ops.MAX_BLOCK)
    assert seen == 60


@pytest.mark.parametrize("shape", ["qwen2-gqa", "dk96"])
def test_decode_launch_replays_in_a_cuda_graph(cuda, shape):
    """The kernel reads the lengths on the device and leaves its tickets
    zero, so one captured launch replays with new lengths and gives an
    eager launch's bits each time."""
    b, L, H, hkv, dk, bk = DECODE[shape]
    q, k, v, beta, gamma = _inputs(cuda, b=b, L=L, H=H, hkv=hkv, dk=dk,
                                   seed=19)
    lengths = torch.tensor([1, bk, bk + 7, L], dtype=torch.int32,
                           device=cuda)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0, bk=bk)
    consmax_decode_cuda(q, k, v, lengths, beta, gamma, **kw)   # built, warm
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = consmax_decode_cuda(q, k, v, lengths, beta, gamma, **kw)
    for fills in ([3, 130, 300, 512], [0, 1, bk - 1, bk + 1],
                  [1, bk, bk + 7, L]):
        lengths.copy_(torch.tensor(fills, dtype=torch.int32))
        graph.replay()
        eager = consmax_decode_cuda(q, k, v, lengths.clone(), beta, gamma,
                                    **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), fills


# ------------------------------------------- fp32 full-sequence kernels ----
F32_TOL = 2e-5    # the reference's fp32 tolerance (tests/test_kernels.py)


@pytest.mark.parametrize("shape", ATTN)
@pytest.mark.parametrize("variant", ATTN_VARIANTS + [dict(merged=True)])
def test_fp32_attention_kernels_match_plain(cuda, shape, variant):
    """fp32 q / k / v take the SIMT kernel (fp32 products and exp): both
    attention kernels within the reference's fp32 atol of their plain
    versions, the same bits on a second run."""
    b, sq, skv, H, hkv, dk = ATTN[shape]
    q, k, v, beta, gamma = (t.float() for t in _seq_inputs(
        cuda, b=b, sq=sq, skv=skv, H=H, hkv=hkv, dk=dk, seed=21))
    outs = [consmax_attention_cuda(q, k, v, beta, gamma, **variant)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.float32 and torch.equal(outs[0], outs[1])
    ref = _model_layout(consmax_attention_ref, q, k, v, beta, gamma,
                        **variant)
    assert float((outs[0] - ref).abs().max()) <= F32_TOL
    if "merged" in variant:
        return
    got = softmax_attention_cuda(q, k, v, **variant)
    torch.cuda.synchronize()
    ref = _model_layout(softmax_attention_ref, q, k, v, **variant)
    assert float((got - ref).abs().max()) <= F32_TOL
