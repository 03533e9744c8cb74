"""The continuous engine's static steps: one program per step, fixed
tensors, the per-slot path's bits.

``ContinuousBatchingEngine`` runs its append-chunk prefill step and its
masked decode step over fixed device inputs (the slot, lengths and tokens
of a chunk; the active mask), with the slot a device value: the
counterpart of the reference's ``jax.jit`` steps with traced slot and
lengths, and what a graphed engine captures as CUDA graphs. On the CPU
(gpt2-consmax smoke size, both kernel flags on, their plain versions run,
one thread):

* the aten ops that ``op_lint.record_ops`` records for the prefill step
  over three (slot, start, n) chunks, and for the decode step over
  different active masks and page tables, are the same ops with the same
  shapes and dtypes: one program per (step, argmax | draw), contiguous and
  paged, bf16 and int8 KV. The engine's first step is left out: it casts
  the fp32 smoke parameters to the compute dtype once and keeps the copies
  (``nn.layers``), as the eager run before a capture does;
* every cache leaf and every fixed input keeps its ``data_ptr`` across
  steps and recycled slots; the engine is not graphed here and has
  captured nothing;
* the static steps give, in every slot after every iteration, the caches
  and the tokens of the per-slot path they replace (a batch-1 view of the
  slot, the slot a Python int), bit for bit;
* ``consmax_prefill_ref`` with a ``slot`` operand over the whole slot pool
  equals its call on the slot's view bit for bit, and matches the
  reference's ``consmax_prefill_ref`` on that slot at fp32 (rtol / atol
  1e-5, as tests/test_torch_prefill.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels.consmax_prefill.ref import consmax_prefill_ref as jref
from repro_torch.analysis import op_lint as OL
from repro_torch.configs.base import ConSmaxConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import attention as TA
from repro_torch.core.consmax import ConSmaxParams
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_op
from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref
from repro_torch.models import transformer as T
from repro_torch.serve import sampling as S
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import init_params

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 8
# prompt lengths and new tokens: multi-chunk and ragged admissions, more
# requests than slots (recycling), decode over changing active masks
LENS = [13, 5, 11, 3, 9]
NEW = [4, 6, 3, 5, 2]
CASES = [(paged, kv) for paged in (False, True)
         for kv in ("bfloat16", "int8")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("gpt2-consmax", smoke=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _scfg(paged, kv):
    extra = dict(paged_kv=True, page_size=4, num_pages=24) if paged else {}
    return ServeConfig(max_slots=2, max_seq=32, prefill_chunk=CHUNK,
                       decode_kernel=True, prefill_kernel=True,
                       decode_kv_block=16, kv_cache_dtype=kv, **extra)


def _submit(eng, vocab, draw, seed=0):
    r = np.random.default_rng(seed)
    for i, (n, new) in enumerate(zip(LENS, NEW)):
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=10 + i)
              if draw and i % 2 else None)
        eng.submit(r.integers(0, vocab, n).tolist(), new, sampling=sp)


def _fixed(eng):
    """Every tensor a step reads or writes in place: the cache leaves, the
    staged inputs, the page table, the bank and the token feedback."""
    ts = [t for sup in eng.caches for blk in sup.values()
          for c in blk.values() for t in c.values()]
    ts += [eng._prefill_in.dev, eng._decode_in.dev, eng._last,
           *eng.bank.values()]
    if eng.paged:
        ts.append(eng._table.dev)
    return ts


@pytest.mark.parametrize("draw", [False, True], ids=["argmax", "draw"])
@pytest.mark.parametrize("paged,kv", CASES)
def test_each_step_is_one_program_on_fixed_tensors(model, paged, kv, draw):
    cfg, params = model
    eng = ContinuousBatchingEngine(cfg, _scfg(paged, kv), params,
                                   device="cpu")
    assert not eng.graphed
    ptrs = [t.data_ptr() for t in _fixed(eng)]
    seen, calls = {}, []
    inputs = {"prefill": set(), "decode": set()}
    for step in inputs:
        real = getattr(eng, f"_{step}_step")

        def run(d, step=step, real=real):
            buf = (eng._prefill_in if step == "prefill"
                   else eng._decode_in).dev
            table = eng._table.dev.clone() if paged else torch.zeros(0)
            inputs[step].add((tuple(buf.flatten().tolist()),
                              tuple(table.flatten().tolist())))
            with OL.record_ops() as ops:
                out = real(d)
            if calls:
                seen.setdefault((step, d), []).append(ops)
            calls.append(step)
            assert [t.data_ptr() for t in _fixed(eng)] == ptrs
            return out
        setattr(eng, f"_{step}_step", run)
    _submit(eng, cfg.vocab_size, draw)
    results = eng.run(max_steps=200)
    assert sorted(len(t) for t in results.values()) == sorted(NEW)
    # three or more distinct (slot, length, tokens) chunks, two or more
    # active masks (and page tables), each step one op sequence
    assert len(inputs["prefill"]) >= 3 and len(inputs["decode"]) >= 2
    if paged:
        assert len({t for _, t in inputs["decode"]}) >= 2
    assert {step for step, _ in seen} == {"prefill", "decode"}
    assert {d for _, d in seen} == ({False, True} if draw else {False})
    for key, runs in seen.items():
        assert runs[0] and all(ops == runs[0] for ops in runs), key
    assert [t.data_ptr() for t in _fixed(eng)] == ptrs
    assert eng.prefill_cache_size == eng.decode_cache_size == 1
    assert eng.prefill_graphs == eng.decode_graphs == eng.graph_replays == 0
    assert eng.graph_pool_bytes == 0 and eng.capture_seconds == {}


def _slot_view(caches, slot, paged):
    """The batch-1 view of ``slot`` that the per-slot path ran its chunk
    on: K/V rows (or, paged, the whole shared pools) and a (1,) index."""
    def view(kind, key, t):
        if paged and kind == "attn" and key != "index":
            return t
        return t[slot:slot + 1]
    return [{name: {kind: {key: view(kind, key, t) for key, t in c.items()}
                    for kind, c in blk.items()}
             for name, blk in sup.items()} for sup in caches]


class _PerSlotEngine(ContinuousBatchingEngine):
    """The prefill chunk as the engine ran it before its steps were static:
    the slot read back as a Python int, the chunk run on the slot's view,
    unembedded at the Python-int row n - 1, its bank row sliced, and the
    view's index written back into the slot."""

    def _prefill_step(self, draw):
        buf = self._prefill_in.dev
        slot, n = int(buf[0]), int(buf[1])
        kw = {}
        if self.paged:
            kw["page_table"] = self._table.dev[slot:slot + 1]
        view = _slot_view(self.caches, slot, self.paged)
        row = S.bank_take(self.bank, slice(slot, slot + 1))

        def epi(logits, new_caches):
            return S.sample_tokens(logits[:, -1], row,
                                   T.cache_index(new_caches),
                                   any_sampled=draw)

        out, view = self._lm(buf[2:].view(1, -1), view,
                             prefill_append=buf[1:2], logits_index=n - 1,
                             logits_epilogue=epi, **kw)
        for sup, one in zip(self.caches, view):
            for name, blk in sup.items():
                new = one[name]["attn"]["index"]
                blk["attn"]["index"][slot:slot + 1] = new
        return out


@pytest.mark.parametrize("paged,kv", CASES)
def test_static_steps_equal_the_per_slot_path(model, paged, kv):
    cfg, params = model
    scfg = _scfg(paged, kv)
    engines = [cls(cfg, scfg, params, device="cpu")
               for cls in (ContinuousBatchingEngine, _PerSlotEngine)]
    for eng in engines:
        _submit(eng, cfg.vocab_size, draw=True, seed=1)
    iters = 0
    while engines[0].scheduler.has_work():
        for eng in engines:
            eng.step()
        iters += 1
        static, per_slot = (_fixed(e) for e in engines)
        for a, b in zip(static, per_slot):
            assert torch.equal(a, b), iters
    assert not engines[1].scheduler.has_work()
    assert engines[0].results == engines[1].results
    assert iters > len(LENS)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_slot_operand_equals_the_slot_view(kv):
    r = np.random.default_rng(5)
    B, L, c, H, hkv, dk = 3, 64, 16, 4, 2, 32
    q = torch.tensor(r.standard_normal((1, c, H, dk)) * dk ** -0.5,
                     dtype=torch.float32)
    k = torch.tensor(r.standard_normal((B, L, hkv, dk)), dtype=torch.float32)
    v = torch.tensor(r.standard_normal((B, L, hkv, dk)), dtype=torch.float32)
    scales = {}
    if kv == "int8":
        k, ks = CL.quantize_kv(k, torch.int8)
        v, vs = CL.quantize_kv(v, torch.int8)
        scales = dict(k_scale=ks, v_scale=vs)
    beta = torch.tensor(r.uniform(0.5, 2.5, H), dtype=torch.float32)
    gamma = torch.full((H,), 100.0)
    index = torch.tensor([37], dtype=torch.int32)
    lengths = torch.tensor([11], dtype=torch.int32)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    norm = ConSmaxParams(H, ConSmaxConfig(), device="cpu")
    with torch.no_grad():
        norm.beta.copy_(beta)
        norm.gamma.copy_(gamma)
    for s in range(B):
        slot = torch.tensor([s], dtype=torch.int32)
        view = {n: t[s:s + 1] for n, t in scales.items()}
        got = consmax_prefill_ref(q, k, v, index, lengths, beta, gamma,
                                  slot=slot, **kw, **scales)
        one = consmax_prefill_ref(q, k[s:s + 1], v[s:s + 1], index, lengths,
                                  beta, gamma, **kw, **view)
        assert torch.equal(got, one), s
        assert torch.equal(
            consmax_prefill_op(q, k, v, index, lengths, beta, gamma,
                               slot=slot, **kw, **scales),
            consmax_prefill_op(q, k[s:s + 1], v[s:s + 1], index, lengths,
                               beta, gamma, **kw, **view)), s
        jv = {n: t.numpy() for n, t in view.items()}
        ref = jref(q.numpy(), k[s:s + 1].numpy(), v[s:s + 1].numpy(),
                   index.numpy(), lengths.numpy(), beta.numpy(),
                   gamma.numpy(), **kw, **jv)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        # the plain append walk reads the slot block by block alike
        walk = TA.append_attention(
            q, k, v, index, lengths, norm_kind="consmax", norm_params=norm,
            kv_chunk=16, slot=slot, **scales)
        assert torch.equal(walk, TA.append_attention(
            q, k[s:s + 1], v[s:s + 1], index, lengths, norm_kind="consmax",
            norm_params=norm, kv_chunk=16, **view)), s


def test_kernel_wrappers_count_only_their_kernels_launches():
    """Each kernel counts its own launches on the card (``_build.counted``),
    so a graph's replays count and nothing else does: on the CPU the seven
    wrappers run their plain versions and count nothing, keep their
    signatures, and their counts reset only to 0."""
    import inspect

    from repro_torch.kernels import _build
    from repro_torch.kernels.consmax_attn.ops import consmax_attention_op
    from repro_torch.kernels.consmax_decode.ops import (
        consmax_decode_op, consmax_decode_paged_op)
    from repro_torch.kernels.consmax_lut.ops import consmax_lut_op
    from repro_torch.kernels.consmax_prefill.ops import (
        consmax_prefill_paged_op)
    from repro_torch.kernels.softmax_attn.ops import softmax_attention_op

    ops = (consmax_decode_op, consmax_decode_paged_op, consmax_prefill_op,
           consmax_prefill_paged_op, consmax_attention_op,
           softmax_attention_op, consmax_lut_op)
    assert len({op.kernel for op in ops}) == len(ops)
    for op in ops:
        assert isinstance(op, _build.CountedOp)
        assert "q" in inspect.signature(op).parameters or (
            op is consmax_lut_op)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 32, generator=g)
    k = torch.randn(1, 16, 2, 32, generator=g)
    v = torch.randn(1, 16, 2, 32, generator=g)
    beta, gamma = torch.zeros(2), torch.full((2,), 4.0)
    index = torch.tensor([3], dtype=torch.int32)
    lengths = torch.tensor([4], dtype=torch.int32)
    consmax_prefill_op(q, k, v, index, lengths, beta, gamma)
    consmax_attention_op(q, k, v, beta, gamma)
    for op in ops:
        assert op.launches == 0
        op.launches = 0
        with pytest.raises(ValueError):
            op.launches = 1
