"""The roofline and mfu reckoning against hand-worked small cases."""
import pytest

from perfbench import harness as H
from perfbench import roofline as RL


def test_bound_takes_the_larger_side():
    assert RL.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert RL.bound_s(0, 989e12) == (1.0, "operations")
    assert RL.bound_s(3.35e12, 2 * 989e12) == (2.0, "operations")


def test_pairs_by_hand():
    assert RL.chunk_pairs(0, 4) == 1 + 2 + 3 + 4
    assert RL.chunk_pairs(3, 2) == 4 + 5          # keys 0..3, then 0..4
    assert RL.visible_pairs(4, 4, causal=True) == 10
    assert RL.visible_pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2
    assert RL.visible_pairs(3, 5, causal=False) == 15


def test_prefill_chunk_bound_by_hand():
    # qwen2-1.5b's heads, a first chunk of 512: bytes-bound
    flops = 4 * 128 * 12 * (512 * 513 // 2)
    nbytes = 2 * 2 * 512 * 12 * 128 + 2 * 512 * 2 * 128 * 2
    assert RL.prefill_chunk_bound_s(0, 512, 12, 2, 128) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert nbytes / 3.35e12 > flops / 989e12
    # deep into the cache the operations bound it
    t = RL.prefill_chunk_bound_s(6000, 512, 12, 2, 128)
    assert t == pytest.approx(4 * 128 * 12 * RL.chunk_pairs(6000, 512)
                              / 989e12)


def test_decode_row_bound_by_hand():
    nbytes = 2 * 1000 * 2 * 128 * 2 + 2 * 2 * 12 * 128
    assert RL.decode_row_bound_s(1000, 12, 2, 128) == pytest.approx(
        nbytes / 3.35e12)
    # an fp8 / int8 cache moves half the K/V bytes
    assert RL.decode_row_bound_s(1000, 12, 2, 128, 1) == pytest.approx(
        (nbytes - 2 * 1000 * 2 * 128) / 3.35e12)


def test_model_flops_by_hand():
    assert RL.dense_params(4, 2, 1, 2, 3, qkv_bias=True) == (
        4 * 2 * 2 * 2 + 4 * 1 * 2 * 2 + (2 + 2) * 2 + 3 * 4 * 3)
    dims = dict(layers=2, d=4, H=2, hkv=1, dk=2, ff=3, vocab=10,
                qkv_bias=True)
    work = dict(tokens=5, pairs=7, sampled=2)
    assert RL.model_flops(dims, work) == (2 * 2 * 92 * 5 + 4 * 2 * 2 * 2 * 7
                                          + 2 * 4 * 10 * 2)


def test_busy_union_and_gaps():
    iv = [(1, 3), (0, 2), (5, 6)]
    assert RL.busy_union(iv) == 4
    assert RL.idle_gaps(iv, 0, 7) == [(3, 5), (6, 7)]
    assert RL.idle_gaps(iv, -1, 2) == [(-1, 0)]
    assert RL.idle_gaps([], 0, 1) == [(0, 1)]


def test_work_of_chunks_and_decode_rows():
    w = H.Work(chunks=[(0, 4), (3, 2)], decode_keys=[10, 11])
    assert w.model_work() == dict(tokens=8, pairs=10 + 9 + 21, sampled=4)


def _ctx(**slice_kw):
    dims = dict(layers=2, d=4, H=2, hkv=1, dk=2, ff=3, vocab=10,
                qkv_bias=True)
    sl = dict(seconds=2.0, busy_s=1.5, work=H.Work(
        chunks=[(0, 4)], decode_keys=[10]),
        kernel_s={"void attn_walk_kernel<96, 1>(WalkArgs)": 1e-9,
                  "void decode_partials<96>(DecodeArgs)": 2e-9,
                  "ampere_bf16_gemm": 1.0})
    sl.update(slice_kw)
    return dict(dims=dims, kv_bytes=2, slice=sl,
                window=dict(seconds=30.0, iterations=10, tokens=25,
                            first_tokens=5, decode_rows=20,
                            graph_replays=20),
                memory=dict(max_allocated=3 * 2**30))


def test_readers_by_hand():
    ctx = _ctx()
    assert H.reader("engine.decode_rows_per_iter")(ctx) == 2.0
    assert H.reader("engine.graph_replays_per_iter")(ctx) == 2.0
    assert H.reader("device.idle_share")(ctx) == pytest.approx(25.0)
    assert H.reader("device.peak_mem_gib")(ctx) == 3.0
    flops = RL.model_flops(ctx["dims"], dict(tokens=5, pairs=20,
                                             sampled=2))
    assert H.reader("model_step.mfu")(ctx) == pytest.approx(
        100 * flops / (2.0 * 989e12))
    least = 2 * RL.prefill_chunk_bound_s(0, 4, 2, 1, 2)
    assert H.reader("consmax_prefill_roofline")(ctx) == pytest.approx(
        100 * least / 1e-9)
    least = 2 * RL.decode_row_bound_s(10, 2, 1, 2)
    assert H.reader("consmax_decode_roofline")(ctx) == pytest.approx(
        100 * least / 2e-9)


def test_readers_return_nothing_without_something_to_read():
    empty = _ctx(work=H.Work(), kernel_s={})
    for name in ("model_step.mfu", "consmax_prefill_roofline",
                 "consmax_decode_roofline"):
        assert H.reader(name)(empty) is None
        assert H.reader(name)(dict(_ctx(), slice=None)) is None
    no_kernel = _ctx(kernel_s={"ampere_bf16_gemm": 1.0})
    assert H.reader("consmax_prefill_roofline")(no_kernel) is None
    assert H.reader("consmax_decode_roofline")(no_kernel) is None
    ctx = _ctx()
    ctx["window"]["graph_replays"] = 0
    assert H.reader("engine.graph_replays_per_iter")(ctx) is None


class _Slot:
    def __init__(self, uid, prompt):
        self.request = type("R", (), {"uid": uid})()
        self.filled, self.generated = 0, []
        self.n_prompt = prompt


class _Engine:
    """Two requests, prompt 6, served by chunks of 4 and one decode row per
    step: the bookkeeping the closed loop does between steps."""

    def __init__(self):
        self.scheduler = type("S", (), {})()
        self.scheduler.slots = []
        self.results = {}
        self.uids = 0

    def submit(self, prompt, max_new):
        s = _Slot(self.uids, len(prompt))
        s.max_new = max_new
        self.uids += 1
        self.scheduler.slots.append(s)
        return s.request.uid

    def step(self):
        for s in list(self.scheduler.slots):
            if s.filled < s.n_prompt:
                s.filled = min(s.n_prompt, s.filled + 4)
                if s.filled == s.n_prompt:
                    s.generated.append(1)
            if s.filled == s.n_prompt and len(s.generated) < s.max_new:
                s.generated.append(2)
            if len(s.generated) >= s.max_new:
                self.scheduler.slots.remove(s)
                self.results[s.request.uid] = s.generated


def test_closed_loop_bookkeeping():
    from perfbench import loadgen
    mix = dict(name="t", loop="closed", sampling="greedy", clients=1,
               start="none", block=1,
               prompt=dict(dist="uniform", min=6, max=6),
               output=dict(dist="uniform", min=4, max=4))
    eng = _Engine()
    clock = iter(range(100)).__next__
    loop = H.ClosedLoop(eng, loadgen.Traffic(mix, 10, 0), clock)
    loop.in_window = True
    loop.slice = H.detailed()
    for _ in range(4):
        loop.send()                                 # t = 0, then 3
        eng.step()
        loop.observe(clock())
    # request 0: sent at 0; step 1 chunk (0, 4); step 2 chunk (4, 2) + the
    # first token + one decode row; steps 3, 4 a decode row each: done at 4
    assert loop.ttft == [2 - 0]
    assert loop.itl == [0.0, 3 - 2, 4 - 3]
    w = loop.slice
    assert (w.steps, w.tokens, w.first_tokens, w.decode_rows) == (4, 4, 1, 3)
    assert w.chunks == [(0, 4), (4, 2)]
    assert w.decode_keys == [7, 8, 9]              # prompt 6, tokens 2..4
    assert [len(f.tokens) for f in loop.finished] == [4]
    assert loop.attempted == 1 and loop.free == [0]
