"""The trace reading on a small profiled run on the CPU, and the numbers
the output check takes from the gaps."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness as H


def _profiled():
    """A profile holding a ``perfbench.slice`` range: a short step, then an
    observe range that sleeps for most of the slice."""
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.slice"):
            with record_function("perfbench.step"):
                (x @ x).sum()
            with record_function("perfbench.observe"):
                time.sleep(0.05)
    return prof


def test_trace_events_split_host_and_device():
    dev, host = H._trace_events(_profiled())
    assert dev == []                                # no device here
    names = {n for _, _, n in host}
    assert {"perfbench.slice", "perfbench.step",
            "perfbench.observe"} <= names
    assert any(n.startswith("aten::") for n in names)
    assert all(0 <= e - s < 10 for s, e, _ in host)  # seconds, not ns


def test_read_slice_of_a_profiled_run():
    sl = H.read_slice(_profiled(), "perfbench.slice")
    assert 0.05 <= sl["seconds"] < 5
    assert sl["busy_s"] == 0 and sl["kernel_s"] == {}
    # one idle gap, the whole slice; its middle lies in the sleep
    assert list(sl["idle_by_host"]) == ["perfbench.observe"]
    assert sl["idle_by_host"]["perfbench.observe"] == pytest.approx(
        sl["seconds"])
    b = H.breakdown(sl)
    assert b["device_ops"] == [] and b["idle_gaps"][0][0] == (
        "perfbench.observe")


def test_read_slice_needs_its_marker():
    with pytest.raises(RuntimeError, match="perfbench.window"):
        H.read_slice(_profiled(), "perfbench.window")


def test_gap_numbers_by_hand():
    g = np.array([0.0, 0.0, 0.3, 0.0, 0.1])
    got = {k: f(g) for k, f in H.GAP_STATS.items()}
    assert got == pytest.approx(dict(max_logit_gap=0.3, mean_logit_gap=0.08))


class _Req:
    def __init__(self, index, n_prompt, max_new):
        self.index, self.prompt = index, list(range(n_prompt))
        self.max_new_tokens = max_new


def _finished(lengths):
    return [H.Flight(0, _Req(i, 4, n), i, 0.0, tokens=[1] * n)
            for i, n in enumerate(lengths)]


def test_sample_takes_the_longest_then_enough_tokens_and_requests():
    fin = _finished([100] * 60 + [900])
    got = H.sample(fin, 2**31 + 9)
    assert got[0] is fin[-1]
    n = sum(len(f.tokens) for f in got)
    assert len(got) >= H.SAMPLE_REQUESTS and n >= H.SAMPLE_TOKENS
    assert n - len(got[-1].tokens) < H.SAMPLE_TOKENS        # no more
    assert [f.uid for f in got] == [f.uid for f in H.sample(fin, 2**31 + 9)]
    assert [f.uid for f in got] != [f.uid for f in H.sample(fin, 7)]
    long = _finished([5000] * 20)
    assert len(H.sample(long, 1)) == H.SAMPLE_REQUESTS
    assert len(H.sample(_finished([1] * 200), 1)) == H.SAMPLE_MAX_REQUESTS
    assert len(H.sample(_finished([3, 4]), 1)) == 2
    assert H.sample([], 1) == []


class _Ref:
    """A reference whose gaps are fixed."""

    @staticmethod
    def logit_gaps(cfg, seed, seqs, device, chooser=None):
        return [np.array([0.0, 0.2, 0.0, 0.0])[:len(t) - n] for t, n in seqs]


@pytest.mark.parametrize("limits, compared", [
    ({"max_logit_gap": {"limit": 0.1}}, ["max_logit_gap"]),
    ({"mean_logit_gap": {"limit": 0.1}, "max_logit_gap": {"limit": 0.3}},
     ["max_logit_gap", "mean_logit_gap"]),
])
def test_the_limits_file_names_what_is_compared(limits, compared,
                                                monkeypatch):
    monkeypatch.setattr(H.importlib, "import_module", lambda name: _Ref)
    loop = type("L", (), {"finished": _finished([4, 4, 3])})()
    loop.finished[2].req.max_new_tokens = 4         # one reply cut short
    cell = H.Cell("c", {"family": "dense"}, {}, [], [], limits)
    found, checks = H.check_outputs(cell, 1, loop, "cpu")
    assert list(checks) == compared + ["short_replies"]
    assert found["max_logit_gap"] == pytest.approx(0.2)
    assert found["mean_logit_gap"] == pytest.approx(0.6 / 11)
    assert found["not_reference_first"] == 3
    assert found["compared_tokens"] == 11 and found["compared_requests"] == 3
    for k in compared:
        assert checks[k] == {"value": found[k], "limit": limits[k]["limit"]}
    assert checks["short_replies"] == {"value": 1, "limit": 0}


def test_a_limit_for_an_unknown_number_is_refused(monkeypatch):
    monkeypatch.setattr(H.importlib, "import_module", lambda name: _Ref)
    loop = type("L", (), {"finished": _finished([4])})()
    cell = H.Cell("c", {"family": "dense"}, {}, [], [],
                  {"median_gap": {"limit": 1.0}})
    with pytest.raises(KeyError, match="median_gap"):
        H.check_outputs(cell, 1, loop, "cpu")


def test_an_unknown_control_is_refused():
    with pytest.raises(ValueError, match="control"):
        H.run(None, seed=1, seconds=1, trace=False, device="cpu",
              t_start=0.0, control="int4")
