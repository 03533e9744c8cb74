"""The traffic generator repeats by seed and keeps its lengths fixed."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import loadgen

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob(
    "*.json"))


def _mix(path):
    return json.loads(path.read_text())


def _take(mix, seed, n, vocab=1000):
    t = loadgen.Traffic(mix, vocab, seed)
    return [t.take() for _ in range(n)]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = _mix(path)
    a, b = _take(mix, 2**31 + 11, 40), _take(mix, 2**31 + 11, 40)
    assert [(r.prompt, r.max_new_tokens) for r in a] == [
        (r.prompt, r.max_new_tokens) for r in b]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seeds_share_lengths_not_order(path):
    """Every seed serves the same prompt and output lengths in every block,
    in another order."""
    mix = _mix(path)
    n, c = mix["block"], mix["clients"]
    runs = [_take(mix, s, 3 * n, vocab=50) for s in (1, 2**31 + 5)]
    for k in range(3):
        want_p, want_o = loadgen.block_lengths(mix, k)
        for reqs in runs:
            blk = reqs[k * n:(k + 1) * n]
            assert sorted(len(r.prompt) - r.steady_offset
                          for r in blk) == sorted(want_p)
            assert sorted(r.max_new_tokens + r.steady_offset
                          for r in blk) == sorted(want_o)
    assert [len(r.prompt) for r in runs[0][c:]] != [
        len(r.prompt) for r in runs[1][c:]]
    assert runs[0][c].prompt != runs[1][c].prompt


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_within_the_mix(path):
    mix = _mix(path)
    p, o = mix["prompt"], mix["output"]
    for r in _take(mix, 7, 3 * mix["clients"], vocab=64):
        base = len(r.prompt) - r.steady_offset
        assert p["min"] <= base <= p["max"]
        assert 1 <= r.max_new_tokens
        assert o["min"] <= r.max_new_tokens + r.steady_offset <= o["max"]
        assert all(0 <= x < 64 for x in r.prompt)


def test_steady_start_spreads_the_first_requests():
    """Only the first request of each client is under way, with offsets
    spread below its output length."""
    mix = _mix(MIXES[0])
    reqs = _take(mix, 3, 2 * mix["clients"], vocab=10)
    c = mix["clients"]
    offs = [r.steady_offset for r in reqs[:c]]
    assert all(r.steady_offset == 0 for r in reqs[c:])
    fracs = sorted(r.steady_offset / (r.steady_offset + r.max_new_tokens)
                   for r in reqs[:c])
    assert fracs[0] < 0.1 and fracs[-1] > 0.85 and len(set(offs)) > c // 2


def test_quantiles_of_a_lognormal_hold_the_median():
    q = loadgen.quantile(dict(dist="lognormal", median=3000, sigma=0.5,
                              min=1024, max=7168), (np.arange(1001) + 0.5)
                         / 1001)
    assert q[500] == 3000 and q.min() >= 1024 and q.max() <= 7168
    assert list(q) == sorted(q)


def test_blocks_cover_every_stratum():
    mix = _mix(MIXES[0])
    n = mix["block"]
    for k in range(4):
        p, o = loadgen.block_lengths(mix, k)
        assert len(p) == len(o) == n
        assert list(p) == sorted(p) and list(o) == sorted(o)
    assert list(loadgen.block_lengths(mix, 0)[0]) != list(
        loadgen.block_lengths(mix, 1)[0])
