"""The port's copy of the scheduler (``repro_torch.serve.scheduler``)
against the reference's (``repro.serve.scheduler``), in lockstep.

The port keeps its own copy of the numpy-only scheduler so that it imports
nothing of the reference. These tests drive both copies with the same
seeded operation sequences and hold every return value and the whole
allocator state (page table, refcounts, free and evictable lists,
reservations, prefix index, counters, version) equal after every step:

* ``PagePool`` alone, over reserve/prefix-admit, extend (``ensure_writable``
  + ``commit_prefix``, copy-on-write), fork and release, with the prefix
  cache on and off, lru and fifo eviction, and 1 or 2 sequence shards;
* ``Scheduler`` with and without a page pool, over submit, admit (warm
  admissions from the prefix cache), ``prefill_plan``/``record_prefill``,
  ``record`` and ``finish``.
"""
import numpy as np
import pytest

from repro.serve import scheduler as JS
from repro_torch.serve import scheduler as TS


def _pool_state(pool):
    return (pool.table.tolist(), list(pool.refcount),
            [list(f) for f in pool._free_by], list(pool._evictable.items()),
            dict(pool._index), list(pool._page_key), list(pool._seq),
            list(pool._held), list(pool._reserved),
            [list(o) for o in pool._outstanding], list(pool._scale_live),
            pool.version, pool.peak_in_use, pool.peak_reserved,
            pool.cow_copies, pool.evictions, pool.scale_copies,
            pool.prefix_hit_rows, pool.free_pages, pool.outstanding_pages)


def _both(pools, method, *args):
    """Call ``method`` on both copies; equal results or equal exceptions.
    A ValueError is the allocator refusing an op ("raised"); any other
    exception ("broken") is a fault of the copied logic, which the two
    copies must share as well."""
    outs = []
    for pool in pools:
        try:
            outs.append(("ok", getattr(pool, method)(*args)))
        except ValueError as e:
            outs.append(("raised", str(e)))
        except Exception as e:                      # noqa: BLE001
            outs.append(("broken", f"{type(e).__name__}: {e}"))
    assert outs[0] == outs[1], (method, args, outs)
    if outs[0][0] == "broken":
        _FAULTS.append((method, args, outs[0][1]))
    return outs[0]


_FAULTS: list = []      # faulted ops of the current walk


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("prefix_cache,evict,seq_shards",
                         [(True, "lru", 1), (True, "fifo", 1),
                          (False, "lru", 1), (True, "lru", 2)])
def test_page_pool_copy_matches_reference(seed, prefix_cache, evict,
                                          seq_shards):
    r = np.random.default_rng(seed)
    page_size = int(r.choice([1, 2, 4]))
    num_pages = 2 * int(r.integers(2, 7))   # small: forces evictions
    max_slots = int(r.integers(2, 6))
    mpps = int(r.integers(2, num_pages + 1))
    pools = [m.PagePool(num_pages, page_size, max_slots, mpps,
                        prefix_cache=prefix_cache, evict=evict,
                        seq_shards=seq_shards) for m in (JS, TS)]
    stream = r.integers(0, 50, 4 * mpps * page_size).tolist()
    fill, prompt = [0] * max_slots, [None] * max_slots
    _FAULTS.clear()
    for _ in range(200):
        op, slot = int(r.integers(0, 4)), int(r.integers(0, max_slots))
        rows = int(r.integers(1, mpps * page_size + 1))
        if op == 0 and not pools[0]._reserved[slot]:
            plen = max(1, rows - int(r.integers(0, rows // 2 + 1)))
            tokens = stream[:plen]         # prompts share one prefix
            kind, skip = _both(pools, "reserve_prefix", slot, rows, tokens)
            if kind == "ok" and skip is not None:
                fill[slot], prompt[slot] = skip, tokens
        elif op == 1 and pools[0]._reserved[slot]:
            stop = min(fill[slot] + int(r.integers(1, 2 * page_size + 1)),
                       pools[0]._reserved[slot] * page_size)
            if stop > fill[slot]:
                _both(pools, "ensure_writable", slot, fill[slot], stop)
                _both(pools, "commit_prefix", slot, prompt[slot],
                      min(stop, len(prompt[slot])))
                fill[slot] = stop
        elif op == 2 and pools[0]._held[slot]:
            dst = int(r.integers(0, max_slots))
            if dst != slot and not pools[0]._reserved[dst]:
                kind, copies = _both(pools, "fork", slot, dst, rows,
                                     fill[slot])
                if kind == "ok" and copies is not None:
                    fill[dst], prompt[dst] = fill[slot], prompt[slot]
        elif op == 3:
            _both(pools, "release", slot)
            fill[slot], prompt[slot] = 0, None
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        if _FAULTS:             # the walk cannot go on from a faulted op
            break


def _sched_state(s):
    slots = [None if st is None else
             (st.request.uid, st.request.prompt, st.generated, st.filled,
              st.phase, st.prefix_cached) for st in s.slots]
    return slots, [(q.uid, q.prompt, q.max_new_tokens) for q in s.queue]


@pytest.mark.parametrize("paged", [None, "lru", "fifo"])
def test_scheduler_copy_matches_reference(paged):
    """``paged``: no page pool, or one with that eviction order."""
    r = np.random.default_rng(7)
    max_slots, max_seq, chunk, budget = 3, 40, 8, 12
    scheds = []
    for m in (JS, TS):
        pool = (m.PagePool(24, 4, max_slots, max_seq // 4, evict=paged)
                if paged else None)
        scheds.append(m.Scheduler(max_slots, max_seq, page_pool=pool))
    stream = r.integers(0, 50, max_seq).tolist()
    for i in range(16):                    # more requests than slots
        plen = int(r.integers(1, 30))
        prompt = stream[:plen] if i % 2 else r.integers(0, 50, plen).tolist()
        budget_i = int(r.integers(1, 9))
        uids = [s.submit(prompt, budget_i, eos_id=3) for s in scheds]
        assert uids[0] == uids[1]
    for _ in range(200):
        if not scheds[0].has_work():
            break
        admitted = [[], []]
        for s, out in zip(scheds, admitted):
            while (a := s.admit()) is not None:
                out.append((a[0], a[1].uid))
        assert admitted[0] == admitted[1]
        plans = [s.prefill_plan(chunk, budget) for s in scheds]
        assert plans[0] == plans[1]
        for slot, start, n in plans[0]:
            if paged:                      # as the paged engine does
                _both([s.page_pool for s in scheds], "ensure_writable",
                      slot, start, start + n)
                _both([s.page_pool for s in scheds], "commit_prefix", slot,
                      scheds[0].slots[slot].request.prompt, start + n)
            done = [s.record_prefill(slot, n) for s in scheds]
            assert done[0] == done[1]
            if done[0]:
                tok = int(r.integers(0, 50))
                fin = [s.record(slot, tok) for s in scheds]
                assert fin[0] == fin[1]
                if fin[0]:
                    assert scheds[0].finish(slot) == scheds[1].finish(slot)
        for slot, _ in scheds[0].decoding():
            tok = int(r.integers(0, 50))
            fin = [s.record(slot, tok) for s in scheds]
            assert fin[0] == fin[1]
            if fin[0]:
                assert scheds[0].finish(slot) == scheds[1].finish(slot)
        assert _sched_state(scheds[0]) == _sched_state(scheds[1])
        if paged:
            assert (_pool_state(scheds[0].page_pool)
                    == _pool_state(scheds[1].page_pool))
    assert not scheds[0].has_work() and not scheds[1].has_work()
