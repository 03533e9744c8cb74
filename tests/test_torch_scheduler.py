"""The port's copy of the scheduler (``repro_torch.serve.scheduler``)
against the reference's (``repro.serve.scheduler``), in lockstep, and the
admission fault the port's copy fixes.

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

The port's ``PagePool.reserve_prefix`` differs from the reference's on
purpose: its gate does not count the request's own refcount-0 prefix hits
as free supply (attaching them pins them). The lockstep walks therefore
drive the port's copy against ``_FixedPagePool``, the reference's class
with the same fix in ``reserve_prefix`` and nothing else changed, so every
other op stays compared with the reference's own code. With the fix, no
walk may fault; ``test_reserve_prefix_admission_fault_is_fixed`` is the
fault's repro, and the reference's copy still has it.
"""
import numpy as np
import pytest

from repro.serve import scheduler as JS
from repro_torch.serve import scheduler as TS


class _FixedPagePool(JS.PagePool):
    """The reference's ``PagePool`` with the port's ``reserve_prefix`` gate:
    each shard's supply excludes the refcount-0 hits this reservation
    pins off the evictable list. The rest of the method is the
    reference's."""

    def reserve_prefix(self, slot, rows, tokens=None):
        if self._reserved[slot]:
            raise ValueError(f"slot {slot} already holds a reservation")
        need = self.pages_for(rows)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot}: {rows} rows need {need} pages > "
                f"max_pages_per_slot ({self.max_pages_per_slot})")
        hits, cow_budget = [], 0
        if self.prefix_cache and tokens is not None and len(tokens) > 0:
            hits = self._match_prefix(tokens)[:need]
            if hits and len(hits) * self.page_size >= len(tokens):
                cow_budget = 1
        demand = [0] * self.seq_shards
        for j in range(len(hits), need):
            demand[self.position_shard(j)] += 1
        if cow_budget:
            demand[self.position_shard(len(hits) - 1)] += cow_budget
        pinned = [0] * self.seq_shards                  # the fix
        for page in hits:
            if self.refcount[page] == 0:
                pinned[self.page_shard(page)] += 1
        for d in range(self.seq_shards):
            if demand[d] > (self.free_pages_by_shard(d) - pinned[d]
                            - self.outstanding_by_shard(d)):
                return None
        for i, page in enumerate(hits):
            if self.refcount[page] == 0:
                del self._evictable[page]
            self.refcount[page] += 1
            self.table[slot, i] = page
        self._held[slot] = len(hits)
        self._reserved[slot] = need
        self._outstanding[slot] = demand
        if hits:
            self.version += 1
            self.prefix_hit_rows += len(hits) * self.page_size
        self.peak_reserved = max(self.peak_reserved, self.reserved_pages)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        skip = len(hits) * self.page_size
        if tokens is not None and skip:
            skip = min(skip, len(tokens) - 1)
        return skip


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
    pools = [cls(num_pages, page_size, max_slots, mpps,
                 prefix_cache=prefix_cache, evict=evict,
                 seq_shards=seq_shards)
             for cls in (_FixedPagePool, TS.PagePool)]
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
    assert not _FAULTS          # the fixed gate admits nothing it can't back


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
    for m, cls in ((JS, _FixedPagePool), (TS, TS.PagePool)):
        pool = (cls(24, 4, max_slots, max_seq // 4, evict=paged)
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


def _fault_repro(module, pool_cls, evict):
    """``PagePool(3, 2, 2, 3)``: slot 0 serves [1, 2, 3, 4] plus 2 rows and
    releases (2 cached pages, 1 free), slot 1 takes the free page, then a
    request with the cached prefix [1, 2, 3, 4] + [5] (6 rows: 3 pages, 2
    of them hits) arrives. Its hits are the only allocatable pages, and
    attaching them pins them: no page is left for its third."""
    pool = pool_cls(3, 2, 2, 3, prefix_cache=True, evict=evict)
    sched = module.Scheduler(2, 8, page_pool=pool)
    uid = sched.submit([1, 2, 3, 4], 2)
    slot, _ = sched.admit()
    pool.ensure_writable(slot, 0, 6)
    pool.commit_prefix(slot, [1, 2, 3, 4], 4)
    assert sched.finish(slot)[0] == uid
    assert pool.cached_pages == 2 and pool.free_pages == 3
    assert pool.reserve(1, 2)
    pool.ensure(1, 2)
    sched.slots[1] = "busy"                 # slot 1 holds its page
    sched.submit([1, 2, 3, 4, 5], 1)
    admitted = sched.admit()
    if admitted is not None:                # admitted: it must be servable
        slot, req = admitted
        state = sched.slots[slot]
        pool.ensure_writable(slot, state.filled, 6)
    return admitted, pool


@pytest.mark.parametrize("evict", ["lru", "fifo"])
def test_reserve_prefix_admission_fault_is_fixed(evict):
    """The port's copy keeps the request queued until its pages exist; the
    reference's copy admits it and then ``_alloc`` fails (IndexError under
    lru, ValueError from ``min`` under fifo)."""
    admitted, pool = _fault_repro(TS, TS.PagePool, evict)
    assert admitted is None and pool.cached_pages == 2
    pool.release(1)                         # the page comes back: it admits
    with pytest.raises((IndexError, ValueError)):
        _fault_repro(JS, JS.PagePool, evict)
    admitted, _ = _fault_repro(JS, _FixedPagePool, evict)
    assert admitted is None


@pytest.mark.parametrize("evict", ["lru", "fifo"])
@pytest.mark.parametrize("seed", range(3))
def test_shared_prefix_walks_under_pool_pressure(seed, evict):
    """``seq_shards=1`` walks of many requests sharing prefixes through a
    pool far smaller than their reservations: the port's copy and the
    fixed reference stay in lockstep, every request is served, and no op
    faults."""
    r = np.random.default_rng(100 + seed)
    ps, num_pages, max_slots = 2, 6, 4
    scheds = [m.Scheduler(max_slots, 12, page_pool=cls(
        num_pages, ps, max_slots, 6, prefix_cache=True, evict=evict))
        for m, cls in ((JS, _FixedPagePool), (TS, TS.PagePool))]
    stem = r.integers(0, 9, 8).tolist()
    for _ in range(14):
        prompt = stem[:int(r.integers(1, 9))] + r.integers(
            0, 9, int(r.integers(0, 3))).tolist()
        new = int(r.integers(1, 3))
        for s in scheds:
            s.submit(prompt[:10], new)
    pools = [s.page_pool for s in scheds]
    _FAULTS.clear()
    for _ in range(300):
        if not scheds[0].has_work():
            break
        admitted = [[], []]
        for s, out in zip(scheds, admitted):
            while (a := s.admit()) is not None:
                out.append((a[0], a[1].uid))
        assert admitted[0] == admitted[1]
        for slot, start, n in scheds[0].prefill_plan(4, 8):
            _both(pools, "ensure_writable", slot, start, start + n)
            done = [s.record_prefill(slot, n) for s in scheds]
            _both(pools, "commit_prefix", slot,
                  scheds[0].slots[slot].request.prompt,
                  scheds[0].slots[slot].filled)
            if done[0]:
                fin = [s.record(slot, 1) for s in scheds]
                if fin[0]:
                    assert scheds[0].finish(slot) == scheds[1].finish(slot)
        for slot, st in scheds[0].decoding():
            rows = st.filled + len(st.generated)
            _both(pools, "ensure_writable", slot, rows - 1, rows)
            fin = [s.record(slot, 1) for s in scheds]
            if fin[0]:
                assert scheds[0].finish(slot) == scheds[1].finish(slot)
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        assert not _FAULTS, _FAULTS
    assert not scheds[0].has_work() and not scheds[1].has_work()
    assert pools[1].free_pages == num_pages and pools[1].prefix_hit_rows > 0
