"""Slot-based continuous-batching scheduler (host-side, framework-free).

The port's own copy of the reference's ``serve/scheduler.py`` (numpy and
the standard library only), kept line for line so both engines schedule
identically — with one deliberate difference: ``PagePool.reserve_prefix``
does not count the request's own refcount-0 prefix hits as free supply (see
its docstring). The port's engine uses ``Scheduler`` and, when paged,
``PagePool``.

The decode batch is a fixed pool of ``max_slots`` slots sharing one jitted
step; requests wait in a FIFO admission queue, occupy a slot for exactly
prefill + generated-token steps, and are recycled on EOS or token budget —
so heterogeneous requests never pad each other the way a static batch does.

Each occupied slot is a two-state machine:

* ``PREFILLING`` — the prompt enters the KV cache in fixed-size append
  chunks, at most one chunk per slot per engine iteration, with the total
  prefill tokens per iteration capped by a budget (``prefill_plan``). Long
  prompts therefore never stall the decode step for more than one chunk.
* ``DECODING``  — the slot advances one token per shared decode step.

The transition happens when ``record_prefill`` accounts the final prompt
token; the engine then samples the first output token from the last chunk's
logits and the slot joins the decode batch.

This module is pure Python bookkeeping: who sits where, what was generated,
which sampling params a request carries (opaquely — the engine mirrors them
into its device-resident bank at admission), when a slot frees up — plus,
for paged KV serving, ``PagePool``: the refcounted, prefix-caching int32
allocator that maps each slot's logical KV rows onto shared pool pages,
gates admission on worst-case reservations, and lets identical prompt
prefixes share physical pages copy-on-write. All device work (chunked
prefill, decode, cache updates, COW page copies) lives in
engine.ContinuousBatchingEngine, which drives this scheduler.
"""
from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np

PREFILLING = "prefilling"
DECODING = "decoding"

# Root of every prefix-hash chain. A page's key commits to every token
# before it (h_i = sha256(h_{i-1} || page i's token ids)), so two equal
# keys mean two equal *full prefixes* — a plain per-page token hash would
# alias "the quick" at positions 0..P with "the quick" at positions P..2P.
_CHAIN_ROOT = b"consmax-prefix-v1"


def _chain_key(prev: bytes, tokens) -> bytes:
    return hashlib.sha256(
        prev + np.asarray(tokens, np.int64).tobytes()).digest()


class PagePool:
    """Refcounted, prefix-caching page allocator for a shared KV pool.

    The device holds ONE ``(num_pages, page_size, hkv, dk)`` K/V buffer per
    layer; this class owns the host-side mapping from (slot, logical page
    index) to pool page ids. ``table`` is the dense ``(max_slots,
    max_pages_per_slot)`` int32 page table the jitted steps consume verbatim
    (-1 = unmapped). Because the jitted kernels only ever *indirect* through
    the table, several slots may map the same physical page — which is the
    whole trick.

    Page lifecycle::

        free ──alloc──▶ pinned (refcount ≥ 1) ──release──▶ free
                           │                        │
                           │ registered under a     ▼
                           │ prefix key          evictable (refcount 0,
                           ▼                     K/V intact, attachable)
                        shared by later              │ free list empty
                        slots via reserve_prefix ◀───┘ → evicted (key
                                                        dropped, reused)

    * ``reserve`` / ``reserve_prefix`` commit a slot's *worst-case* page
      count up front (prompt + token budget), so the pool can never
      deadlock with every slot mid-request and no page reclaimable. For a
      warm request only the pages NOT served from the prefix cache are
      counted against supply — the saved pages are exactly the capacity
      the cache buys.
    * ``ensure`` maps fresh pages on demand as a slot's fill level grows;
      ``ensure_writable`` additionally copy-on-writes any page in the
      write window whose refcount > 1.
    * ``commit_prefix`` registers a slot's fully prefilled prompt pages
      under their chain keys; ``release`` parks refcount-0 registered
      pages on the evictable list instead of the free list, and eviction
      (lru or fifo over release/registration order) happens only when the
      free list runs dry.

    Invariants (property-tested in tests/test_paged_kv.py):

    * ``refcount[p]`` equals the number of slot table rows mapping ``p``,
    * free, evictable and pinned pages partition the pool; no page is
      freed or evicted while its refcount > 0,
    * a slot never maps more pages than its reservation,
    * ``version`` strictly increases, at most once per mutating call.

    Sequence sharding (``seq_shards = ns > 1``): the device pool's page
    axis is split into ns contiguous per-device blocks — shard d owns
    physical pages [d * P/ns, (d+1) * P/ns) — and allocation is
    *position-rigid* with a BLOCK position map: slot page position j is
    always backed by a page from shard ``j // ceil(maxpps/ns)`` (maxpps
    = max_pages_per_slot). The block map, rather than an interleave, is
    what preserves the engine's token bit-identity guarantee: a request
    whose context fits one block (up to ``max_seq/ns`` rows) has ALL its
    pages on one shard, every other shard's ConSmax partial for it is
    exactly +0.0 (masked weights), and the cross-device psum returns the
    owner's fp32 bits unchanged — no reassociated additions. Only a
    request that outgrows a block (the long_500k single-slot shape this
    axis exists for) spreads onto further shards, spending bit-identity
    for capacity: its resident pages then exceed one device's memory by
    design, and its partial sums regroup per shard count (documented in
    README "Sharded serving").

    Position-rigidity still buys the other invariants: COW/fork
    replacement pages (same position) stay on the source page's shard
    (device page copies never cross shards), and prefix-cache hits
    (always positions 0..k) attach consistently for every sharer. All
    capacity accounting — admission gates, eviction, ``submit``'s
    unservable check — is per-shard: a request that fits globally but
    overflows one shard's slice must NOT admit (it could never map its
    position-j pages; under the block map the low shards are the
    contended ones, since every slot's first block lands on shard 0).
    ns=1 reduces bit-exactly to the unsharded allocator (same
    allocation order, same gates).
    """

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int, prefix_cache: bool = True,
                 evict: str = "lru", seq_shards: int = 1):
        if evict not in ("lru", "fifo"):
            raise ValueError(f"evict must be 'lru' or 'fifo', got {evict!r}")
        if seq_shards < 1 or num_pages % seq_shards:
            raise ValueError(
                f"seq_shards ({seq_shards}) must be >= 1 and divide "
                f"num_pages ({num_pages})")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.prefix_cache = prefix_cache
        self.evict = evict
        self.seq_shards = seq_shards
        self.pages_per_shard = num_pages // seq_shards
        # logical page positions [d*block, (d+1)*block) live on shard d
        self.position_block = -(-max_pages_per_slot // seq_shards)
        self.table = np.full((max_slots, max_pages_per_slot), -1, np.int32)
        # per-shard free lists, descending ids so pop() hands out each
        # shard's smallest id first (ns=1: identical order to the old
        # single list — 0, 1, 2, ...)
        ppd = self.pages_per_shard
        self._free_by: list[list[int]] = [
            list(range((d + 1) * ppd - 1, d * ppd - 1, -1))
            for d in range(seq_shards)]
        self.refcount = [0] * num_pages    # table rows mapping each page
        self._page_key: list[bytes | None] = [None] * num_pages
        self._index: dict[bytes, int] = {}     # chain key -> page id
        # refcount-0 registered pages, in release order (lru eviction pops
        # the front; fifo eviction uses _seq, the registration order)
        self._evictable: OrderedDict[int, bytes] = OrderedDict()
        self._seq = [0] * num_pages
        self._seqno = 0
        self._held = [0] * max_slots       # pages currently mapped per slot
        self._reserved = [0] * max_slots   # worst-case pages per slot
        # remaining *new-page* allocation rights per slot, PER SHARD:
        # decremented on every fresh alloc (including COW copies) against
        # the allocating position's shard. Admission gates on the per-shard
        # sums, not on _reserved — shared pages are free capacity, and a
        # request must fit every shard's slice, not just the global total.
        self._outstanding: list[list[int]] = [
            [0] * seq_shards for _ in range(max_slots)]
        self.peak_in_use = 0
        self.peak_reserved = 0
        self.cow_copies = 0                # pages privatized before a write
        self.evictions = 0                 # cached pages reclaimed for reuse
        # Quantized-KV bookkeeping. A quantized pool stores per-row fp32
        # scale leaves beside each K/V page (transformer.init_paged_caches);
        # scales live and die WITH their page, so the pool tracks one bit
        # per page: True while the page's scale rows are meaningful (mapped
        # by a slot, or parked evictable with K/V + scales intact), False
        # once the page returns to the free list. ``scale_copies`` counts
        # device page copies (COW / fork) — each moves data AND scale rows.
        self._scale_live = [False] * num_pages
        self.scale_copies = 0
        self.prefix_hit_rows = 0           # KV rows served from the cache
        self.version = 0                   # bumped on every table mutation —
                                           # lets the engine keep a device
                                           # copy and re-upload only on change

    # ------------------------------------------------------------ stats ----
    def page_shard(self, page: int) -> int:
        """Shard owning physical page ``page``."""
        return page // self.pages_per_shard

    def position_shard(self, pos: int) -> int:
        """Shard that must back slot page position ``pos`` (block map —
        see the class docstring's bit-identity rationale)."""
        return min(pos // self.position_block, self.seq_shards - 1)

    def free_pages_by_shard(self, d: int) -> int:
        """Pages shard ``d`` can allocate right now: its free list plus
        its evictable prefix-cache pages."""
        return len(self._free_by[d]) + sum(
            1 for p in self._evictable if self.page_shard(p) == d)

    def outstanding_by_shard(self, d: int) -> int:
        return sum(o[d] for o in self._outstanding)

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now: the free lists plus the evictable
        prefix-cache pages (refcount 0; reclaimed on demand)."""
        return sum(len(f) for f in self._free_by) + len(self._evictable)

    @property
    def cached_pages(self) -> int:
        """Evictable prefix-cache pages (refcount 0, K/V intact)."""
        return len(self._evictable)

    @property
    def live_scale_pages(self) -> int:
        """Pages whose quantization-scale rows are meaningful right now
        (pinned or evictable). Invariant: equals ``num_pages`` minus the
        free-lists' length — scales are allocated and recycled with their
        page, never separately."""
        return sum(self._scale_live)

    @property
    def in_use(self) -> int:
        """Pinned pages: mapped by at least one slot (refcount ≥ 1)."""
        return self.num_pages - self.free_pages

    @property
    def reserved_pages(self) -> int:
        """Worst-case pages committed across all live reservations —
        including reserved-but-unmapped pages, which ``in_use`` /
        ``occupancy()`` cannot see (a slot that reserved and never
        ``ensure``d holds zero pool pages yet still gates admission).
        With prefix sharing this can exceed ``num_pages`` — the excess is
        exactly the capacity shared pages are saving; admission gates on
        ``outstanding_pages`` (new pages only), not on this total."""
        return sum(self._reserved)

    @property
    def outstanding_pages(self) -> int:
        """New-page allocation rights still held by live reservations —
        the quantity admission actually gates on (per shard): pinned +
        outstanding can never exceed ``num_pages``."""
        return sum(sum(o) for o in self._outstanding)

    def occupancy(self) -> float:
        return self.in_use / self.num_pages

    def reserved_fraction(self) -> float:
        return self.reserved_pages / self.num_pages

    def pages_for(self, rows: int) -> int:
        return -(-rows // self.page_size)

    def owned(self, slot: int) -> list[int]:
        return [int(p) for p in self.table[slot, :self._held[slot]]]

    # ------------------------------------------------------- allocation ----
    def _alloc(self, slot: int, pos: int) -> int:
        """Take one page for ``slot``'s page position ``pos``: the owning
        shard's free list first, then evict one of that shard's refcount-0
        cached pages (per-shard admission accounting guarantees one exists
        whenever the shard's outstanding rights remain)."""
        d = self.position_shard(pos)
        if self._outstanding[slot][d] <= 0:
            raise ValueError(
                f"slot {slot}: allocation at position {pos} exceeds its "
                f"new-page budget on shard {d}")
        self._outstanding[slot][d] -= 1
        if self._free_by[d]:
            page = self._free_by[d].pop()
            self._scale_live[page] = True
            return page
        mine = [p for p in self._evictable if self.page_shard(p) == d]
        if self.evict == "fifo":
            page = min(mine, key=self._seq.__getitem__)
        else:                              # lru: least recently released
            page = mine[0]                 # OrderedDict preserves order
        self._evictable.pop(page)
        del self._index[self._page_key[page]]
        self._page_key[page] = None
        self.evictions += 1
        self._scale_live[page] = True      # stays live across the handoff
        return page

    def _match_prefix(self, tokens) -> list[int]:
        """Longest run of cached pages covering ``tokens``' full pages."""
        pages: list[int] = []
        key = _CHAIN_ROOT
        ps = self.page_size
        for i in range(len(tokens) // ps):
            key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
            page = self._index.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def reserve(self, slot: int, rows: int) -> bool:
        """Commit ``rows`` worst-case KV rows for ``slot``; False (and no
        state change) when the pool cannot guarantee them. Cold path: no
        prefix lookup — equivalent to ``reserve_prefix(slot, rows) is not
        None``."""
        return self.reserve_prefix(slot, rows) is not None

    def reserve_prefix(self, slot: int, rows: int,
                       tokens=None) -> int | None:
        """Commit ``rows`` worst-case KV rows for ``slot``, attaching any
        cached pages whose chain keys match ``tokens``' prompt prefix.

        Returns the number of logical rows the slot may skip prefilling
        (0 for a cold request), or None (no state change) when the pool
        cannot guarantee the *new* pages. The skip never reaches the last
        prompt token: the engine must re-score the final token to get the
        logits that seed sampling, so a fully cached, page-aligned prompt
        skips ``len(tokens) - 1`` rows and budgets ONE extra page for the
        copy-on-write that 1-token tail re-score will trigger (it writes
        into the shared last page).

        Differs from the reference's copy here: a hit with refcount 0 sits
        on the evictable list, which ``free_pages_by_shard`` counts as
        supply, and attaching it takes it off that list. The reference's
        gate counts those hits as supply for the request's own new pages,
        so it could admit a request whose next ``ensure`` found no page to
        allocate (``IndexError`` / ``ValueError`` from ``_alloc``: a warm
        admission under pool pressure, with one shard or several). Here
        each shard's supply excludes the hits this reservation pins."""
        if self._reserved[slot]:
            raise ValueError(f"slot {slot} already holds a reservation")
        need = self.pages_for(rows)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot}: {rows} rows need {need} pages > "
                f"max_pages_per_slot ({self.max_pages_per_slot})")
        hits: list[int] = []
        cow_budget = 0
        if self.prefix_cache and tokens is not None and len(tokens) > 0:
            hits = self._match_prefix(tokens)[:need]
            if hits and len(hits) * self.page_size >= len(tokens):
                cow_budget = 1             # tail re-score COWs the last page
        # Attaching a hit pins it but consumes no *new* page; each shard's
        # supply must cover this slot's new pages AT THAT SHARD'S POSITIONS
        # plus every other reservation's outstanding rights there (they may
        # all cash in before we release). Position-rigid: new page position
        # j draws from the block map's shard (``position_shard(j)`` — see
        # the class docstring); the tail COW replaces the last hit page in
        # place, so it draws from that position's shard.
        demand = [0] * self.seq_shards
        for j in range(len(hits), need):
            demand[self.position_shard(j)] += 1
        if cow_budget:
            demand[self.position_shard(len(hits) - 1)] += cow_budget
        # evictable hits this reservation pins stop being supply
        pinned = [0] * self.seq_shards
        for page in hits:
            if self.refcount[page] == 0:
                pinned[self.page_shard(page)] += 1
        for d in range(self.seq_shards):
            if demand[d] > self.free_pages_by_shard(d) - pinned[d] - \
                    self.outstanding_by_shard(d):
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

    def ensure(self, slot: int, rows: int) -> list[int]:
        """Map pages so logical rows [0, rows) of ``slot`` are backed;
        returns the newly allocated page ids (often empty)."""
        need = self.pages_for(rows)
        if need > self._reserved[slot]:
            raise ValueError(
                f"slot {slot}: {rows} rows exceed the reservation "
                f"({self._reserved[slot]} pages)")
        new = []
        while self._held[slot] < need:
            pid = self._alloc(slot, self._held[slot])
            self.refcount[pid] = 1
            self.table[slot, self._held[slot]] = pid
            self._held[slot] += 1
            new.append(pid)
        if new:
            self.version += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return new

    def ensure_writable(self, slot: int, start: int,
                        stop: int) -> tuple[list[int], list[tuple[int, int]]]:
        """Back logical rows [0, stop) and make the write window [start,
        stop) exclusively owned: any page in the window shared with other
        slots (refcount > 1) is swapped for a freshly allocated private
        page. Returns ``(new_page_ids, copies)`` where ``copies`` is the
        [(src_page, dst_page)] device copies the caller must perform
        BEFORE writing the window. Bumps ``version`` at most once."""
        v0 = self.version
        new = self.ensure(slot, stop)
        copies: list[tuple[int, int]] = []
        ps = self.page_size
        for pi in range(start // ps, -(-stop // ps)):
            page = int(self.table[slot, pi])
            if self.refcount[page] > 1:
                # position-rigid: the private replacement comes from the
                # SAME position's shard, so the device copy is shard-local
                private = self._alloc(slot, pi)
                self.refcount[page] -= 1
                self.refcount[private] = 1
                self.table[slot, pi] = private
                copies.append((page, private))
                self.cow_copies += 1
                self.scale_copies += 1     # device copy carries scale rows
        if copies and self.version == v0:
            self.version += 1
        return new, copies

    def commit_prefix(self, slot: int, tokens, filled: int) -> int:
        """Register ``slot``'s prompt pages in the prefix cache: page i is
        registered once rows [i*page_size, (i+1)*page_size) are prompt
        tokens already written to the cache (``filled`` rows are). Chunk-
        incremental and idempotent — the engine calls it after every
        prefill chunk. Returns the number of newly registered pages."""
        if not self.prefix_cache:
            return 0
        ps = self.page_size
        n_full = min(filled, len(tokens)) // ps
        key = _CHAIN_ROOT
        new = 0
        for i in range(min(n_full, self._held[slot])):
            key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
            page = int(self.table[slot, i])
            # Skip keys already registered (idempotence / another slot won
            # the race) and pages already carrying a key (an attached hit).
            if key in self._index or self._page_key[page] is not None:
                continue
            self._index[key] = page
            self._page_key[page] = key
            self._seqno += 1
            self._seq[page] = self._seqno
            new += 1
        return new

    def fork(self, src: int, dst: int, rows: int,
             src_rows: int) -> list[tuple[int, int]] | None:
        """Fork ``src``'s first ``src_rows`` KV rows into empty slot
        ``dst`` with a fresh worst-case reservation of ``rows``: full
        pages are shared (refcount++, lazily copy-on-write), a partially
        filled tail page is copied eagerly (charged to ``dst``) so both
        streams can append without a COW charged to ``src``'s budget.
        Returns the [(src_page, dst_page)] device copies the caller must
        perform, or None (no state change) when the pool cannot guarantee
        the new pages. Building block for n>1 parallel sampling."""
        if self._reserved[dst]:
            raise ValueError(f"slot {dst} already holds a reservation")
        need = self.pages_for(rows)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"slot {dst}: {rows} rows need {need} pages > "
                f"max_pages_per_slot ({self.max_pages_per_slot})")
        held = self._held[src]
        if self.pages_for(src_rows) != held:
            raise ValueError(
                f"fork: src slot {src} holds {held} pages but src_rows="
                f"{src_rows} spans {self.pages_for(src_rows)}")
        if need < held:
            raise ValueError(f"fork: rows ({rows}) below src fill "
                             f"({src_rows})")
        shared = min(src_rows // self.page_size, held)
        demand = [0] * self.seq_shards
        for j in range(shared, need):      # tail copy + future ensures
            demand[self.position_shard(j)] += 1
        for d in range(self.seq_shards):
            if demand[d] > self.free_pages_by_shard(d) - \
                    self.outstanding_by_shard(d):
                return None
        self._reserved[dst] = need
        self._outstanding[dst] = demand
        for i in range(shared):
            page = int(self.table[src, i])
            self.refcount[page] += 1
            self.table[dst, i] = page
        self._held[dst] = shared
        copies: list[tuple[int, int]] = []
        for i in range(shared, held):      # the partial tail page, if any
            private = self._alloc(dst, i)
            self.refcount[private] = 1
            self.table[dst, i] = private
            self._held[dst] = i + 1
            copies.append((int(self.table[src, i]), private))
            self.scale_copies += 1         # eager tail copy moves scales too
        if self._held[dst]:
            self.version += 1
        self.peak_reserved = max(self.peak_reserved, self.reserved_pages)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return copies

    def release(self, slot: int) -> list[int]:
        """Drop every page reference ``slot`` holds and its reservation;
        returns the page ids dereferenced. A page whose refcount drops to
        0 returns to the free list — or, when registered in the prefix
        cache, parks on the evictable list with its K/V intact, ready to
        be attached by a later request with the same prefix. ONE version
        bump per call, however many pages move."""
        pages = self.owned(slot)
        for page in pages:
            self.refcount[page] -= 1
            if self.refcount[page] == 0:
                if self._page_key[page] is not None:
                    self._evictable[page] = self._page_key[page]
                else:
                    self._free_by[self.page_shard(page)].append(page)
                    self._scale_live[page] = False
        self.table[slot, :] = -1
        self._held[slot] = 0
        self._reserved[slot] = 0
        self._outstanding[slot] = [0] * self.seq_shards
        if pages:
            self.version += 1
        return pages


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    # per-request serve/sampling.SamplingParams (None = greedy). Held
    # opaquely — the scheduler never reads its fields, so this module stays
    # framework-free; the engine mirrors it into the device bank at
    # admission time.
    sampling: object | None = None


@dataclass
class SlotState:
    request: Request
    generated: list = field(default_factory=list)
    filled: int = 0                       # prompt tokens prefilled so far
    phase: str = PREFILLING
    prefix_cached: int = 0                # rows admitted from the prefix
                                          # cache (filled starts here)

    @property
    def last_token(self) -> int:
        return self.generated[-1]

    def done(self) -> bool:
        r = self.request
        if r.eos_id is not None and self.generated and (
                self.generated[-1] == r.eos_id):
            return True
        return len(self.generated) >= r.max_new_tokens


class Scheduler:
    """Admission queue + slot table. max_seq bounds prompt + generation so a
    slot can never overflow its KV-cache rows.

    With a ``page_pool`` (paged KV serving), admission additionally requires
    a worst-case page reservation — a request stays queued (FIFO order
    preserved) until the pool can guarantee prompt + token-budget rows — and
    ``finish`` releases every page the slot held. ``submit`` rejects a
    request whose worst-case reservation could NEVER be satisfied (more
    pages than the pool holds, or than one slot may map): such a request
    would otherwise park at the FIFO head failing ``reserve`` forever."""

    def __init__(self, max_slots: int, max_seq: int,
                 page_pool: PagePool | None = None):
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_pool = page_pool
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * max_slots
        self._uids = itertools.count()

    # ------------------------------------------------------- admission ----
    def submit(self, prompt, max_new_tokens: int,
               eos_id: int | None = None, sampling=None) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq ({self.max_seq})")
        if self.page_pool is not None:
            pool = self.page_pool
            need = pool.pages_for(len(prompt) + max_new_tokens)
            # per-shard capacity, not the global total: the block position
            # map puts min(need, block) of this slot's pages on shard 0 —
            # a request that fits num_pages globally but overflows one
            # shard's slice would park at the FIFO head failing reserve
            # forever
            worst_shard = min(need, pool.position_block)
            if need > pool.max_pages_per_slot or \
                    worst_shard > pool.pages_per_shard:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({max_new_tokens}) needs {need} pages "
                    f"({worst_shard} on one shard), beyond pool capacity "
                    f"({pool.num_pages} pages over {pool.seq_shards} "
                    f"shard(s) = {pool.pages_per_shard} per shard, "
                    f"{pool.max_pages_per_slot} per slot) — the request "
                    f"could never be admitted")
        uid = next(self._uids)
        self.queue.append(Request(uid, prompt, max_new_tokens, eos_id,
                                  sampling))
        return uid

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self) -> tuple[int, Request] | None:
        """Pop the next queued request into a free slot (PREFILLING state),
        if both exist. With a page pool, a request whose prompt prefix is
        cached admits *warm*: its slot's table rows point at the shared
        pages and ``filled`` starts past them, so prefill begins at the
        first uncached row."""
        slot = self.free_slot()
        if slot is None or not self.queue:
            return None
        req = self.queue[0]
        skip = 0
        if self.page_pool is not None:
            skip = self.page_pool.reserve_prefix(
                slot, len(req.prompt) + req.max_new_tokens, req.prompt)
            if skip is None:
                return None               # pool full: request stays queued
        self.queue.popleft()
        state = SlotState(req)
        state.filled = state.prefix_cached = skip
        self.slots[slot] = state
        return slot, req

    # --------------------------------------------------------- prefill ----
    def prefilling(self) -> list[tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and s.phase == PREFILLING]

    def prefill_plan(self, chunk: int,
                     budget: int) -> list[tuple[int, int, int]]:
        """Chunks to prefill this iteration: (slot, start, n) triples.

        At most one chunk (``n <= chunk`` tokens) per PREFILLING slot, total
        real tokens capped by ``budget`` — except that the first planned
        chunk always runs, so a budget below the chunk size cannot starve
        prefill forever. The cap is checked *before* a chunk is planned:
        a chunk that would push the total past ``budget`` waits for the
        next iteration rather than overshooting by up to ``chunk - 1``."""
        plan: list[tuple[int, int, int]] = []
        used = 0
        for i, s in self.prefilling():
            n = min(chunk, len(s.request.prompt) - s.filled)
            if plan and used + n > budget:
                break
            plan.append((i, s.filled, n))
            used += n
        return plan

    def record_prefill(self, slot: int, n: int) -> bool:
        """Account ``n`` prefilled prompt tokens; True when the prompt just
        completed (slot moves to DECODING and the engine must sample the
        first output token from this chunk's logits)."""
        s = self.slots[slot]
        if s.phase != PREFILLING:
            raise ValueError(f"slot {slot} is not prefilling")
        s.filled += n
        if s.filled > len(s.request.prompt):
            raise ValueError(
                f"slot {slot} overfilled: {s.filled} > "
                f"{len(s.request.prompt)} prompt tokens")
        if s.filled == len(s.request.prompt):
            s.phase = DECODING
            return True
        return False

    # --------------------------------------------------------- decoding ----
    def active(self) -> list[tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def decoding(self) -> list[tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and s.phase == DECODING]

    def record(self, slot: int, token: int) -> bool:
        """Append a sampled token; True when the request just finished."""
        state = self.slots[slot]
        state.generated.append(int(token))
        return state.done()

    def finish(self, slot: int) -> tuple[int, list[int]]:
        """Recycle the slot (releasing its pages, if paged); returns
        (uid, generated tokens)."""
        state = self.slots[slot]
        self.slots[slot] = None
        if self.page_pool is not None:
            self.page_pool.release(slot)
        return state.request.uid, state.generated

    # ----------------------------------------------------------- status ----
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)
