"""The plain KV walks bounded on the device: what a CUDA graph replay of
``core/attention._kv_walk`` executes.

Under a capture each block of the walk is an IF node on ``live[j]``,
``live = arange(n_blocks) < hi`` with ``hi`` computed on the device
(``_live_blocks``), the reference's ``fori_loop(0, hi)`` bound. On the CPU:

* the device bound equals the reference's ``hi`` (read from its
  ``_kv_walk``'s argument) across random fills: contiguous caches, one
  with a short last block, and paged caches with -1 pages past and inside
  a fill, with inactive slots (length 0);
* the walk run under a hook that executes block j only where ``live[j]``
  holds, read on the host (what a replay executes), equals the sweep (the
  eager walk) and ``test_torch_fixed_walk._bounded_walk`` bit for bit, for
  consmax, softmax and softermax, contiguous and paged (chunk and one-token
  decode), bf16 and int8 K/V, plain, window and softcap, with garbage rows
  of +-3e4 past the fill;
* that walk is within ``1e-5 * max |ref|`` of the reference's
  ``append_attention`` / ``paged_attention``.

Single-threaded, at the small shapes of tests/test_torch_fixed_walk.py,
whose helpers it imports.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro_torch.core import attention as TA
from test_torch_fixed_walk import (B, C, KC, L, NORMS, PS, VARIANTS,
                                   _bounded_walk, _case, _close, _norm_params,
                                   _paginate, _torch)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replayed(body, n_blocks, live, device):
    """``_walk_blocks`` as a replay runs it: block j only where ``live[j]``
    (read here on the host)."""
    _replayed.ran = [j for j, on in enumerate(live().tolist()) if on]
    for j in _replayed.ran:
        body(j)


def _three(fn):
    """``fn()`` through the replayed walk, the sweep and the fill-bounded
    reference walk of test_torch_fixed_walk.py, and the blocks the replay
    ran."""
    real_blocks, real_walk = TA._walk_blocks, TA._kv_walk
    TA._walk_blocks = _replayed
    try:
        replay = fn()
        ran = _replayed.ran
    finally:
        TA._walk_blocks = real_blocks
    sweep = fn()
    TA._kv_walk = _bounded_walk
    try:
        bounded = fn()
    finally:
        TA._kv_walk = real_walk
    return replay, sweep, bounded, ran


# ------------------------------------------------------------ the bound ----
def _bounds(ref_fn, port_fn):
    """(the reference walk's ``hi``, the port's ``live`` mask) of one call
    each: both walks are stubbed out, only their bounds are kept."""
    seen = {}

    def ref_walk(q, index, lengths, gather, hi, *a, **kw):
        seen["hi"] = int(hi)
        return jnp.zeros(q.shape, q.dtype)

    def port_blocks(body, n_blocks, live, device):
        seen["live"] = live()

    real_ref, real_port = JA._kv_walk, TA._walk_blocks
    JA._kv_walk, TA._walk_blocks = ref_walk, port_blocks
    try:
        ref_fn()
        port_fn()
    finally:
        JA._kv_walk, TA._walk_blocks = real_ref, real_port
    return seen["hi"], seen["live"]


@pytest.mark.parametrize("layout", ["contiguous", "short_last_block",
                                    "paged", "paged_decode"])
def test_device_bound_equals_the_reference_hi(layout):
    r = np.random.default_rng(11)
    length = L - 3 if layout == "short_last_block" else L
    n_blocks = -(-length // KC) if "paged" not in layout else L // PS
    q = np.zeros((B, C, 6, 16), np.float32)
    k = np.zeros((B, length, 2, 16), np.float32)
    kp = np.zeros((B * n_blocks + 1, PS, 2, 16), np.float32)
    seen_hi = set()
    for _ in range(16):
        c = 1 if layout == "paged_decode" else C
        fills = r.integers(0, length + 1, B)
        lengths = np.minimum(r.integers(0, c + 1, B), fills)
        lengths[r.integers(0, B)] = 0                   # an inactive slot
        index = (fills - lengths).astype(np.int32)
        lengths = lengths.astype(np.int32)
        table = r.permutation(B * n_blocks).astype(np.int32).reshape(
            B, n_blocks)
        for b, f in enumerate(fills):
            table[b, -(-int(f) // PS):] = -1            # past the fill
            if f > PS:
                table[b, r.integers(0, f // PS)] = -1   # inside it
        args = [jnp.asarray(index), jnp.asarray(lengths)]
        targs = [torch.tensor(index), torch.tensor(lengths)]
        common = dict(norm_kind="softmax", norm_params=None)
        if "paged" in layout:
            hi, live = _bounds(
                lambda: JA.paged_attention(
                    jnp.asarray(q[:, :c]), jnp.asarray(kp), jnp.asarray(kp),
                    jnp.asarray(table), *args, **common),
                lambda: TA.paged_attention(
                    torch.tensor(q[:, :c]), torch.tensor(kp),
                    torch.tensor(kp), torch.tensor(table), *targs, **common))
        else:
            hi, live = _bounds(
                lambda: JA.append_attention(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), *args,
                    kv_chunk=KC, **common),
                lambda: TA.append_attention(
                    torch.tensor(q), torch.tensor(k), torch.tensor(k),
                    *targs, kv_chunk=KC, **common))
        assert live.dtype == torch.bool and live.shape == (n_blocks,)
        assert torch.equal(live, torch.arange(n_blocks) < min(hi, n_blocks))
        seen_hi.add(hi)
    assert len(seen_hi) > 3                 # the fills moved the bound


# ------------------------------------------------- the replayed walk ----
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("norm", NORMS)
def test_replayed_walk_equals_the_sweep_and_the_bounded_walk(norm, kv,
                                                            variant):
    q, qt, index, lengths, fills, k, v, scales = _case(norm, kv,
                                                       torch.bfloat16, 5)
    tp, _ = _norm_params(norm)
    common = dict(norm_kind=norm, norm_params=tp, **VARIANTS[variant])
    ts = {n: _torch(a) for n, a in scales.items()}
    idx, lens = torch.tensor(index), torch.tensor(lengths)
    # contiguous: 8 blocks, the highest fill (24 rows) in block 2
    replay, sweep, bounded, ran = _three(lambda: TA.append_attention(
        qt, _torch(k), _torch(v), idx, lens, kv_chunk=KC, **common, **ts))
    assert ran == [0, 1, 2]
    assert torch.isfinite(replay).all()
    assert torch.equal(replay, sweep) and torch.equal(replay, bounded)
    # paged: chunk and one-token decode (slots 1 and 2 inactive)
    kp, vp, sp, table = _paginate(k, v, scales, fills, 6)
    tsp = {n: _torch(a) for n, a in sp.items()}
    for qq, ll in ((qt, lens), (qt[:, :1], torch.tensor([1, 0, 0, 1],
                                                        dtype=torch.int32))):
        replay, sweep, bounded, ran = _three(lambda: TA.paged_attention(
            qq, _torch(kp), _torch(vp), torch.tensor(table), idx, ll,
            **common, **tsp))
        assert ran == list(range(-(-int((idx + ll).max()) // PS)))
        assert torch.isfinite(replay[ll > 0]).all()
        assert torch.equal(replay, sweep) and torch.equal(replay, bounded)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("norm", NORMS)
def test_replayed_walk_matches_reference(norm, kv):
    q, qt, index, lengths, fills, k, v, scales = _case(norm, kv,
                                                       torch.float32, 8)
    tp, jp = _norm_params(norm)
    ts = {n: _torch(a) for n, a in scales.items()}
    js = {n: jnp.asarray(a) for n, a in scales.items()}
    kp, vp, sp, table = _paginate(k, v, scales, fills, 9)
    live = lengths > 0
    real = TA._walk_blocks
    TA._walk_blocks = _replayed
    try:
        for kw in VARIANTS.values():
            ref = JA.append_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(index), jnp.asarray(lengths), kv_chunk=KC,
                norm_kind=norm, norm_params=jp, **kw, **js)
            got = TA.append_attention(
                qt, _torch(k), _torch(v), torch.tensor(index),
                torch.tensor(lengths), kv_chunk=KC, norm_kind=norm,
                norm_params=tp, **kw, **ts)
            assert len(_replayed.ran) < L // KC
            _close(got[live], np.asarray(ref)[live])
            ref = JA.paged_attention(
                jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(table), jnp.asarray(index), jnp.asarray(lengths),
                norm_kind=norm, norm_params=jp, **kw,
                **{n: jnp.asarray(a) for n, a in sp.items()})
            got = TA.paged_attention(
                qt, _torch(kp), _torch(vp), torch.tensor(table),
                torch.tensor(index), torch.tensor(lengths), norm_kind=norm,
                norm_params=tp, **kw, **{n: _torch(a) for n, a in sp.items()})
            assert len(_replayed.ran) < L // PS
            _close(got[live], np.asarray(ref)[live])
    finally:
        TA._walk_blocks = real
