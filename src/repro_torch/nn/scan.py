"""``scan``: a recurrence walked along time, recomputed chunk by chunk in
backward — the reference's ``jax.lax.scan(jax.checkpoint(chunk), carry,
xs)`` (its sLSTM and its mLSTM's chunk walk, ``models/xlstm.py``).

    carry, ys = scan(step, carry, (xs,), chunk=cfg.xlstm.chunk, params=(r,))

``step(carry, x_t, *params) -> (carry, y_t)``: ``carry`` a tuple of
tensors, ``x_t`` the tuple of slices ``x[:, t]`` of the tensors ``xs``
(each (b, s, ...)). Returns the final carry and ``ys`` (b, s, ...), the
``y_t`` stacked along dim 1. The
forward walks the steps in order and keeps only the carry at each chunk's
start; backward recomputes one chunk at a time from its saved carry and
runs its steps' backward, last step first. The reference pads a ragged
last chunk; here it runs short, which changes no output.

Every op of the backward is written out (``_Scan.backward``): each step's
recompute is its own autograd graph, its ``autograd.grad`` and the sums
into the parameters' gradients are explicit, so one call to ``step``
followed by one call of its backward is one step's whole cost. That is
what the dry run needs: under its counting modes
(``distributed/op_analysis``, ``distributed/op_cost``) on fake tensors,
``scan`` traces a single step forward and backward and counts its ops,
bytes and collectives ``s`` times (``op_analysis.repeated``), the
reference's while-loop multiplicity, instead of walking every step
(``_CountedScan``). It still allocates the stacked ``ys`` and, as empty
buffers, what the walk holds live (the chunk-start carries, the steps'
outputs before they are stacked, one chunk's recomputed steps in
backward), so the memory tracker's peak follows the walk's. On real
tensors, or outside the counting modes, or inside ``walked()``, every step
runs.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

_WALK: contextvars.ContextVar = contextvars.ContextVar("scan_walk",
                                                       default=False)


@contextlib.contextmanager
def walked():
    """Inside: the dry run walks every step too (its counts are then those
    of the walk, which ``_CountedScan`` must reproduce)."""
    tok = _WALK.set(True)
    try:
        yield
    finally:
        _WALK.reset(tok)


def counted(t) -> bool:
    """Whether repeated work on ``t`` may be traced once and counted with
    its repetitions: a fake tensor under the dry run's counting modes,
    outside ``walked()``."""
    from repro_torch.distributed import op_analysis as OA
    return not _WALK.get() and is_fake(t) and OA.counting()


def scan(step, carry, xs, *, chunk: int, params=()):
    """See the module docstring. ``params`` are the tensors ``step`` reads
    besides its carry and input (their gradients flow back through
    ``scan``)."""
    carry, xs = tuple(carry), tuple(xs)
    fn = _CountedScan if counted(xs[0]) else _Scan
    out = fn.apply(step, chunk, len(carry), len(xs), *carry, *xs, *params)
    return tuple(out[:-1]), out[-1]


def _split(counts, tensors):
    """(carry, inputs, params) of a flat tuple, ``counts`` = (nc, nx)."""
    nc, nx = counts
    return (tuple(tensors[:nc]), tuple(tensors[nc:nc + nx]),
            tuple(tensors[nc + nx:]))


def _steps(seqs):
    """The per-step input tuples of ``seqs``, each walked along dim 1."""
    return list(zip(*(t.unbind(1) for t in seqs)))


def _leaf(t):
    return t.detach().requires_grad_()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _bytes(ts) -> int:
    """One device's bytes of the tensors ``ts`` (a DTensor's shard)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in ts)


def _hold(nbytes: int, like):
    """An empty buffer of ``nbytes`` on ``like``'s device: what the walk
    holds live at this point, for the memory tracker (an allocation moves
    no byte and costs no FLOP)."""
    return torch.empty(max(nbytes, 0), dtype=torch.uint8,
                       device=_local(like).device)


def _run(step, carry, xt, params):
    """One step on fresh leaves, recorded for its own backward: returns
    ((carry, y), leaves)."""
    leaves = (tuple(_leaf(v) for v in carry), tuple(_leaf(x) for x in xt),
              tuple(_leaf(p) for p in params))
    return step(leaves[0], leaves[1], *leaves[2]), leaves


def _step_backward(step_out, leaves, g_carry, g_y):
    """One step's backward: ``step`` ran on the leaves (carry, x, params)
    into ``step_out`` = (carry, y); returns the gradients of the carry, of
    the inputs and of the params for those of the new carry and ``y``."""
    (cout, y), (cin, x, params) = step_out, leaves
    g_out = [torch.zeros_like(c) if g is None else g
             for c, g in zip(cout, g_carry)]
    grads = torch.autograd.grad((*cout, y), (*cin, *x, *params),
                                (*g_out, g_y), allow_unused=True)
    return _split((len(cin), len(x)), grads)


def _add(g_params, gp):
    return [a if b is None else a + b for a, b in zip(g_params, gp)]


def _saved(ctx):
    saved = ctx.saved_tensors
    seqs = saved[:ctx.nx]
    params = saved[ctx.nx:ctx.nx + ctx.n_params]
    rest = saved[ctx.nx + ctx.n_params:]
    return seqs, params, [rest[i:i + ctx.nc] for i in range(0, len(rest),
                                                          ctx.nc)]


def _keep(ctx, step, chunk, nc, nx, seqs, params, carries):
    ctx.step, ctx.chunk, ctx.nc, ctx.nx = step, chunk, nc, nx
    ctx.n_params = len(params)
    ctx.save_for_backward(*seqs, *params, *(c for cs in carries for c in cs))


def _stack_grads(g_xs):
    """The inputs' gradients, each stacked along dim 1 (g_xs: per step, a
    tuple over the inputs)."""
    return tuple(torch.stack(list(g), 1) for g in zip(*g_xs))


class _Scan(torch.autograd.Function):
    """Every step: the forward in order, keeping the carry at each chunk's
    start; the backward chunk by chunk, last first, each chunk's steps
    recomputed from its start (each step its own graph) and their backward
    run last step first, the parameters' gradients summed in that order."""

    @staticmethod
    def forward(ctx, step, chunk, nc, nx, *tensors):
        carry, seqs, params = _split((nc, nx), tensors)
        starts, ys = [], []
        for t, xt in enumerate(_steps(seqs)):
            if t % chunk == 0:
                starts.append(carry)
            carry, y = step(carry, xt, *params)
            ys.append(y)
        _keep(ctx, step, chunk, nc, nx, seqs, params, starts)
        return (*carry, torch.stack(ys, 1))

    @staticmethod
    def backward(ctx, *grads):
        seqs, params, starts = _saved(ctx)
        g_carry, g_ys = tuple(grads[:ctx.nc]), grads[ctx.nc]
        x_steps, g_y_steps = _steps(seqs), g_ys.unbind(1)
        g_params = [torch.zeros_like(p) for p in params]
        g_xs = [None] * len(x_steps)
        for ci in reversed(range(len(starts))):
            t0 = ci * ctx.chunk
            t1 = min(len(x_steps), t0 + ctx.chunk)
            with torch.enable_grad():
                steps, c = [], starts[ci]
                for t in range(t0, t1):
                    steps.append(_run(ctx.step, c, x_steps[t], params))
                    c = steps[-1][0][0]
            for t in reversed(range(t0, t1)):
                out, leaves = steps.pop()
                g_carry, g_xs[t], gp = _step_backward(out, leaves, g_carry,
                                                      g_y_steps[t])
                g_params = _add(g_params, gp)
        return (None, None, None, None, *g_carry, *_stack_grads(g_xs),
                *g_params)


def signature(tensors) -> tuple:
    """What decides a step's ops besides its constant operands: each
    tensor's type, shape, dtype and (a DTensor's) placements."""
    return tuple(None if t is None else (
        type(t).__name__, tuple(t.shape), t.dtype,
        tuple(t.placements) if isinstance(t, DTensor) else ())
        for t in tensors)


class _CountedScan(torch.autograd.Function):
    """``_Scan``'s ops with the repeated steps traced once. A step's ops
    follow from its inputs' ``signature``, and a step's outputs' signature
    from its inputs': once two consecutive steps start from the same
    signature, every later step does too. So the forward traces steps
    in order until that happens and counts the last one traced for all
    the steps left (``op_analysis.repeated``); the backward does the same
    from the last step down to the first whose carry stands for the later
    ones, then traces the steps before it one by one. The walk's live
    buffers the traced steps do not make are held as empty ones. Assumes,
    as the xLSTM cells do, that a step reads its whole carry (no carry
    gradient is None) and that its inputs' slices are alike."""

    @staticmethod
    def forward(ctx, step, chunk, nc, nx, *tensors):
        from repro_torch.distributed import op_analysis as OA
        carry, seqs, params = _split((nc, nx), tensors)
        x_steps = _steps(seqs)
        s = len(x_steps)
        reps, ys, t, prev = [], [], 0, None
        c_bytes = y_bytes = 0
        while t < s:
            sig = signature(carry)
            k = s - t if sig == prev else 1
            # what the walk holds at the block's last step u beyond the
            # carries and outputs traced here: its chunk-start carries (and
            # u's own) and the outputs of the steps before u
            u = t + k - 1
            held = _hold(max(0, u // chunk + 1 + (u % chunk != 0) - t - 1)
                         * c_bytes + (u - t) * y_bytes, seqs[0])
            reps.append(carry)
            with OA.repeated(k):
                carry, y = step(carry, x_steps[t], *params)
            del held
            ys += [y] * k
            c_bytes = _bytes(c for c in carry if c is not y)
            y_bytes = _bytes([y])
            prev, t = sig, t + k
        # and after the last step, every chunk's start carry and every
        # step's output until the stack
        ctx.starts = _hold((-(-s // chunk) - len(reps)) * c_bytes, seqs[0])
        pending = _hold((s - len(reps)) * y_bytes, seqs[0])
        out = torch.stack(ys, 1)
        del pending
        _keep(ctx, step, chunk, nc, nx, seqs, params, reps)
        return (*carry, out)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.distributed import op_analysis as OA
        seqs, params, reps = _saved(ctx)
        g_carry, g_ys = tuple(grads[:ctx.nc]), grads[ctx.nc]
        x_steps, g_y_steps = _steps(seqs), g_ys.unbind(1)
        s, last = len(x_steps), len(reps) - 1
        g_params = [torch.zeros_like(p) for p in params]
        g_xs = [None] * s
        tracker = OA.memory_tracker()
        traced = 0
        t, prev = s - 1, None
        while t >= 0:
            cin = reps[min(t, last)]
            sig = (t >= last, signature(cin), signature(g_carry),
                   signature(g_params))
            k = t - last + 1 if sig == prev else 1
            # the walk holds the inputs' gradients of the steps after the
            # block's last one (the traced steps hold theirs)
            pending = _hold((s - t + k - 2 - traced) * _bytes(x_steps[0]),
                            seqs[0])
            with OA.repeated(k):
                live = tracker.live if tracker else 0
                with torch.enable_grad():
                    out, leaves = _run(ctx.step, cin, x_steps[t], params)
                island = tracker.live - live if tracker else 0
                # the walk recomputes a whole chunk before its backward
                chunk = _hold((min(ctx.chunk, s) - 1) * island, seqs[0])
                g_carry, g_x, gp = _step_backward(out, leaves, g_carry,
                                                  g_y_steps[t])
                del chunk
                g_params = _add(g_params, gp)
            g_xs[t - k + 1:t + 1] = [g_x] * k
            del pending
            prev, t, traced = sig, t - k, traced + 1
        return (None, None, None, None, *g_carry, *_stack_grads(g_xs),
                *g_params)
