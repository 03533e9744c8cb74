"""What training and serving read of the reference's
``distributed/sharding.py``, over ``torch.distributed``.

* ``dp_axes``: the data-parallel axes of a mesh (``pod``, ``data``);
* ``shards_params`` / ``shard_model``: the FSDP choice of the reference's
  ``make_rules`` (``fsdp=True`` / ``"full"``: parameters and optimizer
  state sharded over the data axes; ``False`` / ``"zero1"``: parameters
  replicated), turned into the modules FSDP2's ``fully_shard`` wraps: each
  block, then the root (embedding and final norm). The reference shards
  each leaf over ``data``; FSDP2 shards every parameter of a unit along
  its first axis, and a block is the unit whose parameters one forward
  step needs together;
* ``expert_parallel`` / ``ep_info``: the expert-parallel context. Inside
  ``expert_parallel(comm)``, ``ep_info()`` returns the group's ``Comm``
  and the MoE blocks take ``models/moe_ep``'s all-to-all dispatch where
  the group size divides the expert count (``models/blocks._moe_apply``);
  outside it, None. The reference reads the same from its rules'
  ``"experts"`` entry.

* the logical-axis rules of the reference, for the dry run
  (``launch/specs.py``, ``launch/dryrun.py``): ``make_rules`` maps each
  logical axis name (``embed``, ``heads``, ``act_batch``, ...; the
  parameters declare theirs, ``models.transformer.lm_axes``) to an ordered
  list of candidate mesh-axis tuples; ``resolve_spec`` picks, per
  dimension, the first candidate that exists in the mesh, divides the
  dimension and reuses no mesh axis of another dimension, and replicates
  (recording a fallback) where none does; ``placements`` turns the spec
  into DTensor placements; ``tree_shardings`` resolves a whole tree;
  ``activation_sharding`` / ``shard`` redistribute a DTensor activation to
  its resolved placements (the reference's ``with_sharding_constraint``).
  Outside ``activation_sharding``, and for a plain tensor, ``shard``
  returns its argument: the single-device paths do not change.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from types import SimpleNamespace
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.comm import Comm

_EP: contextvars.ContextVar = contextvars.ContextVar("expert_parallel",
                                                     default=None)


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names of ``mesh`` (a DeviceMesh)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def shards_params(fsdp) -> bool:
    """The reference's ``make_rules`` reading of ``TrainConfig.fsdp``:
    True / "full" shard the parameters over the data axes; False /
    "zero1" keep them replicated."""
    if fsdp not in (True, False, "full", "zero1"):
        raise ValueError(f"fsdp must be True, False, 'full' or 'zero1', got "
                         f"{fsdp!r}")
    return fsdp in (True, "full")


def shard_model(model, mesh):
    """``fully_shard`` the units of ``model`` over the data axis of
    ``mesh``, in place, innermost first: every block of every super-layer,
    then the model itself (its embedding and final norm). Returns the
    model, its parameters now DTensors holding this rank's first-axis
    shard."""
    axes = dp_axes(mesh)
    if len(axes) != 1:
        raise ValueError(f"FSDP over one data axis; mesh has {axes}")
    data = mesh[axes[0]]
    for unit in [blk for sup in model.blocks for blk in sup.values()]:
        fully_shard(unit, mesh=data)
    fully_shard(model, mesh=data)
    return model


@contextlib.contextmanager
def expert_parallel(comm: Comm):
    """Run the MoE blocks expert-parallel over ``comm``'s group inside."""
    tok = _EP.set(comm)
    try:
        yield
    finally:
        _EP.reset(tok)


def ep_info():
    """The expert-parallel group's ``Comm`` inside ``expert_parallel``,
    else None."""
    return _EP.get()


# ------------------------------------------------------ logical-axis rules ----
def mesh_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_rules(mesh, *, fsdp=True, seq_shard_kv=False,
               seq_shard_act: bool = False, serve_tp2d: bool = False,
               expert_shard: bool = False) -> dict:
    """logical name -> ordered candidate mesh-axis tuples (the reference's
    table).

    fsdp: True/"full" -> params+opt sharded over dp (ZeRO-3 style);
          "zero1"/False -> params replicated (opt sharding decided by the
          caller via a second rule set).
    seq_shard_kv: False | True/"dp" | "model" | "2d" — KV-cache sequence axis.
    serve_tp2d: decode-serving layout — batch replicated, weights 2D-sharded,
          KV sequence over (data, model).
    expert_shard: experts over the data axis.
    """
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    param_shard = fsdp in (True, "full")
    if serve_tp2d:
        seq_shard_kv = "2d"
    if seq_shard_kv in (True, "dp"):
        kv_axes = [dp]
    elif seq_shard_kv == "model":
        kv_axes = [tp]
    elif seq_shard_kv == "2d":
        kv_axes = [dp + tp, dp, tp]
    else:
        kv_axes = []
    rules: dict[str, list[tuple]] = {
        # ---- parameters ----
        "vocab": [tp],
        "embed": [dp] if param_shard else [],
        "heads": [tp],
        "kv_heads": [tp],
        "mlp": [tp],
        "experts": ([("data",)] if "data" in names else [dp])
        if expert_shard else [],
        "layers": [],
        "norm": [],
        "conv": [],
        "state": [],
        # ---- activations ----
        "act_batch": [] if serve_tp2d else [dp, dp[-1:] if dp else []],
        "act_seq": [tp] if seq_shard_act else [],
        "act_kv_seq": kv_axes,
        "act_heads": [tp],
        "act_kv_heads": [tp],
        "act_embed": [],
        "act_mlp": [tp],
        "act_vocab": [tp],
        "act_experts": [],
    }
    return {k: [c for c in v if c] for k, v in rules.items()}


def resolve_spec(shape: Sequence[int], axes_str: str, mesh, rules: dict,
                 fallbacks: Optional[list] = None) -> tuple:
    """The spec of a ``shape`` tensor with logical axes ``axes_str``: per
    dimension None (replicated), one mesh axis name, or a tuple of them;
    trailing Nones trimmed. A named dimension that no candidate fits is
    replicated and, with ``fallbacks`` given, recorded there as
    ``(shape, logical, dim)``."""
    names = axes_str.split(",") if axes_str else [""] * len(shape)
    if len(names) != len(shape):
        names = (names + [""] * len(shape))[: len(shape)]
    used: set[str] = set()
    out = []
    sizes = mesh_sizes(mesh)
    for dim, logical in zip(shape, names):
        assigned = None
        for cand in rules.get(logical, []):
            if not all(a in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                assigned = cand
                break
        if (assigned is None and logical and rules.get(logical)
                and fallbacks is not None):
            fallbacks.append((tuple(shape), logical, dim))
        used.update(assigned or ())
        out.append(assigned if assigned is None or len(assigned) > 1
                   else assigned[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension d is split over (a tuple of axes
    splits major to minor in mesh order, as the reference's spec does),
    ``Replicate()`` elsewhere."""
    by_axis = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """One device's shard shape of a ``shape`` tensor under ``spec``."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)


def _leaf_shape(leaf):
    """A tensor's shape, or the shape of a ``(shape, dtype)`` spec."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or (isinstance(x, tuple) and len(x) == 2
                                   and isinstance(x[0], tuple))


def tree_shardings(tree, axes_tree, mesh, rules: dict,
                   fallbacks: Optional[list] = None,
                   key: Optional[Callable] = None):
    """Map a tree (nested dicts / lists of tensors or ``(shape, dtype)``
    specs) and its axes-string tree of the same structure to the tree of
    specs. ``key(path)`` names the reference leaf a leaf belongs to
    (default: its path without list indices, i.e. without the super-layer
    the reference stacks on its leading axis): leaves of one reference
    leaf share its spec, and its fallbacks are recorded once, as the
    reference records them for the stacked leaf."""
    key = key or (lambda path: tuple(k for k in path
                                     if not isinstance(k, int)))
    memo: dict = {}

    def one(x, ax, path):
        if _is_leaf(x):
            k = key(path)
            if k not in memo:
                memo[k] = resolve_spec(_leaf_shape(x), ax, mesh, rules,
                                       fallbacks)
            return memo[k]
        if isinstance(x, dict):
            return {n: one(x[n], ax[n], path + (n,)) for n in x}
        if isinstance(x, (list, tuple)):
            return type(x)(one(a, b, path + (i,))
                           for i, (a, b) in enumerate(zip(x, ax)))
        raise TypeError(f"unexpected leaf {type(x).__name__} at {path}")
    return one(tree, axes_tree, ())


# F.logsigmoid (xLSTM's gates) dispatches log_sigmoid_forward, for which
# DTensor has no rule: it is pointwise, so every placement of its input
# carries to its output and to the buffer it saves for backward (the
# input's shape on the CPU; an empty tensor on CUDA, kept replicated).
def _log_sigmoid_strategies(x):
    cuda = x.mesh.device_type == "cuda"
    out = [([Replicate(), Replicate()], [Replicate()])]
    for d in range(len(x.shape)):
        out.append(([Shard(d), Replicate() if cuda else Shard(d)],
                    [Shard(d)]))
    return out


def _log_sigmoid_backward_strategies(grad, x, buf):
    cuda = x.mesh.device_type == "cuda"
    out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
    for d in range(len(x.shape)):
        out.append(([Shard(d)], [Shard(d), Shard(d),
                                 Replicate() if cuda else Shard(d)]))
    return out


@functools.cache
def _register_rules():
    """Add the rules above to DTensor's, once, on first use."""
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    register_sharding(aten.log_sigmoid_forward.default)(
        _log_sigmoid_strategies)
    register_sharding(aten.log_sigmoid_backward.default)(
        _log_sigmoid_backward_strategies)


class ShardingCtx:
    def __init__(self, mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules


_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


class _ReplicateOnRefusal(TorchDispatchMode):
    """XLA's partitioner replicates what it cannot shard; DTensor raises.
    Where DTensor refuses an out-of-place op for its inputs' placements (an
    op with no sharding rule, a view that would split a sharded dimension
    unevenly), or where an op's result comes out strided-sharded
    (``_settled``), this mode replicates the first input's sharded
    dimensions, one mesh axis at a time, then (for a refusal) every DTensor
    input whole, and runs the op again; an op with no rule at all then
    runs on the replicated inputs' local tensors, its result replicated.
    The op always runs, and the collectives that takes are the step's. Each replicated dimension is recorded in ``fallbacks`` as
    ``(shape, "op:<name>", dim)``, once per distinct site."""

    def __init__(self, fallbacks: list):
        super().__init__()
        self.fallbacks = fallbacks
        self._seen: set = set()

    def _record(self, t, dim, name):
        key = (tuple(t.shape), f"op:{name}", dim)
        if key not in self._seen:
            self._seen.add(key)
            self.fallbacks.append(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        first = None
        try:
            try:
                out = func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as err:
                if name.endswith("_") or not isinstance(args[0], DTensor):
                    raise
                first, out = err, None
            else:
                if _settled(out) or not isinstance(args[0], DTensor):
                    return out
                first = None
            x = args[0]
            # one mesh axis at a time, trailing tensor dimensions first (a
            # view splits or merges the trailing ones; the batch stays
            # sharded)
            sharded = sorted((i for i, q in enumerate(x.placements)
                              if isinstance(q, Shard)),
                             key=lambda i: -x.placements[i].dim)
            for i in sharded:
                pl = list(x.placements)
                pl[i] = Replicate()
                try:
                    retry = func(x.redistribute(x.device_mesh, tuple(pl)),
                                 *args[1:], **kwargs)
                except (RuntimeError, NotImplementedError):
                    continue
                if _settled(retry):
                    self._record(x, x.placements[i].dim, name)
                    return retry
            if first is None:
                return out
            whole = []
            for a in args:
                if isinstance(a, DTensor) and any(
                        not isinstance(q, Replicate) for q in a.placements):
                    for q in a.placements:
                        if isinstance(q, Shard):
                            self._record(a, q.dim, name)
                    a = a.redistribute(a.device_mesh,
                                       [Replicate()] * a.device_mesh.ndim)
                whole.append(a)
            try:
                return func(*whole, **kwargs)
            except NotImplementedError:
                # no sharding rule at all: every device runs the op on the
                # replicated inputs, its own copy of the same result
                mesh = next(a for a in whole
                            if isinstance(a, DTensor)).device_mesh
                out = func(*[a.to_local() if isinstance(a, DTensor) else a
                             for a in whole], **kwargs)
                rep = [Replicate()] * mesh.ndim
                wrap = (lambda t: DTensor.from_local(t, mesh, rep,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t)
                return (type(out)(wrap(t) for t in out)
                        if isinstance(out, (tuple, list)) else wrap(out))
            except RuntimeError:
                raise first
        finally:
            # a caught error's traceback holds this frame, whose locals
            # hold the error: without this the frame, and the tensors it
            # holds, would wait for the cyclic collector (the dry run's
            # memory tracker would see them live)
            first = None


def _settled(out) -> bool:
    """No strided shard in ``out``'s placements: a view that merged two
    dimensions sharded over different mesh axes yields one, and DTensor
    reshards it only by reading index values, which a fake tensor has
    not."""
    return not (isinstance(out, DTensor) and any(
        type(q).__name__ == "_StridedShard" for q in out.placements))


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict, fallbacks: list | None = None):
    """Inside: ``shard`` redistributes DTensor activations by ``rules``;
    on a mesh of more than one device, ops DTensor refuses run replicated
    (``_ReplicateOnRefusal``), their sites recorded in ``fallbacks``."""
    _register_rules()
    tok = _CTX.set(ShardingCtx(mesh, rules))
    try:
        if math.prod(tuple(mesh.shape)) > 1:
            with _ReplicateOnRefusal([] if fallbacks is None else fallbacks):
                yield
        else:
            yield
    finally:
        _CTX.reset(tok)


def shard(x, axes_str: str):
    """An activation with logical axes ``axes_str``: inside
    ``activation_sharding``, a DTensor redistributed to its resolved
    placements (the collective that takes is the step's); otherwise, or
    for a plain tensor, ``x`` itself."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, axes_str, ctx.mesh, ctx.rules)
    want = placements(spec, ctx.mesh)
    if tuple(x.placements) == want:
        return x
    if any(q.is_partial() for q in x.placements):
        return _Settle.apply(x, ctx.mesh, want)
    return x.redistribute(ctx.mesh, want)


# ------------------------------------------------ products and head views ----
def rows_times(x, w2):
    """``x @ w2`` for a DTensor ``x`` (..., d), its last dimension whole
    on every device, and a weight ``w2`` (d, n) whose columns no mesh axis
    splits: each device multiplies its own rows of ``x`` by the whole
    ``w2``, and the product is placed as ``x`` is, its columns whole — how
    XLA computes a product whose spec replicates its columns. DTensor's
    rule may split the columns instead, which a head view of a head count
    the axis does not divide cannot keep: it would gather them back. The
    weight is gathered whole (the FSDP all-gather DTensor's rule takes
    too); its gradient is partial over the axes that split ``x``'s rows
    and returns to ``w2``'s placements."""
    mesh = x.device_mesh
    full = w2.redistribute(mesh, (Replicate(),) * mesh.ndim)
    grad = tuple(Partial() if isinstance(q, Shard) else Replicate()
                 for q in x.placements)
    y = x.to_local() @ full.to_local(grad_placements=grad)
    return DTensor.from_local(y, mesh, x.placements, run_check=False)


def takes_rows_times(x, w, dims) -> bool:
    """Whether ``rows_times`` computes ``x @ w`` (``w``'s dimensions
    ``dims`` the product's columns): both DTensors, ``x`` split over no
    axis along its last dimension and partial over none, the columns
    split over no axis."""
    return (isinstance(x, DTensor) and isinstance(w, DTensor)
            and all(isinstance(q, Replicate) or (
                isinstance(q, Shard) and q.dim != x.ndim - 1)
                for q in x.placements)
            and not any(isinstance(q, Shard) and q.dim in dims
                        for q in w.placements))


def attention_on_shards(fn, q, k, v, *slots, norm_params=None, **kw):
    """``fn(q, k, v, *slots, norm_params=..., **kw)``, a plain attention
    walk (q (b, s, H, dk); k, v and the ``k_scale`` / ``v_scale`` of
    ``kw`` with their KV heads along dim 2; ``slots``, the index and
    lengths, along batch), run on each device's own batch rows and query
    heads. Attention is independent per (batch row, head): where every
    DTensor operand is split along batch and heads only, each device runs
    the single-device ops on its shards and no byte crosses devices; the
    output is placed as ``q``. Where the rules replicate the KV heads
    (fewer than the axis holds), a device takes the KV heads its query
    heads read, and of replicated per-head ConSmax parameters its heads'
    entries; their gradients are partial over the axes that split the
    query. Under any other placement (a plain ``q``, a KV sequence split
    over an axis) ``fn`` runs as called and DTensor's rules place each
    op."""
    scales = [kw[n] for n in ("k_scale", "v_scale") if kw.get(n) is not None]
    params = ([norm_params.beta, norm_params.gamma]
              if hasattr(norm_params, "beta") else [])
    plan = _shard_plan(q, [k, v, *scales], slots, params)
    if plan is None:
        return fn(q, k, v, *slots, norm_params=norm_params, **kw)
    h_axes, b_axes, kv_whole = plan
    mesh = q.device_mesh
    H, hkv = q.shape[2], k.shape[2]
    g = H // hkv
    coord, sizes = mesh.get_coordinate(), tuple(mesh.shape)
    idx, n = 0, 1
    for i in h_axes:                     # major to minor, in mesh order
        idx, n = idx * sizes[i] + coord[i], n * sizes[i]
    h_loc = H // n
    h0 = idx * h_loc

    def local(t, dim=None, start=0, length=0):
        tl = t.to_local(grad_placements=tuple(
            Partial() if isinstance(p, Replicate) and i in h_axes + b_axes
            else p for i, p in enumerate(t.placements)))
        return tl if dim is None else tl.narrow(dim, start, length)

    kv_part = (2, h0 // g, max(1, h_loc // g)) if kv_whole else ()
    for name in ("k_scale", "v_scale"):
        if kw.get(name) is not None:
            kw[name] = local(kw[name], *kv_part)
    if params:
        part = (0, h0, h_loc) if tuple(params[0].shape) == (H,) and any(
            isinstance(params[0].placements[i], Replicate)
            for i in h_axes) else ()
        norm_params = SimpleNamespace(
            beta=local(params[0], *part), gamma=local(params[1], *part))
    out = fn(q.to_local(), local(k, *kv_part), local(v, *kv_part),
             *(t.to_local() for t in slots), norm_params=norm_params, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _shard_plan(q, kvs, slots, params):
    """(head axes, batch axes, KV heads whole on the head axes) where
    ``attention_on_shards`` can run the walk per shard, else None."""
    if not isinstance(q, DTensor) or not all(
            isinstance(t, DTensor) for t in (*kvs, *slots, *params)):
        return None
    h_axes = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    b_axes = [i for i, p in enumerate(q.placements) if p == Shard(0)]
    if len(h_axes) + len(b_axes) != sum(
            not isinstance(p, Replicate) for p in q.placements):
        return None
    sizes = tuple(q.device_mesh.shape)
    n = math.prod(sizes[i] for i in h_axes)
    H, hkv = q.shape[2], kvs[0].shape[2]
    g, h_loc = H // hkv, H // n
    kv_whole = bool(h_axes) and all(
        isinstance(kvs[0].placements[i], Replicate) for i in h_axes)
    if H % n or (kv_whole and h_loc % g and g % h_loc) or (
            not kv_whole and hkv % n):
        return None                      # uneven, or a KV group split

    def placed(t, on_batch, on_heads):
        return all(p in (on_batch if i in b_axes else on_heads if i in h_axes
                         else (Replicate(),))
                   for i, p in enumerate(t.placements))

    kv_heads = (Replicate(),) if kv_whole else (Shard(2),)
    ok = (all(placed(t, (Shard(0),), kv_heads) for t in kvs)
          and all(placed(t, (Shard(0),), (Replicate(),)) for t in slots)
          and all(tuple(t.shape) in ((H,), (1,)) and placed(
              t, (Replicate(),), (Replicate(), Shard(0))) for t in params))
    return (h_axes, b_axes, kv_whole) if ok else None


class _Settle(torch.autograd.Function):
    """A partial activation (a vocab-sharded embedding's masked sum, a
    contraction over a sharded axis) redistributed to ``want``. Its
    gradient goes back settled, with no partial placement: DTensor cannot
    turn a partial gradient into the source's masked-partial one."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh = mesh
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        settled = tuple(Replicate() if q.is_partial() else q
                        for q in g.placements)
        if settled != tuple(g.placements):
            g = g.redistribute(ctx.mesh, settled)
        return g, None, None
