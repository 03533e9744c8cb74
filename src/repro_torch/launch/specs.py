"""Cell factory: (architecture x input shape x mesh) -> one device's step on
fake shards — the reference's ``launch/specs.py``.

Shapes (``configs/base.SHAPES``):
  train_4k     seq 4096   gbatch 256 -> train_step
  prefill_32k  seq 32768  gbatch 32  -> whole-prompt prefill_step
  decode_32k   seq 32768  gbatch 128 -> decode step (1 token, full cache)
  long_500k    seq 524288 gbatch 1   -> decode step, sequence-sharded KV;
               only for the sub-quadratic-decode families (ssm / hybrid):
               the full-attention archs are skipped and recorded.

The reference's cells are abstract (``ShapeDtypeStruct``s) and XLA
partitions them. Here every argument is a fake tensor (``FakeTensorMode``:
shape, dtype and device, no storage) of one device's shard, wrapped as a
DTensor with ``DTensor.from_local`` (which, unlike ``distribute_tensor``,
issues no collective) under the placements the reference's rules resolve
(``distributed/sharding``). Running ``cell.fn`` on them, inside
``cell.fake_mode``, runs the device's local ops and the collectives DTensor
inserts; ``launch/dryrun.py`` counts both. On a one-device mesh every
spec is replicated and the arguments are plain fake tensors.

``materialize`` gives the same cell real tensors from a seed (on a mesh
of real ranks, each rank's shards), so the dry run's reckoning can be held
against a real step on the card (``chip_smoke.py`` phase 19).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import SHAPES, ModelConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import cache_layout as CL
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.train import step as TS
from repro_torch.weights import ref_leaf

LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_supported(arch_id: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, ("full-attention arch: 512k dense-attention decode has "
                       "no sub-quadratic path (skip per assignment)")
    return True, ""


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    build_args: Callable             # -> one device's fake shards
    in_shardings: Any                # spec trees of the arguments
    out_shardings: Any
    cfg: ModelConfig
    meta: dict
    fallbacks: list
    donate: tuple = ()
    op_fallbacks: list = dataclasses.field(default_factory=list)
    mesh: Any = None
    fake_mode: Any = None
    kind: str = ""
    _args: tuple | None = None

    @property
    def args(self) -> tuple:
        """The step's arguments as fake shards, built at first use (the
        cell's ``meta`` needs none)."""
        if self._args is None:
            self._args = self.build_args()
        return self._args


# ------------------------------------------------------------------ trees ----
def _tree(x):
    """An argument as a tree of tensors: an ``LM`` as {name: parameter}."""
    if isinstance(x, nn.Module):
        return dict(x.named_parameters())
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v) for v in x)
    return x


def _leaves(tree, specs=None):
    """(leaf, spec) pairs of a tree (specs: the same structure, or None)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], None if specs is None else specs[k])
    elif isinstance(tree, (list, tuple)) and not SH._is_leaf(tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, None if specs is None else specs[i])
    else:
        yield tree, specs


def _shape_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return tuple(leaf[0]), leaf[1]


def _total_bytes(tree) -> int:
    total = 0
    for leaf, _ in _leaves(_tree(tree)):
        shape, dtype = _shape_dtype(leaf)
        n = 1
        for d in shape:
            n *= d
        total += n * dtype.itemsize
    return total


def _sharded_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a sharded tree (exact, from shard shapes)."""
    total = 0
    for leaf, spec in _leaves(_tree(tree), specs):
        shape, dtype = _shape_dtype(leaf)
        n = 1
        for d in SH.local_shape(shape, spec, mesh):
            n *= d
        total += n * dtype.itemsize
    return total


def _active_params(model: T.LM, cfg: ModelConfig) -> tuple[int, int]:
    """(N_total, N_active): MoE expert params scaled by top_k/n_experts."""
    total = active = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        path = name.split(".")
        if "moe" in path[:-1] and path[-1] in ("gate", "up", "down"):
            active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    return total, active


def _param_key(path) -> str:
    """A parameter's reference leaf: its spec and fallbacks are the
    stacked leaf's."""
    return ref_leaf(path[-1])


def _state_key(path):
    """A state leaf's reference leaf: a parameter-named leaf under its
    reference name, everything else by its path without list indices."""
    return tuple(ref_leaf(p) if isinstance(p, str) and p.startswith(
        "blocks.") else p for p in path if not isinstance(p, int))


# ------------------------------------------------------------ fake shards ----
def _shard_of(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = SH.mesh_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a is not None]
        if not axes:
            continue
        idx = 0
        n = 1
        for a in axes:                       # major to minor
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t.contiguous()


def _wrap(local: torch.Tensor, spec: tuple, mesh, requires_grad=False):
    """``local`` as the DTensor shard under ``spec``; a plain tensor on a
    one-device mesh, and for a 0-d leaf (the step counters, replicated)."""
    if mesh.size() == 1 or local.dim() == 0:
        return local.requires_grad_(requires_grad) if requires_grad else local
    dt = DTensor.from_local(local, mesh, SH.placements(spec, mesh),
                            run_check=False)
    return dt.requires_grad_(requires_grad) if requires_grad else dt


def _build(tree, specs, make, path=()):
    """A tree shaped like ``tree`` (of tensors or (shape, dtype) specs), its
    spec tree ``specs``; ``make(shape, dtype, spec, path)`` makes each
    leaf."""
    if isinstance(tree, dict):
        return {k: _build(tree[k], specs[k], make, path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not SH._is_leaf(tree):
        return [_build(v, specs[i], make, path + (i,))
                for i, v in enumerate(tree)]
    shape, dtype = _shape_dtype(tree)
    return make(shape, dtype, specs, path)


def _model_with(model: T.LM, params: dict, requires_grad: bool) -> T.LM:
    """``model`` with each parameter replaced by ``params[name]``."""
    for name, t in params.items():
        mod_name, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(mod_name), leaf,
                nn.Parameter(t, requires_grad=requires_grad))
    return model


# ------------------------------------------------------------------- cell ----
def cell_total_bytes(arch_id: str, shape_name: str, *,
                     score_norm: str = "consmax",
                     microbatch: int = 4) -> int:
    """Total (unsharded) irreducible bytes of a cell — see
    meta['useful_bytes_per_device'] (= this / n_dev). Mesh-free."""
    seq_len, global_batch, kind = SHAPES[shape_name]
    cfg = get_config(arch_id, score_norm=score_norm)
    if kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")
    if kind == "train":
        tcfg = TrainConfig(global_batch=global_batch, seq_len=seq_len,
                           microbatch=microbatch)
        abs_state = TS.abstract_state(cfg, tcfg)
        bspecs, _ = TS.batch_specs(cfg, seq_len, global_batch)
        return 2 * _total_bytes(abs_state) + _total_bytes(bspecs)
    abs_caches = T.init_caches(cfg, global_batch, seq_len, "bfloat16",
                               device="meta")
    s_in = seq_len if kind == "prefill" else 1
    if cfg.frontend == "tokens":
        inp = global_batch * s_in * 4
    else:
        inp = global_batch * s_in * cfg.d_model * 2
    return (_total_bytes(T.lm_abstract(cfg))
            + (2 if kind == "prefill" else 1) * _total_bytes(abs_caches)
            + inp)


def make_cell(arch_id: str, shape_name: str, mesh, *,
              score_norm: str = "consmax", fsdp="full",
              microbatch: int = 4, remat: str = "full",
              q_chunk: int = 2048, kv_chunk: int = 1024,
              seq_shard_kv=None, serve_tp2d: bool = False,
              expert_shard: bool = False,
              capacity_factor: float | None = None,
              overrides: dict | None = None, smoke: bool = False,
              global_batch: int | None = None, seq_len: int | None = None,
              device="cuda") -> Cell:
    """The reference's ``make_cell`` on ``mesh`` (a ``DeviceMesh``), its
    arguments fake shards on ``device``. ``smoke`` takes the arch's smoke
    config; ``global_batch`` / ``seq_len`` cut the shape (the reference's
    cells take neither)."""
    seq0, batch0, kind = SHAPES[shape_name]
    seq_len = seq_len or seq0
    global_batch = global_batch or batch0
    cfg = get_config(arch_id, score_norm=score_norm, smoke=smoke)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    if kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")   # serving: bf16 weights
    if overrides:
        cfg = cfg.replace(**overrides)
    if seq_shard_kv is None:
        seq_shard_kv = "dp" if shape_name == "long_500k" else False

    rules = SH.make_rules(mesh, fsdp=fsdp, seq_shard_kv=seq_shard_kv,
                          serve_tp2d=serve_tp2d, expert_shard=expert_shard)
    fallbacks: list = []
    op_fallbacks: list = []          # filled while the step runs
    meta = {"arch": arch_id, "shape": shape_name, "kind": kind,
            "seq_len": seq_len, "global_batch": global_batch,
            "score_norm": score_norm, "mesh": SH.mesh_sizes(mesh)}

    abstract = T.lm_abstract(cfg)
    n_total, n_active = _active_params(abstract, cfg)
    meta["n_params"] = n_total
    meta["n_active_params"] = n_active
    n_dev = mesh.size()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    def shardings_of(tree, axes, rules_=rules, key=None):
        return SH.tree_shardings(_tree(tree), axes, mesh, rules_,
                                 fallbacks, key=key)

    def build(tree, specs, requires_grad=False):
        def make(shape, dtype, spec, path):
            with fake_mode:
                local = torch.empty(SH.local_shape(shape, spec, mesh),
                                    dtype=dtype, device=device)
            return _wrap(local, spec, mesh, requires_grad)
        return _build(_tree(tree), specs, make)

    if kind == "train":
        tcfg = TrainConfig(global_batch=global_batch, seq_len=seq_len,
                           remat=remat, microbatch=microbatch,
                           fsdp=fsdp in (True, "full"),
                           q_chunk=q_chunk, kv_chunk=kv_chunk)
        _, train_step = TS.make_train_fns(cfg, tcfg, device=device)
        abs_state = TS.abstract_state(cfg, tcfg)
        ax = TS.state_axes(cfg, tcfg)
        if fsdp == "zero1":
            # ZeRO-1: params replicated (rules above), optimizer m/v sharded
            opt_rules = SH.make_rules(mesh, fsdp="full",
                                      seq_shard_kv=seq_shard_kv)
            st_sh = {
                "params": shardings_of(abs_state["params"], ax["params"],
                                       key=_state_key),
                "opt": shardings_of(abs_state["opt"], ax["opt"], opt_rules,
                                    key=_state_key),
                "step": shardings_of(abs_state["step"], ax["step"]),
            }
            for k in abs_state:
                if k not in st_sh:
                    st_sh[k] = shardings_of(abs_state[k], ax[k],
                                            key=_state_key)
        else:
            st_sh = shardings_of(abs_state, ax, key=_state_key)
        bspecs, baxes = TS.batch_specs(cfg, seq_len, global_batch)
        b_sh = shardings_of(bspecs, baxes)

        def build_args():
            params = build(abs_state["params"], st_sh["params"],
                           requires_grad=True)
            state = {"params": _model_with(T.lm_abstract(cfg), params, True)}
            for k in abs_state:
                if k != "params":
                    state[k] = build(abs_state[k], st_sh[k])
            return state, build(bspecs, b_sh)

        def fn(state, batch):
            with SH.activation_sharding(mesh, rules, op_fallbacks):
                return train_step(state, batch)

        metrics_sh = {k: () for k in ("ce", "aux", "loss", "lr",
                                      "grad_norm")}
        meta["model_flops"] = 6.0 * n_active * global_batch * seq_len
        meta["useful_bytes_per_device"] = (
            2 * _total_bytes(abs_state) + _total_bytes(bspecs)) // n_dev
        meta["state_bytes_per_device_actual"] = _sharded_bytes(
            abs_state, st_sh, mesh)
        return Cell(arch_id, shape_name, fn, build_args, (st_sh, b_sh),
                    (st_sh, metrics_sh), cfg, meta, fallbacks, donate=(0,),
                    op_fallbacks=op_fallbacks, mesh=mesh,
                    fake_mode=fake_mode, kind=kind)

    # ---- serving cells ----
    serve_step, scfg = SE.make_decode_for_dryrun(cfg, seq_len, device=device)
    if kind == "prefill":
        _, step, _, _ = SE.make_serve_fns(cfg, scfg, device=device)
        tokens_per_call = global_batch * seq_len
    else:
        step = serve_step
        tokens_per_call = global_batch

    abs_caches = T.init_caches(cfg, global_batch, seq_len,
                               scfg.kv_cache_dtype, device="meta")
    cache_sh = shardings_of(abs_caches, T.cache_axes(
        cfg, quantized=CL.kv_quantized(scfg.kv_cache_dtype)))
    p_sh = shardings_of(abstract, T.lm_axes(cfg), key=_param_key)

    s_in = seq_len if kind == "prefill" else 1
    inputs, in_axes = {}, {}
    if cfg.frontend == "tokens":
        inputs["tokens"] = ((global_batch, s_in), torch.int32)
        in_axes["tokens"] = "act_batch,act_seq"
    else:
        inputs["embeds"] = ((global_batch, s_in, cfg.d_model),
                            torch.bfloat16)
        in_axes["embeds"] = "act_batch,act_seq,act_embed"
    if cfg.cross_attn:
        inputs["cond"] = ((global_batch, cfg.n_cond_tokens, cfg.d_model),
                          torch.bfloat16)
        in_axes["cond"] = "act_batch,,act_embed"
    in_sh = shardings_of(inputs, in_axes)
    logits_sh = SH.resolve_spec((global_batch, cfg.vocab_size),
                                "act_batch,act_vocab", mesh, rules)

    def build_args():
        return (_model_with(T.lm_abstract(cfg), build(abstract, p_sh), False),
                build(abs_caches, cache_sh), build(inputs, in_sh))

    def fn(params, caches, batch_inputs):
        with SH.activation_sharding(mesh, rules, op_fallbacks):
            return step(params, caches, batch_inputs)

    meta["model_flops"] = 2.0 * n_active * tokens_per_call
    meta["useful_bytes_per_device"] = (
        _total_bytes(abstract)
        + (2 if kind == "prefill" else 1) * _total_bytes(abs_caches)
        + _total_bytes(inputs)) // n_dev
    meta["state_bytes_per_device_actual"] = (
        _sharded_bytes(abstract, p_sh, mesh)
        + _sharded_bytes(abs_caches, cache_sh, mesh))
    return Cell(arch_id, shape_name, fn, build_args,
                (p_sh, cache_sh, in_sh), (logits_sh, cache_sh), cfg, meta,
                fallbacks, donate=(1,), op_fallbacks=op_fallbacks, mesh=mesh,
                fake_mode=fake_mode, kind=kind)


# ------------------------------------------------------------ real shards ----
def run(cell: Cell, args: tuple):
    """``cell.fn(*args)`` with plain tensors made inside the step (masks,
    positions) taken as replicated DTensors where they meet sharded ones."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        return cell.fn(*args)


def materialize(cell: Cell, *, seed: int = 0, device="cuda",
                whole: bool = False) -> tuple:
    """``cell.args`` as real tensors on ``device``: the same trees, each
    rank's shard of whole tensors drawn from ``seed`` (the same on every
    rank), or with ``whole`` the whole plain tensors (one device's run of
    the same step). Weights are the model's random init in the cell's
    dtypes; K/V cache rows random normal with every slot's index at
    ``seq_len - 1`` (the decode cell: the cache full, the new token at its
    last row); token inputs and labels uniform over the vocabulary; the
    optimizer state zero."""
    from repro_torch.weights import init_params
    mesh, cfg = cell.mesh, cell.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    wparams = dict(T.cast_param_dtype(init_params(cfg, gen, device=device),
                                      cfg).named_parameters())

    def fill(shape, dtype, path):
        name = path[-1] if path else ""
        if dtype.is_floating_point and name not in ("count", "step"):
            if cell.kind == "train" and path[0] == "opt":
                return torch.zeros(shape, dtype=dtype, device=device)
            return torch.randn(shape, generator=gen, device=device).to(dtype)
        if name == "index":
            return torch.full(shape, cell.meta["seq_len"] - 1, dtype=dtype,
                              device=device)
        if not shape:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=device, dtype=dtype)

    def make(shape, dtype, spec, path):
        t = fill(shape, dtype, path)
        return t if whole else _wrap(_shard_of(t, spec, mesh), spec, mesh)

    def build(args, specs, path=()):
        return _build(_shape_tree(args), specs, make, path)

    def model_of(p_specs, requires_grad):
        out = {n: wparams[n].detach().clone() for n in wparams}
        if not whole:
            out = {n: _wrap(_shard_of(t, p_specs[n], mesh), p_specs[n], mesh)
                   for n, t in out.items()}
        return _model_with(T.lm_abstract(cfg, device=device), out,
                           requires_grad)

    if cell.kind == "train":
        st_sh, b_sh = cell.in_shardings
        state = {"params": model_of(st_sh["params"], True)}
        for k, v in cell.args[0].items():
            if k != "params":
                state[k] = build(v, st_sh[k], (k,))
        return state, build(cell.args[1], b_sh)
    p_sh, cache_sh, in_sh = cell.in_shardings
    return (model_of(p_sh, False), build(cell.args[1], cache_sh),
            build(cell.args[2], in_sh))


def _shape_tree(tree):
    """The (whole shape, dtype) tree of a tree of fake (D)tensors."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)
