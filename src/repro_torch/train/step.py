"""Train-step factory — the reference's ``train/step.py``: the loss (cross
entropy with a z-loss), gradient accumulation over microbatches, int8
error-feedback compression and AdamW, on the reference's state and metric
names.

state = {"params": LM (requires_grad on), "opt": {"m", "v", "count"},
"step", and "ef" (the compression residuals) with ``int8_ef``}. ``m``,
``v`` and ``ef`` are dicts keyed by the ``LM``'s parameter names; ``count``
and ``step`` are 0-d int32 tensors. ``train_step`` updates the state in
place and returns it with 0-d tensor metrics ``ce``, ``aux`` (the MoE
load-balance loss, 0 without experts), ``loss`` (= ce + aux), ``lr`` and
``grad_norm``. A batch holds ``labels`` and ``tokens`` or, for the stub
vlm / audio frontends, ``embeds``; a cross-attention config adds ``cond``.

``state_tree`` / ``load_state_tree`` convert to and from the reference's
state tree (numpy, block leaves stacked on ``n_super``), the form
checkpoints hold, whatever the mesh: a sharded state is gathered whole
for a save (a collective: every rank calls it) and each rank takes its
shard of a restored tree, so a checkpoint saved on one world size
restores on another (elastic).

Data parallelism (``make_train_fns(mesh=...)``, a ``("data",)`` mesh):
each rank takes its rows of the global batch. With ``TrainConfig.fsdp``
(True / "full") the model's blocks and root are FSDP2 units
(``distributed/sharding.shard_model``): parameters, moments and
residuals are DTensors of this rank's first-axis shard, FSDP2 all-gathers
a unit for its forward and backward and reduce-scatters (averages) its
gradients; the optimizer updates the shards. Without it the parameters
stay replicated and the gradients are averaged by one flat all-reduce.
Either way the metrics are the global means, the gradient norm the
global one, and the update equals single-device training on the global
batch up to the regrouped sums of the gradient reduction.

``state_axes``, ``abstract_state`` and ``batch_specs`` are the
reference's helpers for its sharded ``jit`` (logical axes, abstract
shapes, batch specs); the port's dry run reads them
(``launch/specs.py``), the trainer none of them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import op_analysis as OA
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.comm import Comm
from repro_torch.models import transformer as T
from repro_torch.nn.scan import counted, signature
from repro_torch.optim import adamw
from repro_torch.optim.adamw import local
from repro_torch.optim.compression import ef_compress_grads
from repro_torch.weights import init_params, split_jax_tree, to_jax_params


def cross_entropy(logits, labels, *, z_weight: float = 1e-4):
    """logits: (b, s, V) any float dtype; labels: (b, s) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)
    # a vocab-sharded gather (the dry run's DTensors) settles here, at its
    # own shape: DTensor cannot reduce its pending mask through a view
    ll = SH.shard(ll, "act_batch,act_seq,")
    loss = (logz - ll[..., 0]).mean()
    if z_weight:
        loss = loss + z_weight * logz.square().mean()
    return loss


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_fn(model: T.LM, batch):
        kw = {}
        if cfg.frontend == "tokens":
            kw["tokens"] = batch["tokens"]
        else:
            kw["embeds"] = batch["embeds"]
        if cfg.cross_attn:
            kw["cond"] = batch["cond"]
        logits, _, aux = model(cfg, remat=tcfg.remat, q_chunk=tcfg.q_chunk,
                               kv_chunk=tcfg.kv_chunk, **kw)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def data_comm(mesh) -> Comm:
    """The counted collectives over ``mesh``'s one data axis."""
    axes = SH.dp_axes(mesh)
    if len(axes) != 1:
        raise ValueError(f"data-parallel training over one data axis; mesh "
                         f"{mesh} has {axes}")
    return Comm(mesh.get_group(axes[0]))


def _mean_over(comm: Comm, values: dict) -> dict:
    """0-d metrics averaged over the group, in one all-reduce."""
    keys = list(values)
    both = comm.all_reduce(torch.stack([values[k].float() for k in keys]))
    return dict(zip(keys, both / comm.size))


def _all_reduce_mean(comm: Comm, grads: dict) -> dict:
    """Replicated parameters: every gradient averaged over the group
    through one flat all-reduce."""
    flat = comm.all_reduce(torch.cat([g.float().reshape(-1)
                                      for g in grads.values()]))
    flat = flat / comm.size
    out, i = {}, 0
    for k, g in grads.items():
        out[k] = flat[i:i + g.numel()].reshape(g.shape).to(g.dtype)
        i += g.numel()
    return out


def _micro(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of batch leaf ``v``: its i-th block of
    rows. A DTensor batch (the dry run's, ``launch/specs.py``) splits each
    device's own rows, as data-parallel ranks accumulate over their local
    rows, so no microbatch crosses devices."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        m = loc.shape[0] // n
        return DTensor.from_local(loc[i * m:(i + 1) * m], v.device_mesh,
                                  v.placements, run_check=False)
    m = v.shape[0] // n
    return v[i * m:(i + 1) * m]


def _placed(grads: dict, params: dict) -> dict:
    """Each DTensor gradient in its parameter's placements: the
    reduce-scatter or all-reduce of a sharded step (the dry run's DTensor
    state); plain tensors as they are."""
    return {k: g.redistribute(params[k].device_mesh, params[k].placements)
            if isinstance(g, DTensor) and isinstance(params[k], DTensor)
            and g.placements != params[k].placements else g
            for k, g in grads.items()}


def make_train_fns(cfg: ModelConfig, tcfg: TrainConfig, *, device=None,
                   generator: torch.Generator | None = None, mesh=None):
    """Returns (init_state, train_step). ``init_state(model=None)`` takes a
    starting ``LM`` or draws one from ``generator`` (default: seeded with
    ``tcfg.seed`` on ``device``, default cuda). ``mesh``: a data-parallel
    DeviceMesh; ``train_step`` then takes this rank's rows of the batch
    (see the module docstring)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    lr_fn = adamw.warmup_cosine(tcfg)
    if tcfg.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")
    comm = None if mesh is None else data_comm(mesh)
    sharded = mesh is not None and SH.shards_params(tcfg.fsdp)
    shard_comm = comm if sharded else None

    def init_state(model: T.LM | None = None):
        if model is None:
            dev = resolve_device(device)
            gen = generator or torch.Generator(device=dev).manual_seed(
                tcfg.seed)
            model = init_params(cfg, gen, device=dev)
        model.requires_grad_(True)
        if sharded:
            SH.shard_model(model, mesh)
        params = dict(model.named_parameters())
        state = {"params": model, "opt": adamw.adam_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        if tcfg.grad_compression == "int8_ef":
            state["ef"] = {k: torch.zeros_like(p, dtype=torch.float32)
                           .detach() for k, p in params.items()}
        return state

    def grads_of(model, params, batch):
        loss, m = loss_fn(model, batch)
        if comm is None:
            g = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        else:
            # module hooks (FSDP2's reduce-scatter) run in backward() and
            # leave the gradients in .grad
            loss.backward()
            g = {}
            for k, p in params.items():
                g[k], p.grad = p.grad, None
        return (g, loss.detach(), {k: v.detach() for k, v in m.items()})

    def compute_grads(model, params, batch):
        n = tcfg.microbatch
        if not (n and n > 1):
            return grads_of(model, params, batch)
        b = batch["labels"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatch {n}")
        g32 = {k: torch.zeros_like(p, dtype=torch.float32).detach()
               for k, p in params.items()}
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        lsum, msum = zero, {"ce": zero, "aux": zero}
        i, prev, count = 0, None, counted(batch["labels"])
        while i < n:
            # the dry run traces microbatches until two start from alike
            # sums (nn/scan.signature), then one for the rest: the
            # reference scans the microbatches, its cost counts the body n
            # times
            sig = count and signature([*g32.values(), lsum,
                                       *msum.values()])
            k = n - i if count and sig == prev else 1
            with OA.repeated(k):
                mb = {key: _micro(v, i, n) for key, v in batch.items()}
                g, l, m = grads_of(model, params, mb)
                g32 = {key: g32[key] + g[key].float() for key in g32}
                lsum = lsum + l
                msum = {key: msum[key] + v for key, v in m.items()}
            prev, i = sig, i + k
        inv = 1.0 / n
        return ({k: v * inv for k, v in g32.items()}, lsum * inv,
                {k: v * inv for k, v in msum.items()})

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        grads, loss, metrics = compute_grads(model, params, batch)
        if comm is None:
            grads = _placed(grads, params)
        else:
            if not sharded:
                grads = _all_reduce_mean(comm, grads)
            both = _mean_over(comm, dict(metrics, loss=loss))
            loss = both.pop("loss")
            metrics = both
        if tcfg.grad_compression == "int8_ef":
            grads, new_ef = ef_compress_grads(grads, state["ef"], shard_comm)
            if comm is None:
                state["ef"] = new_ef
            else:           # in place: the residuals stay (D)tensors
                with torch.no_grad():
                    for k, t in state["ef"].items():
                        local(t).copy_(new_ef[k])
        lr = lr_fn(state["step"])
        om = adamw.adam_update(grads, state["opt"], params, lr=lr, tcfg=tcfg,
                               comm=shard_comm)
        state["step"] += 1
        return state, dict(metrics, loss=loss, lr=lr, **om)

    return init_state, train_step


def _whole(named: dict) -> dict:
    """{name: tensor} with every DTensor gathered whole (a collective)."""
    return {k: t.full_tensor() if isinstance(t, DTensor) else t
            for k, t in named.items()}


def _shard_of(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` for ``t``: FSDP2's first-axis chunk
    of a DTensor (``torch.chunk``, empty past the chunks there are), taken
    locally without a collective; ``full`` itself otherwise."""
    if not isinstance(t, DTensor):
        return full
    (placement,) = t.placements
    dim, mesh = placement.dim, t.device_mesh
    parts = torch.chunk(full, mesh.size(), dim=dim)
    r = mesh.get_local_rank()
    return parts[r] if r < len(parts) else full.narrow(dim, 0, 0)


@torch.no_grad()
def state_tree(state: dict, cfg: ModelConfig) -> dict:
    """The reference's state tree of ``state`` (numpy host copies). A
    sharded state is gathered whole: every rank of its mesh must call."""
    tree = {"params": to_jax_params(
                _whole(dict(state["params"].named_parameters())), cfg),
            "opt": {"m": to_jax_params(_whole(state["opt"]["m"]), cfg),
                    "v": to_jax_params(_whole(state["opt"]["v"]), cfg),
                    "count": np.asarray(int(state["opt"]["count"]),
                                        np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}
    if "ef" in state:
        tree["ef"] = to_jax_params(_whole(state["ef"]), cfg)
    return tree


@torch.no_grad()
def load_state_tree(state: dict, tree: dict, cfg: ModelConfig):
    """Write a reference state tree (a restored checkpoint, either
    package's, saved on any number of ranks) into ``state``'s tensors, in
    place; a sharded tensor takes its rank's part. The tree's leaves must
    be exactly the state's."""
    if set(tree) != set(state):
        raise ValueError(f"checkpoint holds {sorted(tree)}, the state "
                         f"{sorted(state)}")
    params = dict(state["params"].named_parameters())
    pairs = [(params, tree["params"]), (state["opt"]["m"], tree["opt"]["m"]),
             (state["opt"]["v"], tree["opt"]["v"])]
    if "ef" in state:
        pairs.append((state["ef"], tree["ef"]))
    for dst, src in pairs:
        src = split_jax_tree(src, cfg)
        if set(src) != set(dst):
            raise ValueError(f"checkpoint leaves {sorted(set(src) ^ set(dst))}"
                             f" do not match the model's")
        for name, t in dst.items():
            if src[name].shape != t.shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(src[name].shape)} != "
                                 f"{tuple(t.shape)}")
            local(t).copy_(_shard_of(src[name], t))
    state["opt"]["count"].fill_(int(tree["opt"]["count"]))
    state["step"].fill_(int(tree["step"]))


# ------------------------------------------- the reference's mesh helpers ----
def state_axes(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The logical axes of every state leaf, the reference's tree keyed
    by the port's parameter names: ``params`` and the moments (and ``ef``
    under ``int8_ef``) take ``T.lm_axes``, the counters ``""``. The dry
    run's rules resolve them (``launch/specs.py``); the trainer reads none
    of this (FSDP2 places its shards itself)."""
    pax = T.lm_axes(cfg)
    out = {"params": pax,
           "opt": {"m": dict(pax), "v": dict(pax), "count": ""},
           "step": ""}
    if tcfg.grad_compression == "int8_ef":
        out["ef"] = dict(pax)
    return out


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The training state built on the ``meta`` device: every leaf's shape
    and dtype, no storage (the reference's ``jax.eval_shape`` of its
    ``init_state``)."""
    init_state, _ = make_train_fns(cfg, tcfg, device="meta")
    return init_state(T.lm_abstract(cfg))


def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int):
    """(shape, dtype) of each leaf of one training batch, and its logical
    axes, as the reference's ``batch_specs`` (for XLA's sharded ``jit``;
    the port's trainer slices its rows of the global batch instead)."""
    b, s = global_batch, seq_len
    specs, axes = {}, {}
    if cfg.frontend == "tokens":
        specs["tokens"] = ((b, s), torch.int32)
        axes["tokens"] = "act_batch,act_seq"
    else:
        specs["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
        axes["embeds"] = "act_batch,act_seq,act_embed"
    if cfg.cross_attn:
        specs["cond"] = ((b, cfg.n_cond_tokens, cfg.d_model), torch.bfloat16)
        axes["cond"] = "act_batch,,act_embed"
    specs["labels"] = ((b, s), torch.int32)
    axes["labels"] = "act_batch,act_seq"
    return specs, axes
