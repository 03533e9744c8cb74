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
checkpoints hold.

The mesh-only helpers (``state_axes``, ``abstract_state``,
``batch_specs``) wait for mesh training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_compress_grads
from repro_torch.weights import init_params, split_jax_tree, to_jax_params


def cross_entropy(logits, labels, *, z_weight: float = 1e-4):
    """logits: (b, s, V) any float dtype; labels: (b, s) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)
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
        logits, _, aux = T.lm_apply(model, cfg, remat=tcfg.remat,
                                    q_chunk=tcfg.q_chunk,
                                    kv_chunk=tcfg.kv_chunk, **kw)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_fns(cfg: ModelConfig, tcfg: TrainConfig, *, device=None,
                   generator: torch.Generator | None = None):
    """Returns (init_state, train_step). ``init_state(model=None)`` takes a
    starting ``LM`` or draws one from ``generator`` (default: seeded with
    ``tcfg.seed`` on ``device``, default cuda)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    lr_fn = adamw.warmup_cosine(tcfg)
    if tcfg.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"unknown grad_compression "
                         f"{tcfg.grad_compression!r}")

    def init_state(model: T.LM | None = None):
        if model is None:
            dev = resolve_device(device)
            gen = generator or torch.Generator(device=dev).manual_seed(
                tcfg.seed)
            model = init_params(cfg, gen, device=dev)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = {"params": model, "opt": adamw.adam_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        if tcfg.grad_compression == "int8_ef":
            state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in params.items()}
        return state

    def grads_of(model, params, batch):
        loss, m = loss_fn(model, batch)
        g = torch.autograd.grad(loss, list(params.values()))
        return (dict(zip(params, g)), loss.detach(),
                {k: v.detach() for k, v in m.items()})

    def compute_grads(model, params, batch):
        n = tcfg.microbatch
        if not (n and n > 1):
            return grads_of(model, params, batch)
        b = batch["labels"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatch {n}")
        g32 = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        lsum, msum = zero, {"ce": zero, "aux": zero}
        for i in range(n):
            mb = {k: v[i * (b // n):(i + 1) * (b // n)]
                  for k, v in batch.items()}
            g, l, m = grads_of(model, params, mb)
            g32 = {k: g32[k] + g[k].float() for k in g32}
            lsum = lsum + l
            msum = {k: msum[k] + v for k, v in m.items()}
        inv = 1.0 / n
        return ({k: v * inv for k, v in g32.items()}, lsum * inv,
                {k: v * inv for k, v in msum.items()})

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        grads, loss, metrics = compute_grads(model, params, batch)
        if tcfg.grad_compression == "int8_ef":
            grads, state["ef"] = ef_compress_grads(grads, state["ef"])
        lr = lr_fn(state["step"])
        om = adamw.adam_update(grads, state["opt"], params, lr=lr, tcfg=tcfg)
        state["step"] += 1
        return state, dict(metrics, loss=loss, lr=lr, **om)

    return init_state, train_step


def state_tree(state: dict, cfg: ModelConfig) -> dict:
    """The reference's state tree of ``state`` (numpy host copies)."""
    tree = {"params": to_jax_params(state["params"], cfg),
            "opt": {"m": to_jax_params(state["opt"]["m"], cfg),
                    "v": to_jax_params(state["opt"]["v"], cfg),
                    "count": np.asarray(int(state["opt"]["count"]),
                                        np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}
    if "ef" in state:
        tree["ef"] = to_jax_params(state["ef"], cfg)
    return tree


@torch.no_grad()
def load_state_tree(state: dict, tree: dict, cfg: ModelConfig):
    """Write a reference state tree (a restored checkpoint, either
    package's) into ``state``'s tensors, in place. The tree's leaves must be
    exactly the state's."""
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
            t.copy_(src[name])
    state["opt"]["count"].fill_(int(tree["opt"]["count"]))
    state["step"].fill_(int(tree["step"]))
