"""Serving over per-slot contiguous KV caches or a shared page pool — the
reference's ``serve/engine.py``: ``make_serve_fns`` (the model steps),
``ServeSession`` (the static engine) and ``ContinuousBatchingEngine``.

``make_serve_fns`` returns the reference's four step functions:
``init_caches``, the whole-prompt ``prefill_step`` (through
``blockwise_attention``, then the cache fill), the one-token
``decode_step`` and the right-padded ``prefill_ragged`` (append-at-index
chunks). With ``ServeConfig.fused_sampling`` (the default) each step ends
in the sampling epilogue (``serve/sampling.sample_tokens``: greedy argmax,
or the reference's threefry draw with keys folded on the post-step cache
index) and returns ``(b,)`` tokens; without it the steps return the last
position's logits, as the reference's legacy signatures do, and the
callers sample outside the step through the same ``sample_tokens``.

``ServeSession`` runs a static batch in lockstep: one prefill (whole
prompts, or right-padded ragged prompts through ``prefill_ragged``), then
``steps - 1`` decode steps over all rows.

``ContinuousBatchingEngine`` holds a fixed pool of ``max_slots`` cache
slots. Each ``step``:

1. admits queued requests into free slots (FIFO, ``serve/scheduler``) and
   writes each one's ``SamplingParams`` into the slot's bank row,
2. runs at most one append-at-index prefill chunk per PREFILLING slot,
   bounded by ``prefill_budget`` tokens: always the one shape
   ``(1, prefill_chunk)``, pad rows zeroed before the cache write,
3. runs ONE masked one-token decode step over all ``max_slots`` rows
   (inactive rows keep their cache rows and index; their tokens are
   discarded),
4. samples inside the steps (fused), so only the ``(b,)`` token vector
   crosses to the host; or, with ``fused_sampling=False``, takes the
   logits out of the steps and samples the decoding rows after them.

``prefill_cache_size`` / ``decode_cache_size`` count the distinct (shape,
dtype) signatures of the tensors entering the prefill-chunk step and the
decode step: 1 each for an engine's lifetime, the reference's
one-compiled-shape rule.

ConSmax serving uses the merged constant C = e^{-beta}/gamma (Eq. 3).
``ServeConfig.decode_kernel`` / ``prefill_kernel`` route attention through
the ConSmax kernels (``kernels/consmax_decode``, ``kernels/consmax_prefill``)
— CUDA kernels on the card, their plain versions on the CPU. Softmax and
softermax configs serve through the plain online walks
(``core/attention``); the kernel flags refuse them.

With ``ServeConfig.paged_kv`` the per-slot rows become ONE shared
``(num_pages, page_size)`` page pool per layer, mapped through the host-side
``PagePool`` (``serve/scheduler``): reservation-gated admission, pages on
demand, release on finish, and a refcounted prefix cache — a request whose
prompt prefix sits in cached pages admits *warm* (its table row points at
the shared pages and its fill index starts past them), copy-on-write keeps
every write on a page the slot owns alone, and ``submit(..., n=K)`` streams
of one prompt share its pages. The device page table is re-uploaded only
when the pool's ``version`` changes.

``ServeConfig.kv_cache_dtype`` stores the caches as bfloat16, or as int8
/ fp8_e4m3 codes with one fp32 scale per row and KV head (quantized at
every cache write, dequantized block by block at every read, inside the
kernels as in the plain walks; ``kernels/cache_layout``).

The KV caches are updated in place; ``_finish`` zeroes a recycled
contiguous slot (a paged slot resets only its index).

Archs: the continuous engine serves what the reference's does, the
attention-only token archs (``attn`` / ``global`` / ``local`` and the MoE
``attn_moe`` blocks, ``_attention_only``); recurrent blocks (mamba, xLSTM)
and cross-attention stay on ``ServeSession``. ``ServeSession`` samples in
the steps when the arch has an attention cache to fold the keys on and a
token frontend; otherwise on the host, through the same code. As in the
reference, it generates from token frontends only and refuses ragged
prompts for archs with recurrent state.

Device mesh (``ServeConfig.tp`` / ``seq_shards``, ``distributed/
serve_mesh``): ``ContinuousBatchingEngine`` serves on its rank of a
``(tp, seq_shards)`` mesh, one process per rank, every rank running the
same host loop. It keeps its head slice of the parameters, a KV cache of
its KV heads (paged: a pool of its ``pages_per_shard`` pages), and
localizes the one global page table in each step; each attention block
ends in the mesh's combine (``distributed.comm.AttentionMesh``). Tokens
equal single-device serving's on every rank for requests within one seq
block. ``ServeSession`` refuses a mesh, as the reference's builds none.

Not ported (they raise): any ``ServeConfig`` field in ``_UNREAD`` set away
from its default, and the paged fields in ``_PAGED`` set without
``paged_kv``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.distributed import comm as COMM
from repro_torch.distributed import serve_mesh as SM
from repro_torch.kernels import cache_layout as CL
from repro_torch.models import transformer as T
from repro_torch.models.blocks import ATTN_KINDS
from repro_torch.serve import sampling as S
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import PagePool, Scheduler

# ServeConfig fields that mirror the reference but that nothing in the port
# reads; the engines refuse a config that sets one away from its default
# (q_chunk only in the continuous engine: the static one's whole-prompt
# prefill reads it)
_UNREAD = ("batch", "seq_shard_kv", "prefill_kv_block")
# read only by a paged engine: refused away from their defaults otherwise
_PAGED = ("page_size", "num_pages", "prefix_cache", "prefix_evict")


def _has_attention(cfg: ModelConfig) -> bool:
    return any(k in ATTN_KINDS for k in cfg.block_pattern)


def _attention_only(cfg: ModelConfig) -> bool:
    return all(k in ATTN_KINDS for k in cfg.block_pattern)


def _model_inputs(cfg: ModelConfig, batch_inputs: dict) -> dict:
    """``lm_apply``'s input arguments from a step's ``batch_inputs``:
    ``tokens`` or, for the stub frontends, ``embeds``; and ``cond`` for a
    cross-attention config."""
    kw = {}
    if cfg.frontend == "tokens":
        kw["tokens"] = batch_inputs["tokens"]
    else:
        kw["embeds"] = batch_inputs["embeds"]
    if cfg.cross_attn:
        kw["cond"] = batch_inputs["cond"]
    return kw


def _signature(tree) -> tuple:
    """The (shape, dtype) of every tensor in a nested dict / list / tuple,
    in order, with the tree's structure: what a tracing compiler would key
    its cache on."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    return (type(tree).__name__,)


def _refuse_unread(scfg: ServeConfig, refused, what: str):
    unread = [f.name for f in dataclasses.fields(scfg)
              if f.name in refused and getattr(scfg, f.name) != f.default]
    if unread:
        raise NotImplementedError(
            f"ServeConfig {unread}: the port's {what} does not read these "
            "(the Pallas prefill grid's KV block, the mesh's KV sharding, "
            "the batch knob no engine reads; the paged fields only with "
            "paged_kv=True); leave them at their defaults")


def _check_kernel_flags(cfg: ModelConfig, scfg: ServeConfig):
    for flag, name in ((scfg.decode_kernel, "decode_kernel"),
                       (scfg.prefill_kernel, "prefill_kernel")):
        if flag and cfg.score_norm != "consmax":
            raise ValueError(
                f"ServeConfig.{name}=True requires score_norm='consmax' "
                f"(got {cfg.score_norm!r} for {cfg.arch_id}): the "
                "serving kernels have no softmax/softermax path")


def make_serve_fns(cfg: ModelConfig, scfg: ServeConfig, *, device=None,
                   attn_mesh=None):
    """Returns (init_caches, prefill_step, decode_step, prefill_ragged), the
    reference's step functions on ``device`` (default cuda). Under a
    serving mesh, ``cfg`` is the rank's local config (``MeshPlan.
    cfg_local``), the steps take the rank's parameters and caches, and
    ``attn_mesh`` (``MeshPlan.attn``) is threaded to every attention block
    (the reference's ``psum_axes``).

    With ``scfg.fused_sampling`` (the default) every step takes a trailing
    ``sampling`` bank (``serve/sampling.bank_init`` / ``bank_of``) and
    returns ``(tokens (b,) int32, caches)``; the decode step takes
    ``batch_inputs["tokens"]`` as the (b,) last-token vector and returns
    the input token for rows whose ``active`` entry is False. With
    ``fused_sampling=False`` the steps return ``(logits (b, vocab),
    caches)``, decode tokens given as (b, 1) (or ``embeds`` (b, 1, d) for
    the stub frontends; a cross-attention config takes ``cond`` in every
    step). ``decode_step`` also takes an optional
    ``batch_inputs["page_table"]`` for paged caches. Each step runs under
    ``torch.no_grad``, updates the KV caches in place and returns the
    caches with the new recurrent state. Fused sampling needs a token
    frontend and an attention block (the sample positions come from its
    cache index): otherwise ValueError, as in the reference."""
    _check_kernel_flags(cfg, scfg)
    fused = scfg.fused_sampling
    if fused and cfg.frontend != "tokens":
        raise ValueError(
            f"ServeConfig.fused_sampling=True requires the token frontend "
            f"(got {cfg.frontend!r} for {cfg.arch_id}): the fused steps "
            "emit token ids. Pass fused_sampling=False for the logits-"
            "returning steps.")
    if fused and not _has_attention(cfg):
        raise ValueError(
            f"ServeConfig.fused_sampling=True requires at least one "
            f"attention block (got {cfg.block_pattern} for {cfg.arch_id}): "
            "the per-slot sample positions are derived from the attention "
            "cache index. Pass fused_sampling=False to sample host-side.")
    kv_dtype = CL.kv_cache_dtype(scfg.kv_cache_dtype)
    device = resolve_device(device)

    def init_caches(batch: int):
        return T.init_caches(cfg, batch, scfg.max_seq, kv_dtype,
                             device=device)

    def _epilogue(sampling):
        """Fused logits -> token tail: sample the last kept row with per-slot
        keys folded on the POST-step cache index (= prompt + generated so
        far, a pure function of the request's own stream)."""
        if not fused:
            return None

        def epi(logits, new_caches):
            return S.sample_tokens(logits[:, -1], sampling,
                                   T.cache_index(new_caches))
        return epi

    @torch.no_grad()
    def prefill_step(params, caches, batch_inputs, sampling=None):
        """Whole-prompt prefill into fresh caches; returns (first tokens |
        last-position logits, caches)."""
        kw = _model_inputs(cfg, batch_inputs)
        src = kw.get("tokens", kw.get("embeds"))
        s = src.shape[1]
        out, caches, _ = T.lm_apply(
            params, cfg, caches=caches, merged=True,
            positions=torch.arange(s, device=src.device)[None, :],
            logits_index=s - 1, logits_epilogue=_epilogue(sampling),
            q_chunk=scfg.q_chunk, kv_chunk=scfg.kv_chunk,
            attn_mesh=attn_mesh, **kw)
        return (out if fused else out[:, -1]), caches

    @torch.no_grad()
    def prefill_ragged(params, caches, batch_inputs, lengths, sampling=None):
        """Right-padded ragged batch prefill through the append-at-index
        path: pad K/V never enters the cache, each slot's index lands on its
        real length, and the output is taken at ``lengths - 1``."""
        out, caches, _ = T.lm_apply(
            params, cfg, caches=caches, merged=True, prefill_append=lengths,
            logits_index=lengths - 1, prefill_kernel=scfg.prefill_kernel,
            fill_bound=scfg.fill_bound, logits_epilogue=_epilogue(sampling),
            q_chunk=scfg.q_chunk, kv_chunk=scfg.kv_chunk, attn_mesh=attn_mesh,
            **_model_inputs(cfg, batch_inputs))
        return (out if fused else out[:, 0]), caches

    @torch.no_grad()
    def decode_step(params, caches, batch_inputs, sampling=None):
        """One-token decode. Fused: ``tokens`` (b,) -> the next (b,) tokens,
        rows where ``active`` is False passed through (their cache rows and
        index stay untouched). Legacy: ``tokens`` (b, 1) -> (b, vocab)
        logits."""
        toks = batch_inputs.get("tokens")
        if fused:
            batch_inputs = dict(batch_inputs, tokens=toks[:, None])
        index = T.cache_index(caches)
        out, caches, _ = T.lm_apply(
            params, cfg, caches=caches, merged=True,
            positions=None if index is None else index[:, None],
            decode_kernel=scfg.decode_kernel,
            decode_kv_block=scfg.decode_kv_block, fill_bound=scfg.fill_bound,
            decode_active=batch_inputs.get("active"),
            page_table=batch_inputs.get("page_table"),
            logits_epilogue=_epilogue(sampling), attn_mesh=attn_mesh,
            **_model_inputs(cfg, batch_inputs))
        if not fused:
            return out[:, -1], caches
        active = batch_inputs.get("active")
        if active is not None:
            out = torch.where(active, out, toks)
        return out, caches

    return init_caches, prefill_step, decode_step, prefill_ragged


class ServeSession:
    """Static-batch generation: every row prefills and decodes in lockstep,
    so the batch runs as long as its longest member (the reference's
    ``ServeSession``). Sampling runs fused in the steps or, with
    ``fused_sampling=False``, on the logits after each step, through the
    same ``serve/sampling`` code (the streams are identical); an arch with
    no attention block (xLSTM) or a stub frontend samples on the host
    whatever ``fused_sampling`` says, as in the reference.

    ``params`` is the port's ``LM``, already on ``device`` (default
    cuda)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: T.LM, *,
                 device=None):
        if scfg.paged_kv:
            raise NotImplementedError(
                "ServeSession is the static contiguous baseline; paged KV "
                "serving lives in ContinuousBatchingEngine")
        _check_kernel_flags(cfg, scfg)
        if scfg.tp > 1 or scfg.seq_shards > 1:
            raise NotImplementedError(
                "ServeSession serves on one device: the reference's session "
                "never builds a mesh (only ContinuousBatchingEngine calls "
                "plan_mesh); serve tp / seq_shards > 1 through "
                "ContinuousBatchingEngine")
        _refuse_unread(scfg, _UNREAD + _PAGED, "ServeSession")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, session on "
                             f"{self.device}: move them first")
        self.cfg, self.scfg = cfg, scfg
        self.params = params
        self.fused = (scfg.fused_sampling and cfg.frontend == "tokens"
                      and _has_attention(cfg))
        fns_scfg = (scfg if self.fused == scfg.fused_sampling
                    else dataclasses.replace(scfg, fused_sampling=False))
        (self._init_caches, self._prefill, self._decode,
         self._prefill_ragged) = make_serve_fns(cfg, fns_scfg,
                                                device=self.device)

    def generate(self, prompts, *, steps: int, sampling=None,
                 temperature: float = 0.0, seed: int = 0, cond=None,
                 lengths=None):
        """prompts: (b, s) int tokens. Returns (b, steps) int32 tokens.

        sampling: a ``SamplingParams`` (broadcast: row r draws from ``seed +
        r``) or a per-row sequence of them; ``None`` builds one from the
        legacy ``temperature`` / ``seed`` scalars (0 = greedy).
        cond: the (b, n_cond, d) conditioning stream of a cross-attention
        config, passed to every step.
        lengths: optional (b,) real prompt lengths of a right-padded ragged
        batch: prefill leaves pad rows out of the caches and each row
        decodes from its own position, so row r's output equals serving
        prompt r alone. Attention-only archs only: recurrent state would
        scan the pad tokens."""
        if steps < 1:
            raise ValueError(
                f"generate: steps must be >= 1, got {steps} — the prefill "
                "step always samples one token, so steps=0 cannot mean "
                "'no tokens'")
        prompts = torch.as_tensor(prompts, dtype=torch.int32,
                                  device=self.device)
        b, s = prompts.shape
        if sampling is None:
            sampling = SamplingParams(temperature=float(temperature),
                                      seed=seed)
        bank = S.bank_of(sampling, b, device=self.device)
        caches = self._init_caches(b)
        inputs = {"tokens": prompts}
        if cond is not None:
            inputs["cond"] = cond
        if self.cfg.frontend != "tokens":
            raise NotImplementedError("embedding-frontend generation")
        if lengths is not None:
            if not _attention_only(self.cfg):
                raise NotImplementedError(
                    "ragged generate(lengths=...) requires a pure-attention "
                    f"block pattern (got {self.cfg.block_pattern})")
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=self.device)
        if self.fused:
            return self._generate_fused(caches, inputs, bank, steps, cond,
                                        lengths)
        return self._generate_host(caches, inputs, bank, steps, s, cond,
                                   lengths)

    @staticmethod
    def _step_inputs(tok, cond):
        step_in = {"tokens": tok}
        if cond is not None:
            step_in["cond"] = cond
        return step_in

    def _generate_fused(self, caches, inputs, bank, steps, cond, lengths):
        """The steps emit (b,) tokens and the loop feeds them straight
        back."""
        if lengths is None:
            tok, caches = self._prefill(self.params, caches, inputs, bank)
        else:
            tok, caches = self._prefill_ragged(self.params, caches, inputs,
                                               lengths, bank)
        outs = [tok]
        for _ in range(steps - 1):
            tok, caches = self._decode(self.params, caches,
                                       self._step_inputs(tok, cond), bank)
            outs.append(tok)
        return torch.stack(outs, dim=1)

    def _generate_host(self, caches, inputs, bank, steps, s, cond, lengths):
        """Logits out of each step, sampled after it: row r at step t folds
        (seed_r, prompt_len_r + t), so the streams match the fused path."""
        b = bank["seed"].shape[0]
        if lengths is None:
            logits, caches = self._prefill(self.params, caches, inputs)
            pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        else:
            logits, caches = self._prefill_ragged(self.params, caches,
                                                  inputs, lengths)
            pos = lengths
        tok = S.sample_tokens(logits, bank, pos)
        outs = [tok]
        for _ in range(steps - 1):
            logits, caches = self._decode(
                self.params, caches, self._step_inputs(tok[:, None], cond))
            pos = pos + 1
            tok = S.sample_tokens(logits, bank, pos)
            outs.append(tok)
        return torch.stack(outs, dim=1)


class ContinuousBatchingEngine:
    """Slot-recycling serving engine: ``submit`` requests, then ``run``.

    ``params`` is the port's ``LM`` (``weights.init_params`` /
    ``weights.from_jax_params``); it must already live on ``device``
    (default cuda). With ``tp * seq_shards > 1`` the engine serves on this
    process's rank of the serving mesh, built over the initialized process
    group (``distributed/serve_mesh.plan_mesh``): ``params`` is the full
    model, of which it keeps the head slice."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: T.LM, *,
                 default_sampling: SamplingParams | None = None,
                 device=None):
        if cfg.frontend != "tokens":
            raise NotImplementedError("continuous batching: token frontends")
        if cfg.cross_attn or not _attention_only(cfg):
            raise NotImplementedError(
                "continuous batching requires a pure-attention block pattern "
                f"(got {cfg.block_pattern}, cross_attn={cfg.cross_attn})")
        _check_kernel_flags(cfg, scfg)
        _refuse_unread(scfg, _UNREAD + ("q_chunk",)
                       + (() if scfg.paged_kv else _PAGED), "engine")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine on "
                             f"{self.device}: move them first")
        self.cfg, self.scfg = cfg, scfg
        # the device-mesh plan: None at tp = seq_shards = 1 (the single-
        # device code paths, bit for bit); otherwise this rank's head slice
        # of the parameters, caches of its KV heads (and pages), and the
        # combine at the end of every attention block
        self.plan = plan = SM.plan_mesh(cfg, scfg, device=self.device)
        self.mcfg = mcfg = cfg if plan is None else plan.cfg_local
        self.params = params if plan is None else plan.shard_params(params)
        self._attn_mesh = None if plan is None else plan.attn
        self.fused = scfg.fused_sampling
        self.default_sampling = default_sampling
        self.paged = scfg.paged_kv
        if self.paged:
            # one shared pool of num_pages x page_size rows serves every
            # slot; the PagePool maps (slot, logical page) -> pool page
            # (per seq rank under sequence sharding: the device pool holds
            # this rank's pages_per_shard of them)
            self.pool = PagePool(scfg.num_pages, scfg.page_size,
                                 scfg.max_slots, scfg.max_pages_per_slot,
                                 prefix_cache=scfg.prefix_cache,
                                 evict=scfg.prefix_evict,
                                 seq_shards=scfg.seq_shards)
            self.scheduler = Scheduler(scfg.max_slots, scfg.max_seq,
                                       page_pool=self.pool)
            self.caches = T.init_paged_caches(
                mcfg, scfg.max_slots, self.pool.pages_per_shard,
                scfg.page_size, scfg.kv_cache_dtype, device=self.device)
        else:
            self.pool = None
            self.scheduler = Scheduler(scfg.max_slots, scfg.max_seq)
            self.caches = T.init_caches(mcfg, scfg.max_slots, scfg.max_seq,
                                        scfg.kv_cache_dtype,
                                        device=self.device)
        self._table_dev = None             # device page table, re-uploaded
        self._table_version = -1           # only when the pool mutates
        self.results: dict[int, list[int]] = {}
        self.prefilled_tokens = 0          # chunk tokens computed: warm
                                           # admissions skip cached rows
        self.ttft: dict[int, float] = {}   # uid -> seconds submit->1st token
        self._t_submit: dict[int, float] = {}
        self._submits = 0
        self._chunk = scfg.prefill_chunk
        self._budget = scfg.prefill_budget or self._chunk
        self.bank = S.bank_init(scfg.max_slots, device=self.device)
        self._last = torch.zeros((scfg.max_slots,), dtype=torch.int32,
                                 device=self.device)
        # model steps run (prefill chunks and decode steps) and the
        # collectives they ran, by kind: {kind: {"calls", "bytes"}}
        self.model_steps = 0
        self.collectives = {kind: {"calls": 0, "bytes": 0}
                            for kind in COMM.KINDS}
        # (shape, dtype) signatures seen entering each step, and the warm-
        # admission index pin and copy-on-write page copy (paged engines)
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()
        self._set_index_shapes: set = set()
        self._copy_page_shapes: set = set()
        # slots whose request samples (temperature > 0), kept on the host at
        # admission and finish: the fused steps learn from it whether to
        # draw, with no device read of the bank
        self._sampled_slots: set = set()

    def _lm(self, tokens, caches, **kw):
        """One engine step through ``lm_apply``: (out, caches); the MoE aux
        loss is not served. Counts the step and, under a mesh, adds the
        collectives it ran to ``collectives``."""
        s = self.scfg
        before = COMM.counts()
        out, caches, _ = T.lm_apply(
            self.params, self.mcfg, tokens=tokens, caches=caches,
            merged=True, kv_chunk=s.kv_chunk, decode_kernel=s.decode_kernel,
            decode_kv_block=s.decode_kv_block,
            prefill_kernel=s.prefill_kernel, fill_bound=s.fill_bound,
            attn_mesh=self._attn_mesh, **kw)
        self.model_steps += 1
        for kind, c in COMM.counts().items():
            for key in c:
                self.collectives[kind][key] += c[key] - before[kind][key]
        return out, caches

    # --------------------------------------------------------- frontend ----
    def submit(self, prompt, max_new_tokens: int, eos_id: int | None = None,
               sampling: SamplingParams | None = None,
               n: int = 1) -> int | list[int]:
        """Queue a request; returns its uid (key into ``results``).

        ``sampling`` defaults to the engine's ``default_sampling``, a
        policy: request k (in submit order) draws from ``seed + k``. An
        explicit ``sampling`` pins the stream; greedy when both are None.

        ``n > 1`` queues n streams of the same prompt and returns their
        uids. On a paged engine with the prefix cache they share the
        prompt's pages: a stream admitted after the first has registered
        them prefills only the uncached rest (at least the 1-token tail
        re-score), copy-on-write keeping each stream's rows private."""
        if n < 1:
            raise ValueError(f"submit: n must be >= 1, got {n}")
        if n == 1:
            return self._submit_one(prompt, max_new_tokens, eos_id, sampling)
        uids = []
        for i in range(n):
            sp = sampling
            if sp is not None and i:       # stream i draws from seed + i
                sp = dataclasses.replace(sp, seed=(sp.seed + i) % 2**32)
            uids.append(self._submit_one(prompt, max_new_tokens, eos_id, sp))
        return uids

    def _submit_one(self, prompt, max_new_tokens, eos_id, sampling) -> int:
        sp = sampling
        if sp is None and self.default_sampling is not None:
            sp = dataclasses.replace(
                self.default_sampling,
                seed=(self.default_sampling.seed + self._submits) % 2**32)
        self._submits += 1
        uid = self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                    sampling=sp)
        self._t_submit[uid] = time.perf_counter()
        return uid

    def run(self, max_steps: int | None = None) -> dict[int, list[int]]:
        """Drive admissions + decode until the queue and slots drain;
        ``max_steps`` bounds this call's iterations."""
        iters = 0
        while self.scheduler.has_work():
            if max_steps is not None and iters >= max_steps:
                break
            self.step()
            iters += 1
        return self.results

    @torch.no_grad()
    def step(self):
        """One engine iteration: admit, prefill up to the token budget, then
        one shared decode step for the DECODING slots."""
        while True:
            admitted = self.scheduler.admit()
            if admitted is None:
                break
            slot, req = admitted
            S.bank_put(self.bank, slot, req.sampling)
            if req.sampling is not None and req.sampling.temperature > 0:
                self._sampled_slots.add(slot)
            filled = self.scheduler.slots[slot].filled
            if self.paged and filled:
                # warm admission: the slot's table row maps cached pages
                # holding rows [0, filled); the first chunk appends past them
                self._set_index_shapes.add(_signature((self.caches, slot,
                                                       filled)))
                T.set_slot_index(self.caches, slot, filled)
        plan = self.scheduler.prefill_plan(self._chunk, self._budget)
        for slot, start, n in plan:
            self._prefill_one(slot, start, n)
        if self.scheduler.decoding():
            self._decode_once()

    @property
    def prefill_cache_size(self) -> int:
        """Distinct (shape, dtype) signatures that entered the prefill-chunk
        step so far: 1 for the engine's lifetime (the reference's compiled
        prefill variants)."""
        return len(self._prefill_shapes)

    @property
    def decode_cache_size(self) -> int:
        """Distinct signatures that entered the decode step so far: 1 for
        the lifetime (the page table and the sampling bank are values,
        never shapes)."""
        return len(self._decode_shapes)

    @property
    def set_index_cache_size(self) -> int:
        """Distinct signatures of the warm-admission index pin (paged
        engines): 1 once a warm request was admitted, 0 before."""
        return len(self._set_index_shapes)

    @property
    def copy_page_cache_size(self) -> int:
        """Distinct signatures of the copy-on-write page copy (paged
        engines): 1 once a page was copied, 0 before."""
        return len(self._copy_page_shapes)

    @property
    def page_occupancy(self) -> float:
        """Fraction of pool pages currently mapped (paged engines only)."""
        return self.pool.occupancy() if self.pool is not None else 0.0

    @property
    def page_reserved(self) -> float:
        """Fraction of pool pages committed by live reservations, mapped or
        not (paged engines only): ``page_reserved - page_occupancy`` is the
        admission pressure ``page_occupancy`` cannot see."""
        return (self.pool.reserved_fraction() if self.pool is not None
                else 0.0)

    # ---------------------------------------------------------- internals ----
    def _device_table(self):
        """The pool's page table on the device, re-uploaded only when the
        allocator mapped or released pages (``PagePool.version``): decode
        steps between mutations reuse it, with no host transfer. The upload
        goes through pinned memory without blocking the host."""
        if self._table_version != self.pool.version:
            table = torch.from_numpy(self.pool.table.copy())
            if self.device.type == "cuda":
                table = table.pin_memory()
            self._table_dev = table.to(self.device, non_blocking=True)
            self._table_version = self.pool.version
        return self._table_dev

    def _step_table(self, rows: slice):
        """The page table rows a step reads: the global table's, localized
        on the device under sequence sharding (this rank's pages become
        local pool indices, the others -1), as the reference does in its
        step."""
        table = self._device_table()[rows]
        if self.scfg.seq_shards > 1:
            table = CL.localize_page_table(table, self.plan.seq_rank,
                                           self.pool.pages_per_shard)
        return table

    def _write_window(self, slot: int, start: int, stop: int):
        """Back rows [0, stop) of a paged slot and copy-on-write every page
        of [start, stop) it still shares, before anything writes there."""
        _, copies = self.pool.ensure_writable(slot, start, stop)
        pps = self.pool.pages_per_shard
        for src, dst in copies:
            # a copy stays on one seq rank (the replacement page backs the
            # same slot position); the rank owning it copies in its pool
            if self.pool.page_shard(src) == self.pool.page_shard(dst) == (
                    self.plan.seq_rank if self.scfg.seq_shards > 1 else 0):
                off = self.pool.page_shard(src) * pps
                self._copy_page_shapes.add(_signature((self.caches, src - off,
                                                       dst - off)))
                T.copy_kv_page(self.caches, src - off, dst - off)

    def _prefill_one(self, slot: int, start: int, n: int):
        prompt = self.scheduler.slots[slot].request.prompt
        chunk = prompt[start:start + n] + [0] * (self._chunk - n)
        kw = {}
        if self.paged:
            # a fully cached prompt's 1-token tail re-score lands in its
            # shared last page: that page is copied before this chunk writes
            self._write_window(slot, start, start + n)
            kw["page_table"] = self._step_table(slice(slot, slot + 1))
        slot_caches = T.slot_view(self.caches, slot, paged=self.paged)
        tokens = torch.tensor([chunk], dtype=torch.int32, device=self.device)
        lengths = torch.tensor([n], dtype=torch.int32, device=self.device)
        row = (S.bank_take(self.bank, slice(slot, slot + 1)) if self.fused
               else None)
        self._prefill_shapes.add(_signature((slot_caches, tokens, lengths,
                                             row, kw.get("page_table"))))
        epi = None
        if self.fused:
            sampled = slot in self._sampled_slots

            def epi(logits, new_caches):
                return S.sample_tokens(logits[:, -1], row,
                                       T.cache_index(new_caches),
                                       any_sampled=sampled)

        out, slot_caches = self._lm(tokens, slot_caches,
                                    prefill_append=lengths,
                                    logits_index=n - 1, logits_epilogue=epi,
                                    **kw)
        T.write_slot_index(self.caches, slot_caches, slot)
        self.prefilled_tokens += n
        done = self.scheduler.record_prefill(slot, n)
        if self.paged:
            # register the prompt pages this chunk completed, so later
            # requests with the same prefix admit warm
            self.pool.commit_prefix(slot, prompt,
                                    self.scheduler.slots[slot].filled)
        if done:
            # prompt complete: this chunk's token is the request's first
            # (sampled in the step when fused; from its logits otherwise,
            # at the same position: the slot's fill)
            if self.fused:
                tok = int(out[0])
                self._last[slot] = tok
            else:
                filled = self.scheduler.slots[slot].filled
                tok = int(S.sample_tokens(
                    out[:, 0], S.bank_take(self.bank, slice(slot, slot + 1)),
                    torch.tensor([filled], dtype=torch.int32,
                                 device=self.device))[0])
            uid = self.scheduler.slots[slot].request.uid
            if uid in self._t_submit:
                self.ttft[uid] = time.perf_counter() - self._t_submit.pop(uid)
            if self.scheduler.record(slot, tok):
                self._finish(slot)

    def _decode_once(self):
        decoding = self.scheduler.decoding()
        active = np.zeros((self.scfg.max_slots,), bool)
        kw = {}
        for slot, state in decoding:
            active[slot] = True
            if self.paged:
                # this step writes the last token's row: a page the slot
                # owns alone (prefill privatized the shared tail already,
                # so this never copies; the invariant is enforced, not
                # assumed)
                rows = state.filled + len(state.generated)
                self._write_window(slot, rows - 1, rows)
        if self.paged:
            kw["page_table"] = self._step_table(slice(None))
        active = torch.from_numpy(active).to(self.device)
        index = T.cache_index(self.caches)
        if self.fused:
            # device-side feedback: last tokens in, next tokens out; only
            # the (max_slots,) token vector reaches the host
            tokens, bank = self._last[:, None], self.bank
            sampled = any(slot in self._sampled_slots
                          for slot, _ in decoding)

            def epi(logits, new_caches):
                return S.sample_tokens(logits[:, -1], bank,
                                       T.cache_index(new_caches),
                                       any_sampled=sampled)
        else:
            # the A/B baseline: (max_slots, vocab) logits out of the step,
            # the decoding rows sampled after it through the same schedule
            toks = np.zeros((self.scfg.max_slots, 1), np.int32)
            for slot, state in decoding:
                toks[slot, 0] = state.last_token
            tokens = torch.from_numpy(toks).to(self.device)
            bank = epi = None
        self._decode_shapes.add(_signature((self.caches, tokens, active, bank,
                                            kw.get("page_table"))))
        out, self.caches = self._lm(
            tokens, self.caches, positions=index[:, None],
            decode_active=active, logits_epilogue=epi, **kw)
        if self.fused:
            self._last = torch.where(active, out, self._last)
            sampled = self._last.cpu().numpy()
        else:
            rows = [slot for slot, _ in decoding]
            pos = torch.tensor([st.filled + len(st.generated)
                                for _, st in decoding], dtype=torch.int32,
                               device=self.device)
            drawn = S.sample_tokens(out[rows, -1],
                                    S.bank_take(self.bank, rows), pos)
            sampled = np.zeros((self.scfg.max_slots,), np.int32)
            sampled[rows] = drawn.cpu().numpy()
        for slot, _ in decoding:
            if self.scheduler.record(slot, int(sampled[slot])):
                self._finish(slot)

    def _finish(self, slot: int):
        self._sampled_slots.discard(slot)
        uid, generated = self.scheduler.finish(slot)
        self.results[uid] = generated
        (T.reset_slot_paged if self.paged else T.reset_slot)(self.caches,
                                                              slot)
