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
``steps - 1`` decode steps over all rows. It keeps, per batch size, one
cache tree and fixed decode inputs (the last tokens, the sampling bank,
``cond``), reset in place by each ``generate``; the decode step reads and
writes only those tensors (``models/transformer.store_state``), so on one
CUDA device it is captured once per (batch size, argmax | draw | logits)
as a CUDA graph and replayed, as the reference jits it. The prefill stays
eager: its shape follows the prompt.

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

The two model steps are static, as the reference's ``jax.jit`` steps
are: each reads its inputs from fixed device buffers allocated at
construction (prefill: the slot, the chunk's length and its tokens;
decode: the active mask, and the tokens in logits mode; both: the page
table), which the host fills through pinned staging buffers with one
non-blocking copy per step. The slot, lengths, page row and sampling-bank
row are device values, never addresses or Python ints, and every cache
leaf (``index`` included) is updated in place, so a step runs the same
program on the same tensors every time. On one CUDA device each step is
captured once as a CUDA graph at its first use (after one eager run on a
side stream, which builds the kernels) and replayed from then on: one
graph per (step, argmax | draw) with fused sampling, one per step in
logits mode, all in one memory pool, whatever the score norm and the
kernel flags: the plain walks read no fill on the host, and in a graph
each of their blocks is a conditional node on the bound the device
computes (``core/attention._walk_blocks``, ``kernels/graph_cond``), so a
replay walks only the filled blocks, as the reference's ``fori_loop``
does. A capture that fails raises; nothing falls back to eager. Eager,
by construction: the CPU, a mesh, or ``cuda_graphs=False``. Admission,
the scheduler, copy-on-write page copies, index pins and slot resets, the
token drain and logits-mode sampling stay on the host, between steps.

``prefill_cache_size`` / ``decode_cache_size`` count the distinct (shape,
dtype) signatures of the tensors entering the prefill-chunk step and the
decode step: 1 each for an engine's lifetime, the reference's
one-compiled-shape rule; ``prefill_graphs`` / ``decode_graphs`` count the
captured graphs (at most 2 each, 0 when eager).

ConSmax serving uses the merged constant C = e^{-beta}/gamma (Eq. 3).
``ServeConfig.decode_kernel`` / ``prefill_kernel`` route attention through
the ConSmax kernels (``kernels/consmax_decode``, ``kernels/consmax_prefill``)
— CUDA kernels on the card, their plain versions on the CPU — with
``decode_kv_block`` / ``prefill_kv_block`` as their KV shard sizes (every
rank of a mesh launches on its head slice with the same sizes). Softmax and
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
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.distributed import comm as COMM
from repro_torch.distributed import serve_mesh as SM
from repro_torch.kernels import _build
from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels.graph_cond import ops as graph_cond
from repro_torch.models import transformer as T
from repro_torch.models.blocks import ATTN_KINDS
from repro_torch.serve import sampling as S
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import PagePool, Scheduler

# ServeConfig fields that mirror the reference but that nothing in the port
# reads; the engines refuse a config that sets one away from its default
# (q_chunk only in the continuous engine: the static one's whole-prompt
# prefill reads it)
_UNREAD = ("batch", "seq_shard_kv")
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
            "(the mesh's KV sharding, the batch knob no engine reads; "
            "the paged fields only with "
            "paged_kv=True); leave them at their defaults")


def _check_kernel_flags(cfg: ModelConfig, scfg: ServeConfig):
    for flag, name in ((scfg.decode_kernel, "decode_kernel"),
                       (scfg.prefill_kernel, "prefill_kernel")):
        if flag and cfg.score_norm != "consmax":
            raise ValueError(
                f"ServeConfig.{name}=True requires score_norm='consmax' "
                f"(got {cfg.score_norm!r} for {cfg.arch_id}): the "
                "serving kernels have no softmax/softermax path")


class _Staged:
    """A step's fixed int32 device input buffer and the pinned host buffers
    that fill it: ``put(fill)`` lets ``fill`` write a host buffer (as a
    numpy array) and issues one non-blocking copy of it into ``dev``. Two
    host buffers take turns, and one is rewritten only once its last copy
    has landed (its event), so a step's inputs are never overwritten in
    flight, and the host fills the next while the last copy runs."""

    def __init__(self, shape, device):
        self.dev = torch.zeros(shape, dtype=torch.int32, device=device)
        self._cuda = device.type == "cuda"
        self._host = [torch.zeros(shape, dtype=torch.int32,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._landed = [torch.cuda.Event() if self._cuda else None
                        for _ in range(2)]
        self._turn = 0

    def put(self, fill):
        i = self._turn
        self._turn = 1 - i
        if self._cuda:
            self._landed[i].synchronize()    # a no-op before its first copy
        fill(self._host[i].numpy())
        self.dev.copy_(self._host[i], non_blocking=self._cuda)
        if self._cuda:
            self._landed[i].record(torch.cuda.current_stream(self.dev.device))


@dataclass
class _StepGraph:
    """One captured step: its CUDA graph, the output its replays write, the
    kernels' ticket buffer its launches read (held while the graph may
    replay), the capture's seconds, the reserved bytes it added, and the
    graph's top-level nodes and conditional nodes (the plain walks' blocks,
    ``kernels/graph_cond``)."""
    graph: object
    out: object
    tickets: object
    seconds: float
    pool_bytes: int
    nodes: int
    conditional: int

    def replay(self):
        self.graph.replay()
        return self.out


class _Graphs:
    """Steps captured as CUDA graphs at their first use and replayed from
    then on, by key, all in one memory pool; the run before each capture,
    and the capture, go on one side stream (the decode kernel's shard
    tickets are per stream)."""

    def __init__(self, device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.steps: dict = {}
        self.replays = 0

    def run(self, key, fn):
        """``fn()``'s output: a replay of ``key``'s graph, or, at its first
        use, ``fn()`` run eagerly and then captured."""
        graph = self.steps.get(key)
        if graph is not None:
            self.replays += 1
            return graph.replay()
        out, self.steps[key] = self._capture(fn)
        return out

    def _capture(self, fn):
        """Run ``fn()`` once eagerly on the side stream (this is the step's
        real run: it builds and loads the kernels, makes the cuBLAS handles
        and the parameters' compute-dtype copies; its plain walks sweep
        every block, so every block's ops are warm), then capture it into a
        graph in the pool (``graph_cond.graph``: each plain-walk block an IF
        node on the device's bound). Returns (the eager run's output, the
        ``_StepGraph``). A failed capture, or a host sync inside it,
        raises."""
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            out = fn()
        cur.wait_stream(self.side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with graph_cond.graph(pool=self.pool, stream=self.side) as cap:
            static = fn()
        seconds = time.perf_counter() - t0
        tickets = _build.stream_tickets(self.side.device,
                                        self.side.cuda_stream)
        return out, _StepGraph(cap.graph, static, tickets, seconds,
                               torch.cuda.memory_reserved(self.device)
                               - reserved, cap.nodes, cap.conditional)

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.steps.values())

    @property
    def nodes(self) -> dict:
        """(top-level nodes, conditional nodes) of each captured graph, by
        key."""
        return {key: (g.nodes, g.conditional)
                for key, g in self.steps.items()}


def _tree_bytes(caches) -> int:
    """Bytes of every leaf of a cache tree."""
    return sum(t.numel() * t.element_size() for sup in caches
               for blk in sup.values() for c in blk.values()
               for t in c.values())


def _draws(sampling) -> bool:
    """Whether a row of ``sampling`` (one ``SamplingParams`` or a per-row
    sequence, as ``bank_of`` takes it) samples, from the host's values: a
    step's ``any_sampled``, with no read of the bank."""
    if sampling is None or isinstance(sampling, SamplingParams):
        sampling = [sampling or S.GREEDY]
    return any(sp.temperature > 0 for sp in sampling)


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
    caches with the new recurrent state. A fused step's ``any_sampled``
    (keyword) is the caller's host-side answer to whether a row samples
    (``sample_tokens``): given, the step reads nothing back to the host;
    left None, the epilogue reads the bank. Fused sampling needs a token
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

    def _epilogue(sampling, any_sampled):
        """Fused logits -> token tail: sample the last kept row with per-slot
        keys folded on the POST-step cache index (= prompt + generated so
        far, a pure function of the request's own stream)."""
        if not fused:
            return None

        def epi(logits, new_caches):
            return S.sample_tokens(logits[:, -1], sampling,
                                   T.cache_index(new_caches),
                                   any_sampled=any_sampled)
        return epi

    @torch.no_grad()
    def prefill_step(params, caches, batch_inputs, sampling=None, *,
                     any_sampled=None):
        """Whole-prompt prefill into fresh caches; returns (first tokens |
        last-position logits, caches)."""
        kw = _model_inputs(cfg, batch_inputs)
        src = kw.get("tokens", kw.get("embeds"))
        s = src.shape[1]
        out, caches, _ = T.lm_apply(
            params, cfg, caches=caches, merged=True,
            positions=torch.arange(s, device=src.device)[None, :],
            logits_index=s - 1,
            logits_epilogue=_epilogue(sampling, any_sampled),
            q_chunk=scfg.q_chunk, kv_chunk=scfg.kv_chunk,
            attn_mesh=attn_mesh, **kw)
        return (out if fused else out[:, -1]), caches

    @torch.no_grad()
    def prefill_ragged(params, caches, batch_inputs, lengths, sampling=None,
                       *, any_sampled=None):
        """Right-padded ragged batch prefill through the append-at-index
        path: pad K/V never enters the cache, each slot's index lands on its
        real length, and the output is taken at ``lengths - 1``."""
        out, caches, _ = T.lm_apply(
            params, cfg, caches=caches, merged=True, prefill_append=lengths,
            logits_index=lengths - 1, prefill_kernel=scfg.prefill_kernel,
            prefill_kv_block=scfg.prefill_kv_block,
            fill_bound=scfg.fill_bound,
            logits_epilogue=_epilogue(sampling, any_sampled),
            q_chunk=scfg.q_chunk, kv_chunk=scfg.kv_chunk, attn_mesh=attn_mesh,
            **_model_inputs(cfg, batch_inputs))
        return (out if fused else out[:, 0]), caches

    @torch.no_grad()
    def decode_step(params, caches, batch_inputs, sampling=None, *,
                    any_sampled=None):
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
            logits_epilogue=_epilogue(sampling, any_sampled),
            attn_mesh=attn_mesh, **_model_inputs(cfg, batch_inputs))
        if not fused:
            return out[:, -1], caches
        active = batch_inputs.get("active")
        if active is not None:
            out = torch.where(active, out, toks)
        return out, caches

    return init_caches, prefill_step, decode_step, prefill_ragged


@dataclass
class _Held:
    """A batch shape's fixed tensors: its cache tree (``init_caches``,
    made once) and the decode step's inputs: the last tokens ((b,) fused,
    (b, 1) in logits mode), the sampling bank and ``cond`` (None without
    one)."""
    caches: list
    tok: torch.Tensor
    bank: dict
    cond: torch.Tensor | None


class ServeSession:
    """Static-batch generation: every row prefills and decodes in lockstep,
    so the batch runs as long as its longest member (the reference's
    ``ServeSession``). Sampling runs fused in the steps or, with
    ``fused_sampling=False``, on the logits after each step, through the
    same ``serve/sampling`` code (the streams are identical); an arch with
    no attention block (xLSTM) or a stub frontend samples on the host
    whatever ``fused_sampling`` says, as in the reference.

    ``params`` is the port's ``LM``, already on ``device`` (default
    cuda).

    The session keeps one ``_Held`` per batch shape (b, and ``cond``'s
    shape), made at its first ``generate`` and reset in place by each
    later one. The decode step reads and writes only those tensors, so
    ``graphed`` (one CUDA device, unless ``cuda_graphs=False``) replays it
    as a CUDA graph, captured at its first use per (batch shape, argmax |
    draw | logits): argmax or draw from the host's ``SamplingParams``,
    logits when sampling runs after the step. A capture that fails
    raises. The prefill runs eagerly into the held tree."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: T.LM, *,
                 device=None, cuda_graphs: bool = True):
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
        self._held: dict = {}
        self.graphed = bool(cuda_graphs and self.device.type == "cuda")
        self._graphs = _Graphs(self.device) if self.graphed else None
        self.decode_steps = 0              # decode steps run, any mode

    # ------------------------------------------------------- counters ----
    @property
    def decode_graphs(self) -> int:
        """Decode step graphs captured so far: at most one per (batch
        shape, mode); 0 when eager."""
        return len(self._graphs.steps) if self.graphed else 0

    @property
    def graph_replays(self) -> int:
        return self._graphs.replays if self.graphed else 0

    @property
    def graph_pool_bytes(self) -> int:
        """Reserved device bytes the captures took."""
        return self._graphs.pool_bytes if self.graphed else 0

    @property
    def capture_seconds(self) -> dict:
        """Host seconds of each graph's capture, by (b, mode)."""
        if not self.graphed:
            return {}
        return {(key[0], mode): g.seconds
                for (key, mode), g in self._graphs.steps.items()}

    @property
    def graph_nodes(self) -> dict:
        """(top-level nodes, conditional nodes) of each captured graph, by
        (b, mode)."""
        if not self.graphed:
            return {}
        return {(key[0], mode): n for (key, mode), n in
                self._graphs.nodes.items()}

    def graph_pool_bytes_of(self, b: int) -> int:
        """Reserved bytes the captures of batch size ``b`` took."""
        if not self.graphed:
            return 0
        return sum(g.pool_bytes for (key, _), g in self._graphs.steps.items()
                   if key[0] == b)

    @property
    def held_cache_bytes(self) -> dict:
        """{b: bytes of the cache trees held for batch size b}."""
        out: dict = {}
        for (b, _), held in self._held.items():
            out[b] = out.get(b, 0) + _tree_bytes(held.caches)
        return out

    # --------------------------------------------------------- generate ----
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
        if self.cfg.frontend != "tokens":
            raise NotImplementedError("embedding-frontend generation")
        if lengths is not None:
            if not _attention_only(self.cfg):
                raise NotImplementedError(
                    "ragged generate(lengths=...) requires a pure-attention "
                    f"block pattern (got {self.cfg.block_pattern})")
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=self.device)
        key, held = self._hold(b, cond)
        # a fresh session's state, in the held tensors
        T.reset_caches(held.caches)
        for name, t in bank.items():
            held.bank[name].copy_(t)
        inputs = {"tokens": prompts}
        if cond is not None:
            held.cond.copy_(cond)
            inputs["cond"] = held.cond
        draw = _draws(sampling)
        if self.fused:
            return self._generate_fused(key, held, inputs, steps, lengths,
                                        draw)
        return self._generate_host(key, held, inputs, steps, s, lengths,
                                   draw)

    def _hold(self, b: int, cond):
        """The ``_Held`` of batch size ``b`` (and ``cond``'s shape), made
        at its first use."""
        key = (b, None if cond is None else (tuple(cond.shape), cond.dtype))
        held = self._held.get(key)
        if held is None:
            held = _Held(
                self._init_caches(b),
                torch.zeros((b,) if self.fused else (b, 1),
                            dtype=torch.int32, device=self.device),
                S.bank_init(b, device=self.device),
                None if cond is None else torch.empty(
                    cond.shape, dtype=cond.dtype, device=self.device))
            self._held[key] = held
        return key, held

    def _decode_step(self, held: _Held, draw: bool):
        """The one-token decode over ``held``'s fixed tensors: the last
        tokens in, every cache leaf updated in place. Fused: the next
        tokens written into ``held.tok`` (the next step's input), which it
        returns; logits mode: the (b, vocab) logits."""
        inputs = {"tokens": held.tok}
        if held.cond is not None:
            inputs["cond"] = held.cond
        if not self.fused:
            logits, new = self._decode(self.params, held.caches, inputs)
            T.store_state(held.caches, new)
            return logits
        tok, new = self._decode(self.params, held.caches, inputs, held.bank,
                                any_sampled=draw)
        T.store_state(held.caches, new)
        held.tok.copy_(tok)
        return held.tok

    def _decode_once(self, key, held: _Held, draw: bool):
        """One decode step: eagerly, or a replay of its graph (captured at
        its first use per (batch shape, mode))."""
        self.decode_steps += 1
        if not self.graphed:
            return self._decode_step(held, draw)
        mode = ("logits" if not self.fused else "draw" if draw
                else "argmax")
        return self._graphs.run((key, mode),
                                lambda: self._decode_step(held, draw))

    def _generate_fused(self, key, held, inputs, steps, lengths, draw):
        """The steps emit (b,) tokens; each decode step's tokens stay in
        ``held.tok`` as the next one's input, and the loop keeps a copy."""
        if lengths is None:
            tok, new = self._prefill(self.params, held.caches, inputs,
                                     held.bank, any_sampled=draw)
        else:
            tok, new = self._prefill_ragged(self.params, held.caches, inputs,
                                            lengths, held.bank,
                                            any_sampled=draw)
        T.store_state(held.caches, new)
        held.tok.copy_(tok)
        outs = [tok]
        for _ in range(steps - 1):
            outs.append(self._decode_once(key, held, draw).clone())
        return torch.stack(outs, dim=1)

    def _generate_host(self, key, held, inputs, steps, s, lengths, draw):
        """Logits out of each step, sampled after it: row r at step t folds
        (seed_r, prompt_len_r + t), so the streams match the fused path."""
        b = held.tok.shape[0]
        if lengths is None:
            logits, new = self._prefill(self.params, held.caches, inputs)
            pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        else:
            logits, new = self._prefill_ragged(self.params, held.caches,
                                               inputs, lengths)
            pos = lengths
        T.store_state(held.caches, new)
        tok = S.sample_tokens(logits, held.bank, pos, any_sampled=draw)
        outs = [tok]
        for _ in range(steps - 1):
            held.tok.copy_(tok[:, None])
            logits = self._decode_once(key, held, draw)
            pos = pos + 1
            tok = S.sample_tokens(logits, held.bank, pos, any_sampled=draw)
            outs.append(tok)
        return torch.stack(outs, dim=1)


class ContinuousBatchingEngine:
    """Slot-recycling serving engine: ``submit`` requests, then ``run``.

    ``params`` is the port's ``LM`` (``weights.init_params`` /
    ``weights.from_jax_params``); it must already live on ``device``
    (default cuda). With ``tp * seq_shards > 1`` the engine serves on this
    process's rank of the serving mesh, built over the initialized process
    group (``distributed/serve_mesh.plan_mesh``): ``params`` is the full
    model, of which it keeps the head slice.

    ``graphed`` says whether the steps replay CUDA graphs: on one CUDA
    device (not a mesh), whatever the score norm and kernel flags, unless
    ``cuda_graphs=False`` (the same engine eager, for A/B runs and
    tests)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: T.LM, *,
                 default_sampling: SamplingParams | None = None,
                 device=None, cuda_graphs: bool = True):
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
        # the steps' fixed inputs: prefill [slot, length, chunk tokens],
        # decode [active mask; tokens (logits mode)], the page table (re-
        # uploaded only when the pool mutates)
        self._chunk = scfg.prefill_chunk
        self._prefill_in = _Staged((2 + self._chunk,), self.device)
        self._decode_in = _Staged((2, scfg.max_slots), self.device)
        self._table = (_Staged((scfg.max_slots, scfg.max_pages_per_slot),
                               self.device) if self.paged else None)
        self._table_version = -1
        self.results: dict[int, list[int]] = {}
        self.prefilled_tokens = 0          # chunk tokens computed: warm
                                           # admissions skip cached rows
        self.ttft: dict[int, float] = {}   # uid -> seconds submit->1st token
        self._t_submit: dict[int, float] = {}
        self._submits = 0
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
        # the captured steps, by (step, draws): one memory pool for all;
        # the warm-up before each capture runs on a side stream
        self.graphed = bool(cuda_graphs and self.device.type == "cuda"
                            and plan is None)
        self._graphs = _Graphs(self.device) if self.graphed else None
        self.iterations = 0                # step() calls

    def _lm(self, tokens, caches, **kw):
        """One engine step through ``lm_apply``: (out, caches); the MoE aux
        loss is not served. Under a mesh, adds the collectives it ran to
        ``collectives``."""
        s = self.scfg
        before = COMM.counts()
        out, caches, _ = T.lm_apply(
            self.params, self.mcfg, tokens=tokens, caches=caches,
            merged=True, kv_chunk=s.kv_chunk, decode_kernel=s.decode_kernel,
            decode_kv_block=s.decode_kv_block,
            prefill_kernel=s.prefill_kernel,
            prefill_kv_block=s.prefill_kv_block, fill_bound=s.fill_bound,
            attn_mesh=self._attn_mesh, **kw)
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
        self.iterations += 1
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
    def _graph_steps(self) -> dict:
        return self._graphs.steps if self.graphed else {}

    @property
    def prefill_graphs(self) -> int:
        """Prefill-chunk step graphs captured so far: at most 2 for the
        engine's lifetime (argmax, draw; 1 in logits mode), 0 when eager."""
        return sum(1 for step, _ in self._graph_steps if step == "prefill")

    @property
    def decode_graphs(self) -> int:
        """Decode step graphs captured so far, as ``prefill_graphs``."""
        return sum(1 for step, _ in self._graph_steps if step == "decode")

    @property
    def capture_seconds(self) -> dict:
        """Host seconds of each graph's capture, by (step, draws)."""
        return {key: g.seconds for key, g in self._graph_steps.items()}

    @property
    def graph_nodes(self) -> dict:
        """(top-level nodes, conditional nodes) of each captured graph, by
        (step, draws): a plain walk of n blocks adds n conditional nodes per
        attention layer."""
        return self._graphs.nodes if self.graphed else {}

    @property
    def graph_replays(self) -> int:
        return self._graphs.replays if self.graphed else 0

    @property
    def graph_pool_bytes(self) -> int:
        """Reserved device bytes the captures took."""
        return self._graphs.pool_bytes if self.graphed else 0

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
    def _upload_table(self):
        """Copy the pool's page table into the fixed device table, only
        when the allocator mapped or released pages (``PagePool.version``):
        steps between mutations read it with no host transfer. The copy
        goes through pinned memory without blocking the host."""
        if self._table_version != self.pool.version:
            self._table.put(lambda h: np.copyto(h, self.pool.table))
            self._table_version = self.pool.version

    def _step_table(self, slot=None):
        """The page table rows a step reads, on the device: all of them, or
        the device ``slot``'s row; localized under sequence sharding (this
        rank's pages become local pool indices, the others -1), as the
        reference does in its step."""
        table = self._table.dev
        if slot is not None:
            table = table.index_select(0, slot)
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

    def _step_inputs(self, step: str):
        """The tensors entering a step, for its signature count."""
        buf = (self._prefill_in if step == "prefill" else self._decode_in)
        return (self.caches, buf.dev, self.bank if self.fused else None,
                self._table.dev if self.paged else None)

    def _prefill_step(self, draw: bool):
        """The append-chunk prefill step over the fixed inputs: chunk
        ``tokens`` (1, chunk) of the request in device ``slot`` (1,), its
        real ``lengths`` (1,); the slot's bank row and page row taken on
        the device; ``index[slot]`` advanced in place. Returns the (1,)
        token (fused; ``draw``: the bank row may sample) or the last real
        row's (1, 1, vocab) logits."""
        buf = self._prefill_in.dev
        slot, lengths = buf[0:1], buf[1:2]
        tokens = buf[2:].view(1, self._chunk)
        kw = {}
        if self.paged:
            kw["page_table"] = self._step_table(slot)
        epi = None
        if self.fused:
            row = S.bank_take(self.bank, slot)

            def epi(logits, new_caches):
                return S.sample_tokens(logits[:, -1], row,
                                       T.cache_index(new_caches),
                                       any_sampled=draw)

        out, new = self._lm(tokens, self.caches, slot=slot,
                            prefill_append=lengths, logits_index=lengths - 1,
                            logits_epilogue=epi, **kw)
        T.store_index(self.caches, new, slot)
        return out

    def _decode_step(self, draw: bool):
        """The masked one-token decode step over all slots: tokens
        ``self._last`` (fused) or the staged row (logits mode), the staged
        ``active`` mask; every index advanced in place where active.
        Returns ``self._last`` with the active rows' next tokens written
        (fused) or the (max_slots, 1, vocab) logits."""
        buf = self._decode_in.dev
        active = buf[0] != 0
        tokens = (self._last if self.fused else buf[1])[:, None]
        index = T.cache_index(self.caches)
        kw = {}
        if self.paged:
            kw["page_table"] = self._step_table()
        epi = None
        if self.fused:
            def epi(logits, new_caches):
                return S.sample_tokens(logits[:, -1], self.bank,
                                       T.cache_index(new_caches),
                                       any_sampled=draw)

        out, new = self._lm(tokens, self.caches, positions=index[:, None],
                            decode_active=active, logits_epilogue=epi, **kw)
        T.store_index(self.caches, new)
        if not self.fused:
            return out
        self._last.copy_(torch.where(active, out, self._last))
        return self._last

    def _run(self, step: str, draw: bool):
        """Run ``step`` (``"prefill"`` or ``"decode"``) once on its staged
        inputs: eagerly, or as a replay of its graph, captured at its first
        use (``_Graphs``)."""
        fn = getattr(self, f"_{step}_step")
        self.model_steps += 1
        if not self.graphed:
            return fn(draw)
        return self._graphs.run((step, draw and self.fused),
                                lambda: fn(draw))

    def _prefill_one(self, slot: int, start: int, n: int):
        prompt = self.scheduler.slots[slot].request.prompt
        if self.paged:
            # a fully cached prompt's 1-token tail re-score lands in its
            # shared last page: that page is copied before this chunk writes
            self._write_window(slot, start, start + n)
            self._upload_table()

        def fill(h):
            h[0], h[1] = slot, n
            h[2:2 + n] = prompt[start:start + n]
            h[2 + n:] = 0

        self._prefill_in.put(fill)
        self._prefill_shapes.add(_signature(self._step_inputs("prefill")))
        out = self._run("prefill", slot in self._sampled_slots)
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
        if self.paged:
            for slot, state in decoding:
                # this step writes the last token's row: a page the slot
                # owns alone (prefill privatized the shared tail already,
                # so this never copies; the invariant is enforced, not
                # assumed)
                rows = state.filled + len(state.generated)
                self._write_window(slot, rows - 1, rows)
            self._upload_table()

        def fill(h):
            h[:] = 0
            for slot, state in decoding:
                h[0, slot] = 1
                h[1, slot] = state.last_token

        self._decode_in.put(fill)
        self._decode_shapes.add(_signature(self._step_inputs("decode")))
        draw = any(slot in self._sampled_slots for slot, _ in decoding)
        out = self._run("decode", draw)
        if self.fused:
            # device-side feedback: last tokens in, next tokens out; only
            # the (max_slots,) token vector reaches the host
            sampled = out.cpu().numpy()
        else:
            # the A/B baseline: (max_slots, vocab) logits out of the step,
            # the decoding rows sampled after it through the same schedule
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


# --------------------------------------------------- dry-run entry point ----
def make_decode_for_dryrun(cfg: ModelConfig, seq_len: int, *, device=None):
    """The decode step ``(params, caches, batch_inputs) -> (logits,
    caches)`` over a ``seq_len`` cache, and its ServeConfig — the
    decode_32k / long_500k cell semantics (the cache index is the caller's:
    the dry run's cells pin it at ``seq_len - 1``). The dry-run cells keep
    the logits-returning steps (``fused_sampling=False``): they measure and
    shard the (batch, vocab) logits surface itself."""
    scfg = ServeConfig(max_seq=seq_len, fused_sampling=False)
    _, _, decode_step, _ = make_serve_fns(cfg, scfg, device=device)
    return decode_step, scfg
