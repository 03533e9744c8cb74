"""The serving mesh — the reference's ``distributed/serve_mesh.py`` over
``torch.distributed``.

Process model. One process per rank; serving ranks form a
``DeviceMesh((tp, seq_shards), ("model", "seq"))`` (``launch/mesh.py``),
as in the reference. Every rank runs the same host loop: the same submits,
the same scheduler decisions and the same global page table. Everything
outside attention (embeddings, MLP / MoE, norms, the unembed, fused
sampling) is replicated, so every rank computes the same logits and the
same tokens. The backend is an argument, never a caught failure: ``nccl``
when each rank has its own card, ``gloo`` on the CPU, and ``gloo`` for
ranks that share one card (NCCL refuses two ranks on one device; gloo
takes the CUDA tensors, so every tensor and kernel stays on the card and
only the transport of the collectives goes through gloo).

Weights. Every rank builds the full parameters (from one seed, or from
``weights.from_jax_params``) and keeps its head slice (``shard_params``):

* ``"model"`` (tensor parallel) splits the attention heads: each rank
  attends with its q heads, its KV heads (its KV cache holds only those)
  and its per-head ConSmax beta/gamma, so it runs the unchanged serving
  code, kernels included, on its head slice. The q/k/v projections stay
  WHOLE on every rank, and the rank takes its heads' columns of their
  outputs (``AttentionMesh.local_heads``): a head-slice GEMM (N / tp
  columns) is not bound to give the full GEMM's columns bit for bit —
  cuBLAS picks its kernel and its reduction order by shape, and on an H100
  a column slice differed from the full product at fp32 and for 3072 ->
  4096 at M <= 8 — while the same full GEMM on the same operands gives
  the single-device bits at every width and dtype. (The reference's XLA
  partitioner slices the weights; its CPU GEMMs keep the bits.) Ranks own
  disjoint heads, so the combine is an all-gather of the per-head outputs
  (a concatenation, exact) followed by the FULL o-projection on every
  rank: the o weight is replicated and sees operands bit-identical to the
  single-device step. (Summing per-rank o-projection partials, the
  megatron-style combine, reassociates the contraction: the reference
  measured ~5e-2 logit drift from it.)
* ``"seq"`` (sequence sharding) splits the paged pool's page axis into
  contiguous per-rank blocks (``pages_per_shard`` pages each, plus the
  port's spare page). The host allocator's block position map
  (``serve/scheduler.PagePool``) puts a request that fits one block
  (``max_seq / seq_shards`` rows) on one rank; each rank localizes the
  global table in the step (``kernels/cache_layout.localize_page_table``):
  foreign pages become -1, which the kernels read as zeros. A rank's
  attention output is then the ConSmax partial over its pages (no running
  max, no denominator), and the partials combine by ONE output-sized fp32
  all-reduce. A request within one block gets exactly +0.0 from every
  other rank, so the sum returns the owner's bits and the tokens equal
  single-device serving's. A longer request spills block by block across
  ranks (the capacity point of this axis) and its rows' fp32 additions
  regroup: those tokens are not bit-identical.

``plan_mesh`` returns None when ``tp * seq_shards == 1``, and the engine
then keeps its single-device code paths bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.distributed.comm import AttentionMesh, Comm
from repro_torch.models.transformer import LM
from repro_torch.nn import layers as L

MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Everything the engine needs to serve on its rank of the mesh."""
    mesh: object                  # torch DeviceMesh (model, seq)
    cfg: ModelConfig              # the global model config
    cfg_local: ModelConfig        # this rank's view (n_heads/tp, n_kv_heads/tp)
    tp: int
    seq_shards: int
    pages_per_shard: int          # paged pools: P // seq_shards (else 0)
    attn: AttentionMesh           # the combine's groups, threaded to attention

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(MODEL_AXIS)

    @property
    def seq_rank(self) -> int:
        return self.mesh.get_local_rank(SEQ_AXIS)

    def shard_params(self, params: LM) -> LM:
        """This rank's parameters: a new ``LM`` of ``cfg_local`` holding the
        head slice of ``params``' per-head ConSmax beta/gamma and copies of
        everything else, each leaf contiguous. Its attention blocks keep
        the FULL q/k/v projections (the rank takes its heads' columns of
        their outputs, ``AttentionMesh.local_heads``) and the FULL
        o-projection (all ``cfg.n_heads`` heads), the reference's
        replicated ``o`` (``param_specs``)."""
        return shard_params(params, self.cfg, self.cfg_local, self.tp,
                            self.model_rank)


def _head_slice(name: str, t, cfg: ModelConfig, tp: int, rank: int):
    """The model-axis slice of parameter ``name`` (None: replicated): the
    per-head beta / gamma; q/k/v/o stay whole (see the module doc)."""
    parts = name.split(".")
    if len(parts) < 3 or parts[-3] != "attn":
        return None
    if parts[-2] == "score_norm" and t.shape[0] == cfg.n_heads:
        per = cfg.n_heads // tp                  # per-head beta / gamma
        return t.narrow(0, rank * per, per)
    return None                                  # q/k/v/o, shared beta/gamma


def shard_params(params: LM, cfg: ModelConfig, cfg_local: ModelConfig,
                 tp: int, rank: int) -> LM:
    """``MeshPlan.shard_params`` for an explicit model rank."""
    local = LM(cfg_local, device=params.device)
    d, dk, dev = cfg.d_model, cfg.head_dim_, params.device
    for sup in local.blocks:
        for blk in sup.values():
            if hasattr(blk, "attn"):
                a = blk.attn
                a.q = L.HeadsProj(d, cfg.n_heads, dk, bias=cfg.qkv_bias,
                                  device=dev)
                a.k = L.HeadsProj(d, cfg.n_kv_heads, dk, bias=cfg.qkv_bias,
                                  device=dev)
                a.v = L.HeadsProj(d, cfg.n_kv_heads, dk, bias=cfg.qkv_bias,
                                  device=dev)
                a.o = L.HeadsOut(cfg.n_heads, dk, d, device=dev)
    state = {}
    for name, t in params.state_dict().items():
        part = _head_slice(name, t, cfg, tp, rank)
        state[name] = (t if part is None else part).contiguous()
    local.load_state_dict(state, strict=True)
    return local


def plan_mesh(cfg: ModelConfig, scfg: ServeConfig, *, device=None):
    """The serving ``MeshPlan`` of this rank, or None when ``tp *
    seq_shards == 1`` (single device: no collectives, the engine's original
    code paths, bit for bit). The ``(tp, seq_shards)`` mesh is built over
    the initialized default process group, of ``device``'s type
    (``launch/mesh.serve_mesh``)."""
    tp, ns = scfg.tp, scfg.seq_shards
    if tp * ns == 1:
        return None
    if cfg.score_norm != "consmax":
        raise ValueError(
            f"sharded serving requires score_norm='consmax' (got "
            f"{cfg.score_norm!r} for {cfg.arch_id}): per-shard partials "
            "combine by pure addition only when the normalizer has no "
            "running max or denominator — softmax/softermax would need a "
            "cross-shard log-sum-exp exchange this path does not implement")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        raise ValueError(
            f"tp={tp} must divide n_heads ({cfg.n_heads}) and "
            f"n_kv_heads ({cfg.n_kv_heads}) for {cfg.arch_id} — heads "
            "shard in equal slices (the GQA group ratio is preserved "
            "when both divide)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < tp * ns:
        raise ValueError(
            f"serve mesh ({tp} x {ns}) needs {tp * ns} ranks, have {world}: "
            f"start one process per rank (torchrun --nproc-per-node "
            f"{tp * ns}) and initialize the process group "
            "(launch/mesh.init_distributed)")
    if world != tp * ns:
        raise ValueError(
            f"serve mesh ({tp} x {ns}) over {world} ranks: every rank runs "
            "the engine's host loop, so the world size must equal tp * "
            "seq_shards")
    from repro_torch.launch.mesh import serve_mesh
    mesh = serve_mesh(tp, ns, device=device)
    pages_per_shard = 0
    if ns > 1:
        # ServeConfig.__post_init__ already enforced paged_kv, fill_bound
        # and page divisibility
        pages_per_shard = scfg.num_pages // ns
    elif scfg.paged_kv:
        pages_per_shard = scfg.num_pages

    def comm(axis, n):
        return Comm(mesh.get_group(axis)) if n > 1 else None

    r = mesh.get_local_rank(MODEL_AXIS)
    hq, hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp

    # the per-rank view the steps run under: head counts divided, head_dim
    # PINNED (head_dim_ falls back to d_model // n_heads, which would
    # silently grow when n_heads shrinks)
    cfg_local = cfg.replace(n_heads=cfg.n_heads // tp,
                            n_kv_heads=cfg.n_kv_heads // tp,
                            head_dim=cfg.head_dim_)
    return MeshPlan(mesh=mesh, cfg=cfg, cfg_local=cfg_local, tp=tp,
                    seq_shards=ns, pages_per_shard=pages_per_shard,
                    attn=AttentionMesh(model=comm(MODEL_AXIS, tp),
                                       seq=comm(SEQ_AXIS, ns),
                                       heads=(r * hq, hq, r * hkv, hkv)))
