"""Model/train/serve configuration dataclasses — the port's own copy of
the reference's ``configs/base.py``.

Field names, defaults and ``ServeConfig.__post_init__`` checks match the
reference one for one, so a config built here and one built there from the
same arguments describe the same run. ``pdtype``/``cdtype`` return
``torch.dtype``s. The serving fields the port does not read (the batch
knob, the KV sharding of the reference's dry run, the Pallas prefill
grid's block) stay for that parity; the port's engine refuses a config
that sets one away from its default (``serve/engine.py``).
``TrainConfig.fsdp`` picks FSDP2 sharding of the parameters or replicated
parameters under a training mesh (``distributed/sharding.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class ConSmaxConfig:
    """Learnable-normalizer config (the paper's contribution)."""
    beta_init_lo: float = 0.5        # paper: beta ~ U[0.5, 2.5]
    beta_init_hi: float = 2.5
    gamma_init: float = 100.0        # paper: gamma = 100
    per_head: bool = True
    learnable: bool = True


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    layer_period: int = 1
    aux_loss_weight: float = 0.01
    router_norm: str = "softmax"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    chunk: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0
    d_conv: int = 4
    slstm_every: int = 8
    chunk: int = 256
    stabilizer: str = "max"


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense|moe|vlm|ssm|audio|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention flavour ---
    score_norm: str = "consmax"      # "softmax" | "consmax" | "softermax"
    consmax: ConSmaxConfig = field(default_factory=ConSmaxConfig)
    qkv_bias: bool = False
    rope_style: str = "half"         # "half" | "interleaved" | "none"
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0                  # sliding-window size for "local" layers
    block_pattern: tuple = ("attn",)
    cross_attn: bool = False
    n_cond_tokens: int = 0
    sinusoidal_pos: bool = False
    # --- mlp flavour ---
    mlp: str = "silu_glu"            # "silu_glu" | "gelu_glu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    post_block_norm: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = True
    frontend: str = "tokens"         # "tokens" | "patches" | "frames"
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # --- dtypes ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_super_layers(self) -> int:
        if self.n_layers % self.pattern_period:
            raise ValueError(f"{self.arch_id}: n_layers {self.n_layers} is "
                             f"not a multiple of {self.block_pattern}")
        return self.n_layers // self.pattern_period

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    remat: str = "full"              # "none" | "full" | "dots"
    microbatch: int = 0              # 0 = no gradient accumulation
    fsdp: bool = True                # under a mesh: shard params (FSDP2) or
                                     # replicate them (grads all-reduced)
    grad_compression: str = "none"   # "none" | "int8_ef" (error feedback)
    q_chunk: int = 2048              # blockwise-attention tile sizes
    kv_chunk: int = 1024
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 128
    max_seq: int = 32_768
    prefill_chunk: int = 0           # append-at-index prefill chunk size;
                                     # 0 resolves to min(2048, max_seq)
    kv_cache_dtype: str = "bfloat16"
    seq_shard_kv: bool = False
    q_chunk: int = 2048
    kv_chunk: int = 1024             # KV block of the plain append walk
    # --- continuous batching (serve/scheduler.py + engine.py) ---
    max_slots: int = 8               # concurrent requests in the decode batch
    fused_sampling: bool = True      # tokens sampled inside the steps
    prefill_budget: int = 0          # max prefill tokens per engine iteration
                                     # (0 = one prefill_chunk per iteration)
    decode_kernel: bool = False      # split-KV consmax_decode kernel
    decode_kv_block: int = 256       # KV shard size of the decode kernel
    prefill_kernel: bool = False     # consmax_prefill kernel for append chunks
    prefill_kv_block: int = 512      # KV shard size of the prefill
                                     # kernel's grid (rounded up to whole
                                     # 64-row tiles, at most 64 shards)
    fill_bound: bool = True          # skip KV blocks past each slot's fill
                                     # (False = capacity-swept baseline)
    score_norm: Optional[str] = None # the served model's score_norm, when
                                     # known: lets the kernel flags fail at
                                     # construction on a non-consmax arch
    # --- paged KV (continuous engine; refused without paged_kv) ---
    paged_kv: bool = False
    page_size: int = 256
    num_pages: int = 0
    prefix_cache: bool = True
    prefix_evict: str = "lru"
    # --- device mesh (ContinuousBatchingEngine, distributed/serve_mesh) ---
    tp: int = 1
    seq_shards: int = 1

    def __post_init__(self):
        if self.prefill_chunk == 0:
            object.__setattr__(self, "prefill_chunk",
                               min(2048, self.max_seq))
        if self.prefill_chunk < 0 or self.max_seq <= 0:
            raise ValueError(
                f"ServeConfig: prefill_chunk ({self.prefill_chunk}) and "
                f"max_seq ({self.max_seq}) must be positive")
        if self.prefill_chunk > self.max_seq:
            raise ValueError(
                f"ServeConfig: prefill_chunk ({self.prefill_chunk}) exceeds "
                f"max_seq ({self.max_seq}) — an append chunk could not fit "
                "a slot's KV rows")
        if self.kv_cache_dtype not in ("bfloat16", "bf16", "int8",
                                       "fp8_e4m3"):
            raise ValueError(
                f"ServeConfig: kv_cache_dtype must be one of 'bfloat16', "
                f"'bf16', 'int8', 'fp8_e4m3', got {self.kv_cache_dtype!r}")
        if self.prefill_kv_block <= 0 or self.decode_kv_block <= 0:
            raise ValueError(
                f"ServeConfig: prefill_kv_block ({self.prefill_kv_block}) "
                f"and decode_kv_block ({self.decode_kv_block}) must be "
                "positive")
        if self.score_norm is not None and self.score_norm != "consmax":
            flags = [name for name, on in (("decode_kernel",
                                            self.decode_kernel),
                                           ("prefill_kernel",
                                            self.prefill_kernel)) if on]
            if flags:
                verb = "require" if len(flags) > 1 else "requires"
                raise ValueError(
                    f"ServeConfig: {' and '.join(flags)} {verb} "
                    f"score_norm='consmax' (got {self.score_norm!r}): the "
                    "fused serving kernels have no softmax/softermax path")
        if self.paged_kv:
            if self.page_size <= 0:
                raise ValueError(
                    f"ServeConfig: page_size ({self.page_size}) must be "
                    "positive")
            if self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"ServeConfig: page_size ({self.page_size}) must divide "
                    f"prefill_chunk ({self.prefill_chunk}) so prefill chunk "
                    "writes start page-aligned")
            if self.num_pages == 0:
                object.__setattr__(
                    self, "num_pages",
                    self.max_slots * self.max_pages_per_slot)
            if self.num_pages < self.max_pages_per_slot:
                raise ValueError(
                    f"ServeConfig: num_pages ({self.num_pages}) below "
                    f"max_pages_per_slot ({self.max_pages_per_slot}) — even "
                    "a single max_seq request could not be served")
            if self.prefix_evict not in ("lru", "fifo"):
                raise ValueError(
                    f"ServeConfig: prefix_evict must be 'lru' or 'fifo', "
                    f"got {self.prefix_evict!r}")
        if self.tp < 1 or self.seq_shards < 1:
            raise ValueError(
                f"ServeConfig: tp ({self.tp}) and seq_shards "
                f"({self.seq_shards}) must be >= 1")
        if self.seq_shards > 1:
            if not self.paged_kv:
                raise ValueError(
                    f"ServeConfig: seq_shards ({self.seq_shards}) > 1 "
                    "requires paged_kv")
            if not self.fill_bound:
                raise ValueError(
                    f"ServeConfig: seq_shards ({self.seq_shards}) > 1 "
                    "requires fill_bound")
            if self.num_pages % self.seq_shards:
                raise ValueError(
                    f"ServeConfig: seq_shards ({self.seq_shards}) must "
                    f"divide num_pages ({self.num_pages})")

    @property
    def mesh_shape(self) -> tuple:
        """(tp, seq_shards): the ("model", "seq") serving mesh; (1, 1) is
        one device."""
        return (self.tp, self.seq_shards)

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


# the dry run's cells (``launch/specs.py``), the reference's four shapes
SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}
