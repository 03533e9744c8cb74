"""Architecture registry: exact published configs (``full``) and reduced
same-family smoke configs (``smoke``) for CPU tests — the port's copy of the
reference registry (the tests check that every entry matches it).

All archs default to score_norm="consmax".
"""
from __future__ import annotations

from repro_torch.configs.base import (ConSmaxConfig, MambaConfig, ModelConfig,
                                      MoEConfig, XLSTMConfig)

_JAMBA_PATTERN = ("mamba", "mamba_moe", "mamba", "mamba_moe",
                  "attn", "mamba_moe", "mamba", "mamba_moe")
_XLSTM_PATTERN = ("mlstm",) * 7 + ("slstm",)


def _full():
    return {
        # [dense] 28L 4096 32H kv2 ff13696 v65024 — RoPE 2d (interleaved,
        # half-dim), GQA, qkv bias [arXiv:2406.12793]
        "chatglm3-6b": ModelConfig(
            arch_id="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
            n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024,
            qkv_bias=True, rope_style="interleaved", rope_fraction=0.5),
        # [dense] 40L 2048 32H kv8 ff8192 v49155 [hf ibm-granite]
        "granite-3-2b": ModelConfig(
            arch_id="granite-3-2b", family="dense", n_layers=40, d_model=2048,
            n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155),
        # [dense] 26L 2304 8H kv4 ff9216 v256000 head_dim 256 — local/global
        # alternating (w=4096), softcaps, geglu, sandwich norms, embed scale
        "gemma2-2b": ModelConfig(
            arch_id="gemma2-2b", family="dense", n_layers=26, d_model=2304,
            n_heads=8, n_kv_heads=4, d_ff=9216, vocab_size=256000,
            head_dim=256, mlp="gelu_glu", attn_softcap=50.0,
            final_softcap=30.0, window=4096,
            block_pattern=("local", "global"), post_block_norm=True,
            embed_scale=True),
        # [dense] 28L 1536 12H kv2 ff8960 v151936 — QKV bias
        "qwen2-1.5b": ModelConfig(
            arch_id="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
            n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
            qkv_bias=True),
        # [moe] 32L 4096 32H kv8 expert-ff6400 v32064, 16e top-2
        "phi3.5-moe-42b-a6.6b": ModelConfig(
            arch_id="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32,
            d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
            vocab_size=32064, norm="layernorm",
            block_pattern=("attn_moe",),
            moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400)),
        # [moe] 64L 6144 48H kv8 ff32768 v131072, 8e top-2, logit caps
        "grok-1-314b": ModelConfig(
            arch_id="grok-1-314b", family="moe", n_layers=64, d_model=6144,
            n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072,
            mlp="gelu_glu", attn_softcap=30.0, final_softcap=30.0,
            embed_scale=True, block_pattern=("attn_moe",),
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768)),
        # [vlm] 32L 3072 32H kv32 ff8192 v32064 — phi3-mini backbone + CLIP
        # frontend (stub: precomputed patch embeddings)
        "phi-3-vision-4.2b": ModelConfig(
            arch_id="phi-3-vision-4.2b", family="vlm", n_layers=32,
            d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
            vocab_size=32064, frontend="patches"),
        # [ssm] 48 blocks 2048 4H v50304 — xLSTM[7:1] mLSTM+sLSTM, no pos-emb
        "xlstm-1.3b": ModelConfig(
            arch_id="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
            n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
            norm="layernorm", rope_style="none",
            block_pattern=_XLSTM_PATTERN, xlstm=XLSTMConfig()),
        # [audio] 48L 2048 32H kv32 ff8192 v2048 — decoder over EnCodec
        # tokens (stub: precomputed frame embeddings), cross-attn to cond
        "musicgen-large": ModelConfig(
            arch_id="musicgen-large", family="audio", n_layers=48,
            d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
            vocab_size=2048, norm="layernorm", mlp="gelu",
            rope_style="none", sinusoidal_pos=True, cross_attn=True,
            n_cond_tokens=256, frontend="frames"),
        # [hybrid] 72L 8192 64H kv8 ff24576 v65536 — mamba:attn 1:7
        # interleave, MoE 16e top-2 every other layer, no pos-emb
        "jamba-1.5-large-398b": ModelConfig(
            arch_id="jamba-1.5-large-398b", family="hybrid", n_layers=72,
            d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
            vocab_size=65536, rope_style="none",
            block_pattern=_JAMBA_PATTERN,
            moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                          layer_period=2),
            mamba=MambaConfig()),
        # the paper's own benchmark model (Sec. V-A): GPT-2-style,
        # 6 layers x 6 heads, d=384
        "gpt2-consmax": ModelConfig(
            arch_id="gpt2-consmax", family="dense", n_layers=6, d_model=384,
            n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=8192,
            norm="layernorm", mlp="gelu", rope_style="none",
            sinusoidal_pos=True,
            consmax=ConSmaxConfig(beta_init_lo=0.5, beta_init_hi=2.5,
                                  gamma_init=100.0)),
    }


def _smoke(full: ModelConfig) -> ModelConfig:
    """Reduced same-family config: keeps block pattern/features, shrinks dims."""
    kw: dict = dict(
        n_layers=2 * full.pattern_period, d_model=128, n_heads=4,
        n_kv_heads=min(4, max(1, full.n_kv_heads // 8)) if full.n_kv_heads < full.n_heads else 4,
        d_ff=256 if full.d_ff else 0, vocab_size=512, head_dim=0,
        window=min(full.window, 8) if full.window else 0,
        n_cond_tokens=16 if full.cross_attn else 0)
    if full.family in ("moe", "hybrid"):
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_ff_expert=256,
            layer_period=full.moe.layer_period,
            router_norm=full.moe.router_norm)
    if full.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16)
    if full.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(chunk=16, stabilizer=full.xlstm.stabilizer)
    return full.replace(**kw)


_FULL = _full()
ARCH_IDS = [a for a in _FULL if a != "gpt2-consmax"]


def get_config(arch_id: str, *, smoke: bool = False,
               score_norm: str | None = None, **overrides) -> ModelConfig:
    cfg = _FULL[arch_id]
    if smoke:
        cfg = _smoke(cfg)
    if score_norm is not None:
        cfg = cfg.replace(score_norm=score_norm)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
