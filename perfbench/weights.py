"""Random weights of a dense decoder, made on the device from the seed.

One generator and one ``randn`` call per group (the embedding; the final
norm; each layer), so the reference can draw any one group again alone and
get the same values. Names are the port's parameter names; the reference
reads them as plain strings. Imports nothing of the port."""
from __future__ import annotations

import torch

_MASK = 2**63 - 1
NORM_STD = 0.1       # zero-centred RMSNorm gains: 1 + N(0, 0.1)
BIAS_STD = 0.1


def dims(cfg: dict) -> dict:
    """The sizes of a dense configuration file (Hugging Face keys)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(layers=cfg["num_hidden_layers"], d=d, H=H,
                hkv=cfg["num_key_value_heads"],
                dk=cfg.get("head_dim") or d // H,
                ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                qkv_bias=cfg["port"]["qkv_bias"],
                eps=cfg["rms_norm_eps"], theta=cfg["rope_theta"])


def groups(cfg: dict) -> list[str]:
    n = cfg["num_hidden_layers"]
    return ["embed", "final"] + [f"layer{i}" for i in range(n)]


def _layout(cfg: dict, group: str):
    """[(name, shape, std)] of the normal-drawn tensors of ``group``, and
    the ConSmax (beta, gamma) names of a layer (None elsewhere)."""
    m = dims(cfg)
    d, H, hkv, dk, ff = m["d"], m["H"], m["hkv"], m["dk"], m["ff"]
    if group == "embed":
        return [("embed.table", (m["vocab"], d), d ** -0.5)], None
    if group == "final":
        return [("final_norm.scale", (d,), NORM_STD)], None
    i = int(group[len("layer"):])
    p = f"blocks.{i}.b0."
    out = [(p + "attn_norm.scale", (d,), NORM_STD)]
    for w, h in (("q", H), ("k", hkv), ("v", hkv)):
        out.append((p + f"attn.{w}.w", (d, h, dk), d ** -0.5))
        if m["qkv_bias"]:
            out.append((p + f"attn.{w}.b", (h, dk), BIAS_STD))
    out += [(p + "attn.o.w", (H, dk, d), (H * dk) ** -0.5),
            (p + "mlp_norm.scale", (d,), NORM_STD),
            (p + "mlp.gate.w", (d, ff), d ** -0.5),
            (p + "mlp.up.w", (d, ff), d ** -0.5),
            (p + "mlp.down.w", (ff, d), ff ** -0.5)]
    return out, (p + "attn.score_norm.beta", p + "attn.score_norm.gamma")


def make(cfg: dict, seed: int, group: str, device, dtype=torch.bfloat16):
    """``{name: tensor}`` of ``group``: the drawn weights in ``dtype`` (the
    served type; the reference asks for them again and widens them), the
    ConSmax beta ~ U[lo, hi] and gamma = const in fp32."""
    normal, consmax = _layout(cfg, group)
    gi = groups(cfg).index(group)
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & _MASK) * 1_000_003 + gi) & _MASK)
    total = sum(torch.Size(s).numel() for _, s, _ in normal)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in normal:
        n = torch.Size(shape).numel()
        out[name] = (flat[off:off + n] * std).to(dtype).view(shape)
        off += n
    del flat
    if consmax is not None:
        c = cfg["port"]["consmax"]
        H = dims(cfg)["H"]
        u = torch.rand(H, generator=gen, device=device)
        out[consmax[0]] = c["beta_init_lo"] + (
            c["beta_init_hi"] - c["beta_init_lo"]) * u
        out[consmax[1]] = torch.full((H,), float(c["gamma_init"]),
                                     device=device)
    return out
