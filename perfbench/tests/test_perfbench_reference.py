"""The plain reference against the port at smoke size on the CPU, and the
output check against a timed path broken underneath."""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness as H
from perfbench import weights as W
from perfbench.reference import dense

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _tiny(name, **serving):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    hkv = 2 if cfg["num_key_value_heads"] < cfg["num_attention_heads"] else 4
    cfg.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=hkv,
               vocab_size=512, name="tiny")
    cfg["serving"] = dict(max_slots=4, max_seq=256, prefill_chunk=32,
                          prefill_budget=64, kv_cache_dtype="bfloat16",
                          decode_kernel=True, prefill_kernel=True,
                          **serving)
    return cfg


CONFIGS = {
    "qwen2-contiguous": lambda: _tiny("qwen2-1.5b", paged_kv=False),
    "phi3-paged": lambda: _tiny("phi-3-vision-4.2b-text", paged_kv=True,
                                page_size=16, num_pages=64,
                                prefix_cache=False),
}
MIX = dict(name="tiny", loop="closed", clients=4, start="steady",
           sampling="greedy", block=8,
           prompt=dict(dist="lognormal", median=60, sigma=0.5, min=20,
                       max=120),
           output=dict(dist="uniform", min=8, max=40))
# bf16 serving against fp32 at this size reads a widest gap of 0.03-0.05
# and a mean gap of 0.0002-0.0003; with the port's fp8 KV cache 0.13-0.23
# and 0.0023-0.0043
LIMITS = {"max_logit_gap": {"limit": 0.25}, "mean_logit_gap": {"limit": 1e-3}}


def _cell(cfg):
    return H.Cell("tiny", cfg, MIX, SPEC["end_to_end"], SPEC["per_layer"],
                  LIMITS)


def _run(cfg, seed=2**31 + 3, **kw):
    torch.set_num_threads(2)
    return H.run(_cell(cfg), seed=seed, seconds=2.0, trace=False,
                 device="cpu", t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_logits_match_the_port_in_fp32(name):
    """The reference's forward == the port's whole-sequence ``lm_apply``
    run in float32 on the same weights."""
    from repro_torch.models import transformer as T
    cfg = CONFIGS[name]()
    cfg["port"] = dict(cfg["port"], param_dtype="float32",
                       compute_dtype="float32")
    mcfg, _ = H.port_configs(cfg)
    seed = 2**31 + 17
    lm = H.load_model(cfg, mcfg, seed, "cpu")
    toks = torch.randint(0, 512, (1, 96), generator=torch.Generator()
                         .manual_seed(0))
    with torch.no_grad():
        want = T.lm_apply(lm, mcfg, tokens=toks)[0][0].float()
    got = dense.logits(cfg, seed, toks[0].tolist(), "cpu")
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (
        (got - want).abs().max())
    assert float(want.std()) > 0.1          # logits far from constant


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_tokens_pass_the_check(name):
    r = _run(CONFIGS[name]())
    c = r["checks"]
    assert r["correct"], c
    assert r["sample"]["compared_tokens"] >= 100
    assert r["sample"]["finished_requests"] > 0
    assert set(r["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("control", H.CONTROLS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_control_is_not_correct(name, control):
    """The port serving with its fp8 KV cache; the reference on fp8
    operands, choosing in the program's place."""
    r = _run(CONFIGS[name](), control=control)
    assert not r["correct"], r["checks"]


def _alter_tokens(mp):
    from repro_torch.serve import sampling as S
    orig = S.sample_tokens

    def altered(*a, **k):
        t = orig(*a, **k)
        return torch.where(t % 7 == 3, (t + 1) % 512, t)
    mp.setattr(S, "sample_tokens", altered)


def _state_unchanged(mp):
    """Each step leaves the caches' fill where it was."""
    from repro_torch.models import transformer as T
    mp.setattr(T, "store_index", lambda *a, **k: None)


def _half_batch(mp):
    """The decode step computes only the lower half of the slots."""
    from repro_torch.models import transformer as T
    orig = T.lm_apply

    def half(*a, decode_active=None, **k):
        if decode_active is not None:
            n = decode_active.shape[0]
            decode_active = decode_active & (
                torch.arange(n, device=decode_active.device) < n // 2)
        return orig(*a, decode_active=decode_active, **k)
    mp.setattr(T, "lm_apply", half)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(CONFIGS[name]())
    assert not r["correct"], r["checks"]


def test_weights_repeat_by_group():
    cfg = CONFIGS["qwen2-contiguous"]()
    a = W.make(cfg, 5, "layer1", "cpu")
    b = W.make(cfg, 5, "layer1", "cpu")
    c = W.make(cfg, 6, "layer1", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.1.b0.attn.q.w"],
                           c["blocks.1.b0.attn.q.w"])
    beta = a["blocks.1.b0.attn.score_norm.beta"]
    assert beta.dtype == torch.float32 and 0.5 <= beta.min() <= beta.max(
    ) <= 2.5
