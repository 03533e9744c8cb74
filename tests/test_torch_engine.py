"""The port's continuous-batching engine against the JAX reference engine,
and the port's package rules.

* Greedy tokens of the port's ``ContinuousBatchingEngine`` equal the
  reference engine's on the qwen2, gpt2-consmax, gemma2, chatglm3,
  granite, phi3.5-moe and grok smoke configs (the MoE ones route each
  chunk and decode step with the capacity of its own length, as the
  reference does), with prompts longer than ``prefill_chunk``
  (multi-chunk admissions interleaved with decode) and more requests than
  slots (recycling). Compared at ``compute_dtype="float32"``, where the two
  packages' logits agree to ~1e-6 (gemma2 ~2e-5, XLA's tanh;
  test_torch_model.py), far from flipping a greedy token; with the kernel
  flags on or off in the port (their plain versions on the CPU).
* Inside the port, at the bf16 serving default: a request served among
  others gets the same tokens as served alone.
* Unported options raise instead of serving something else (sampled
  requests and host-side sampling are served); entry points
  need a card unless asked for the CPU; no module of the port, nor
  ``chip_smoke.py``, imports JAX or the reference package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget
from repro.models import transformer as JT
from repro.nn.module import Ctx
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import from_jax_params, init_params

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LENS = [5, 13, 3, 20, 9]
BUDGETS = [4, 6, 3, 5, 7]
SERVE = dict(max_seq=48, prefill_chunk=8, max_slots=3)


def _prompts(vocab, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(engine, prompts, budgets):
    uids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    results = engine.run(max_steps=500)
    return [results[u] for u in uids]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gpt2-consmax", "gemma2-2b",
                                  "chatglm3-6b", "granite-3-2b",
                                  "phi3.5-moe-42b-a6.6b", "grok-1-314b"])
def test_greedy_tokens_match_reference_engine(arch):
    jc = jget(arch, smoke=True, compute_dtype="float32")
    tc = tget(arch, smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    prompts = _prompts(jc.vocab_size)
    ref = _serve(JEngine(jc, JServeConfig(**SERVE), p), prompts, BUDGETS)
    for kernels in (False, True):
        scfg = ServeConfig(**SERVE, decode_kernel=kernels,
                           prefill_kernel=kernels, decode_kv_block=16)
        eng = ContinuousBatchingEngine(tc, scfg, model, device="cpu")
        got = _serve(eng, prompts, BUDGETS)
        assert got == ref, kernels
        assert eng.prefill_cache_size == eng.decode_cache_size == 1
    assert [len(t) for t in ref] == BUDGETS


def test_served_alone_equals_served_among_others():
    cfg = tget("qwen2-1.5b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    scfg = ServeConfig(**SERVE, decode_kernel=True, prefill_kernel=True)
    prompts = _prompts(cfg.vocab_size, seed=1)
    batched = _serve(ContinuousBatchingEngine(cfg, scfg, model, device="cpu"),
                     prompts, BUDGETS)
    for i in (1, 3):
        alone = _serve(ContinuousBatchingEngine(cfg, scfg, model,
                                                device="cpu"),
                       [prompts[i]], [BUDGETS[i]])
        assert alone[0] == batched[i]


def test_unported_options_raise():
    cfg = tget("qwen2-1.5b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousBatchingEngine(cfg, ServeConfig(**SERVE), model,
                                   device="cpu")
    # sampled requests and host-side sampling are served
    # (tests/test_torch_sampling.py)
    eng.submit([1, 2, 3], 4, sampling=SamplingParams(temperature=0.7))
    ContinuousBatchingEngine(cfg, ServeConfig(**SERVE, fused_sampling=False),
                             model, device="cpu")
    # fields the port mirrors but does not read refuse non-default values;
    # the paged fields are read only with paged_kv=True, q_chunk only by
    # the static session's whole-prompt prefill
    paged = dict(paged_kv=True, page_size=4)
    for kw in (dict(paged, q_chunk=16),
               dict(q_chunk=16), dict(batch=4), dict(seq_shard_kv=True),
               dict(page_size=4), dict(prefix_cache=False)):
        with pytest.raises(NotImplementedError):
            ContinuousBatchingEngine(cfg, ServeConfig(**SERVE, **kw), model,
                                     device="cpu")
    # the mesh is served (tests/test_torch_mesh.py); here, in one process,
    # it refuses what plan_mesh refuses: too few ranks, and tp not dividing
    # the smoke config's one KV head
    for kw, match in ((dict(paged, num_pages=24, seq_shards=2), "ranks"),
                      (dict(tp=2), "divide")):
        with pytest.raises(ValueError, match=match):
            ContinuousBatchingEngine(cfg, ServeConfig(**SERVE, **kw), model,
                                     device="cpu")
    ContinuousBatchingEngine(cfg, ServeConfig(**SERVE, **paged,
                                              prefix_cache=False,
                                              prefix_evict="fifo"),
                             model, device="cpu")
    # the quantized caches are served (tests/test_torch_quantized_kv.py)
    for kw in (dict(kv_cache_dtype="int8"),
               dict(paged, kv_cache_dtype="fp8_e4m3")):
        ContinuousBatchingEngine(cfg, ServeConfig(**SERVE, **kw), model,
                                 device="cpu")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("gpt2-consmax", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    model = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(cfg, ServeConfig(**SERVE), model)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--engine", "continuous", "--arch",
          "gpt2-consmax", "--requests", "3", "--max-slots", "2",
          "--prompt-len", "10", "--steps", "4", "--prefill-chunk", "4",
          "--decode-kernel", "--prefill-kernel", "--prefill-kv-block", "64"])
    assert "3 requests" in capsys.readouterr().out
    main(["--device", "cpu", "--engine", "continuous", "--requests", "3",
          "--max-slots", "2", "--prompt-len", "10", "--steps", "4",
          "--prefill-chunk", "8", "--paged", "--page-size", "4",
          "--prefix-evict", "fifo"])
    out = capsys.readouterr().out
    assert "paged=True" in out and "prefix cache (fifo)" in out
    # the static session is the default engine
    main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
          "--steps", "3"])
    assert "[serve] qwen2-1.5b (smoke) on cpu: 6 tokens" in \
        capsys.readouterr().out


def test_serve_cli_parses_mesh_and_prefill_kv_block():
    """``--mesh TPxNS`` sets ``--tp`` / ``--seq-shards`` (the reference's
    shorthand), a malformed one exits; ``--prefill-kv-block`` defaults to
    the reference's 512."""
    from repro_torch.launch.serve import parse_args
    args = parse_args([])
    assert (args.tp, args.seq_shards, args.prefill_kv_block) == (1, 1, 512)
    args = parse_args(["--mesh", "2x4", "--prefill-kv-block", "128"])
    assert (args.tp, args.seq_shards, args.prefill_kv_block) == (2, 4, 128)
    assert (parse_args(["--mesh", "1X2"]).tp, parse_args(
        ["--mesh", "1X2"]).seq_shards) == (1, 2)
    for bad in ("2", "2x", "twoxfour", "2x2x2"):
        with pytest.raises(SystemExit, match="TPxNS"):
            parse_args(["--mesh", bad])


def _port_files():
    return [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
            ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    banned = {"jax", "jaxlib", "repro"}
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
    # and at run time: every module imports with jax and repro unimportable
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in _port_files()[:-1]]
    code = ("import sys\nfor m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\nimport importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)


def test_logits_masks_and_sampling_params_match_reference():
    """``apply_logits_masks`` keeps exactly the reference's support (top-k
    ties, exclusive top-p mass, min-p threshold), and greedy
    ``sample_tokens`` is the first argmax of the fp32 logits."""
    import jax.numpy as jnp

    from repro.serve import sampling as JS
    from repro_torch.serve import sampling as TS
    r = np.random.default_rng(5)
    scores = r.standard_normal((6, 40)).astype(np.float32)
    scores[0, :3] = scores[0].max() + 1.0        # a tie at the top
    top_k = np.array([0, 1, 3, 5, 40, 2], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.2, 1.0, 0.7], np.float32)
    min_p = np.array([0.0, 0.0, 0.1, 0.0, 0.3, 0.05], np.float32)
    ref = JS.apply_logits_masks(jnp.asarray(scores), jnp.asarray(top_k),
                                jnp.asarray(top_p), jnp.asarray(min_p))
    got = TS.apply_logits_masks(*[torch.tensor(a) for a in
                                  (scores, top_k, top_p, min_p)])
    np.testing.assert_array_equal(np.isfinite(np.asarray(ref)),
                                  torch.isfinite(got).numpy())
    bank = TS.bank_init(6)
    assert TS.sample_tokens(torch.tensor(scores), bank,
                            torch.zeros(6, dtype=torch.int32)).tolist() == \
        np.asarray(JS.sample_tokens(jnp.asarray(scores), JS.bank_init(6),
                                    jnp.zeros(6, jnp.int32))).tolist()
    for kw in (dict(temperature=-1.0), dict(top_k=-1), dict(top_p=0.0),
               dict(min_p=1.0), dict(seed=2 ** 32)):
        with pytest.raises(ValueError):
            JS.SamplingParams(**kw)
        with pytest.raises(ValueError):
            TS.SamplingParams(**kw)


@pytest.mark.parametrize("fill_bound", [True, False])
def test_prefill_kv_block_tokens_match_reference_engine(fill_bound):
    """``prefill_kv_block=16`` with both kernels on, fill-bounded and
    capacity-swept: the reference engine's tokens at the same config (its
    Pallas kernels in interpret mode; the reference's
    tests/test_fill_bounded.py:224 and tests/test_prefill_kernel.py:179)."""
    jc = jget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    tc = tget("qwen2-1.5b", smoke=True, compute_dtype="float32")
    p = JT.lm_init(Ctx(random.key(0)), jc)
    model = from_jax_params(jax.tree.map(np.asarray, p), tc, device="cpu")
    kw = dict(SERVE, prefill_chunk=4, decode_kernel=True,
              prefill_kernel=True, decode_kv_block=16, prefill_kv_block=16,
              fill_bound=fill_bound)
    prompts = _prompts(jc.vocab_size, seed=2)[:3]
    ref = _serve(JEngine(jc, JServeConfig(**kw), p), prompts, BUDGETS[:3])
    eng = ContinuousBatchingEngine(tc, ServeConfig(**kw), model,
                                   device="cpu")
    assert _serve(eng, prompts, BUDGETS[:3]) == ref
    assert eng.prefill_cache_size == eng.decode_cache_size == 1
