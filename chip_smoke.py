"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. header: the card's ``nvidia-smi`` name and power limit, torch and CUDA;
2. build: every CUDA kernel of the path, from ``src/repro_torch`` (nvcc,
   one process per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (qwen2-1.5b: 8 slots x 8192 rows, 2 KV heads,
   GQA group 6, head_dim 128, bf16; prefill chunk 512) and the
   gpt2-consmax engine's (8 x 1024 rows, MHA, head_dim 64; chunk 128),
   plus small window / softcap / unmerged cases; error, kernel and plain
   times, bound;
4. model: full-width qwen2-1.5b logits with both kernels vs the plain
   walks on a small input;
5. engine: full-width qwen2-1.5b (28 layers, random weights from a seed)
   served by ``ContinuousBatchingEngine`` with both kernels, 12 greedy
   requests; every request finishes, both kernels ran, and one request
   served alone equals its tokens served among the others;
6. engine: full-width gpt2-consmax (MHA, g = 1), the same checks.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. TF32 is switched off for fp32 matmuls
and convolutions, so the plain versions run in full fp32.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
TOL_NOTE = ("|kernel - plain| <= 2^-7 * sum_j p_j |v_j| elementwise: bf16 "
            "output rounding and (prefill) bf16 weights are each 2^-9 "
            "relative per term; and per output row (a decode slot, a "
            "prefill query row) ||kernel - plain|| <= 2^-7 ||plain||, four "
            "times the 2^-9 rounding, which one lost or doubled 64-row KV "
            "tile of an 8192-row slot (~9 % of ||plain||) would exceed")
REL_L2_BOUND = 2.0 ** -7
_worst_rel = [0.0]          # largest per-row relative L2 error of the run


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, flush, reps):
    """Mean device time of ``fn`` over ``reps`` calls, each after a write
    of ``flush`` that evicts the 50 MB L2 (the serving path reads every
    layer's cache cold)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check(name, got, ref, ref_absv):
    """Elementwise bound against ``ref_absv`` = sum_j p_j |v_j|, and a
    relative L2 bound per output row (the trailing (H, dk) of each slot or
    query row) over the rows whose plain output is not all zero; the
    all-zero rows (no visible key) are held by the elementwise bound."""
    err = (got.float() - ref.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= 2.0 ** -7 * ref_absv.float() + 1e-6).all())
    e = float(err.max())
    ref_n = ref.float().flatten(-2).norm(dim=-1)
    err_n = err.flatten(-2).norm(dim=-1)
    live = ref_n > 0
    rel = float((err_n[live] / ref_n[live]).max()) if live.any() else 0.0
    ok = ok and rel <= REL_L2_BOUND
    _worst_rel[0] = max(_worst_rel[0], rel)
    _log(f"[kernels] {name}: max_abs_err {e:.3e} "
         f"(max |plain| {float(ref.float().abs().max()):.3e}), max row "
         f"relative L2 {rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return e


def _rand(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _head_params(gen, H):
    beta = 0.5 + 2.0 * torch.rand(H, generator=gen, device="cuda")
    return beta, torch.full((H,), 100.0, device="cuda")


def kernel_phase(flush):
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, L, H, hkv, dk, bk, c = 8, 8192, 12, 2, 128, 256, 512
    rows = {}

    # ---- decode: 8 slots, mixed fills (valid rows = index + 1): a free
    # slot (index 0), a shard boundary, mid-shard, long and full slots
    lengths = torch.tensor([1, 256, 257, 1000, 3000, 4096, 8191, 8192],
                           dtype=torch.int32, device="cuda")
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    k, v = _rand(gen, (b, L, hkv, dk)), _rand(gen, (b, L, hkv, dk))
    beta, gamma = _head_params(gen, H)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    got = consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw)
    ref = consmax_decode_ref(q.float(), k, v, lengths, beta, gamma, **kw)
    err = _check("decode b=8 L=8192 mixed fills", got, ref,
                 consmax_decode_ref(q.float(), k, v.abs(), lengths, beta,
                                    gamma, **kw))
    ms = _time_ms(lambda: consmax_decode_cuda(q, k, v, lengths, beta, gamma,
                                              bk=bk, **kw), flush, 50)
    plain_ms = _time_ms(lambda: consmax_decode_ref(q, k, v, lengths, beta,
                                                   gamma, **kw), flush, 5)
    fill = int(lengths.sum())
    bound, by = _bound_ms(fill * hkv * dk * 2 * 2 + 2 * b * H * dk * 2,
                          4 * fill * H * dk)
    rows["consmax_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by)

    # ---- prefill: the engine's (1, 512) chunk at fills 0 (a 0-length
    # chunk), 512, 4096 (the timed case), a ragged 200-row tail, and the
    # chunk that fills the cache; then 8 slots at once
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = _rand(gen, (1, L, hkv, dk)), _rand(gen, (1, L, hkv, dk))
    errs = []
    for idx, n in [(0, 0), (0, 512), (3584, 512), (4000, 200), (7680, 512)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw)
        ref = consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw)
        errs.append(_check(f"prefill c=512 index={idx} len={n}", got, ref,
                           consmax_prefill_ref(q1, k1, v1.abs(), ti, tn,
                                               beta, gamma, **kw)))
    qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
    ib = torch.tensor([0, 0, 256, 1000, 3584, 4000, 7000, 7680],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 512, 512, 77, 512, 300, 512, 512],
                      dtype=torch.int32, device="cuda")
    errs.append(_check("prefill b=8 c=512 mixed fills",
                       consmax_prefill_cuda(qb, k, v, ib, nb, beta, gamma,
                                            **kw),
                       consmax_prefill_ref(qb, k, v, ib, nb, beta, gamma,
                                           **kw),
                       consmax_prefill_ref(qb, k, v.abs(), ib, nb, beta,
                                           gamma, **kw)))
    idx, n = 3584, 512
    ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
    tn = torch.tensor([n], dtype=torch.int32, device="cuda")
    ms = _time_ms(lambda: consmax_prefill_cuda(q1, k1, v1, ti, tn, beta,
                                               gamma, **kw), flush, 50)
    plain_ms = _time_ms(lambda: consmax_prefill_ref(q1, k1, v1, ti, tn, beta,
                                                    gamma, **kw), flush, 5)
    kvl = idx + n
    visible = sum(min(idx + i + 1, kvl) for i in range(c))   # causal keys
    bound, by = _bound_ms(kvl * hkv * dk * 2 * 2 + 2 * c * H * dk * 2,
                          4 * visible * H * dk)
    rows["consmax_prefill"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by)

    # ---- the options qwen2-1.5b does not use, and the MHA (g = 1) edge
    for name, kwx in [("window", dict(window=300)),
                      ("softcap", dict(softcap=30.0)),
                      ("unmerged", dict(merged=False))]:
        kx = dict(kw, **kwx)
        sl = slice(0, 1024)
        ks, vs = k[:, sl].contiguous(), v[:, sl].contiguous()
        lx = lengths.clamp(max=1024)
        _check(f"decode {name}",
               consmax_decode_cuda(q, ks, vs, lx, beta, gamma, bk=bk, **kx),
               consmax_decode_ref(q.float(), ks, vs, lx, beta, gamma, **kx),
               consmax_decode_ref(q.float(), ks, vs.abs(), lx, beta, gamma,
                                  **kx))
        ti = torch.tensor([400], dtype=torch.int32, device="cuda")
        tn = torch.tensor([c], dtype=torch.int32, device="cuda")
        ks1, vs1 = ks[:1].contiguous(), vs[:1].contiguous()
        _check(f"prefill {name}",
               consmax_prefill_cuda(q1, ks1, vs1, ti, tn, beta, gamma, **kx),
               consmax_prefill_ref(q1, ks1, vs1, ti, tn, beta, gamma, **kx),
               consmax_prefill_ref(q1, ks1, vs1.abs(), ti, tn, beta, gamma,
                                   **kx))
    gpt2_kernel_checks(gen, bk, kw)
    return rows


def gpt2_kernel_checks(gen, bk, kw):
    """The gpt2-consmax engine's shapes (MHA, g = 1, head_dim 64): 8 slots
    x 1024 rows, decode shard bk, prefill chunk 128."""
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_cuda
    from repro_torch.kernels.consmax_decode.ref import consmax_decode_ref
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_cuda
    from repro_torch.kernels.consmax_prefill.ref import consmax_prefill_ref

    b, L, H, dk, c = 8, 1024, 6, 64, 128
    k, v = _rand(gen, (b, L, H, dk)), _rand(gen, (b, L, H, dk))
    beta, gamma = _head_params(gen, H)
    q = _rand(gen, (b, H, dk), dk ** -0.5)
    lengths = torch.tensor([1, 64, 255, 256, 257, 500, 1023, 1024],
                           dtype=torch.int32, device="cuda")
    _check("gpt2 decode MHA b=8 L=1024 mixed fills",
           consmax_decode_cuda(q, k, v, lengths, beta, gamma, bk=bk, **kw),
           consmax_decode_ref(q.float(), k, v, lengths, beta, gamma, **kw),
           consmax_decode_ref(q.float(), k, v.abs(), lengths, beta, gamma,
                              **kw))
    q1 = _rand(gen, (1, c, H, dk), dk ** -0.5)
    k1, v1 = k[:1].contiguous(), v[:1].contiguous()
    # a 0-length chunk, the first chunk, a ragged tail, the chunk that
    # ends the cache
    for idx, n in [(0, 0), (0, 128), (640, 59), (896, 128)]:
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([n], dtype=torch.int32, device="cuda")
        _check(f"gpt2 prefill MHA c=128 index={idx} len={n}",
               consmax_prefill_cuda(q1, k1, v1, ti, tn, beta, gamma, **kw),
               consmax_prefill_ref(q1, k1, v1, ti, tn, beta, gamma, **kw),
               consmax_prefill_ref(q1, k1, v1.abs(), ti, tn, beta, gamma,
                                   **kw))
    qb = _rand(gen, (b, c, H, dk), dk ** -0.5)
    ib = torch.tensor([0, 0, 128, 200, 384, 640, 700, 896],
                      dtype=torch.int32, device="cuda")
    nb = torch.tensor([0, 128, 128, 31, 128, 59, 128, 128],
                      dtype=torch.int32, device="cuda")
    _check("gpt2 prefill MHA b=8 c=128 mixed fills",
           consmax_prefill_cuda(qb, k, v, ib, nb, beta, gamma, **kw),
           consmax_prefill_ref(qb, k, v, ib, nb, beta, gamma, **kw),
           consmax_prefill_ref(qb, k, v.abs(), ib, nb, beta, gamma, **kw))


def model_phase():
    """Full-width qwen2-1.5b logits, both kernels vs the plain walks, on a
    small input: a ragged 64-token chunk per slot, then 4 decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params

    cfg = get_config("qwen2-1.5b")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    r = np.random.default_rng(1)
    toks = torch.tensor(r.integers(0, cfg.vocab_size, (2, 68)),
                        dtype=torch.int32, device="cuda")
    lens = torch.tensor([64, 41], dtype=torch.int32, device="cuda")
    outs = {}
    with torch.no_grad():
        for kernels in (False, True):
            kw = dict(decode_kernel=kernels, prefill_kernel=kernels,
                      merged=True)
            caches = T.init_caches(cfg, 2, 1024, device="cuda")
            lg, caches = T.lm_apply(model, cfg, tokens=toks[:, :64],
                                    caches=caches, prefill_append=lens,
                                    logits_index=lens - 1, **kw)
            seq = [lg.float()]
            for t in range(4):
                idx = T.cache_index(caches)
                lg, caches = T.lm_apply(model, cfg,
                                        tokens=toks[:, 64 + t:65 + t],
                                        caches=caches,
                                        positions=idx[:, None], **kw)
                seq.append(lg.float())
            outs[kernels] = torch.stack(seq)
    plain, kern = outs[False], outs[True]
    rel = float((kern - plain).norm() / plain.norm())
    ok = (bool(torch.isfinite(kern).all())
          and kern.shape == (5, 2, 1, cfg.vocab_size) and rel <= 2 ** -4)
    _log(f"[model] qwen2-1.5b logits, kernels vs plain walks: relative L2 "
         f"error {rel:.3e} (bound 2^-4: bf16 rounds at other places in the "
         f"two paths, compounded over 28 layers), max |diff| "
         f"{float((kern - plain).abs().max()):.3e} of max |logit| "
         f"{float(plain.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("model logits with kernels disagree")
    del model


def trace_steps(eng, arch, *, skip, steps):
    """Where an engine iteration's time goes: ``steps`` iterations (after
    ``skip``) under ``torch.profiler``; device busy time is the union of
    the device events' intervals. The profiler adds host time, so the
    traced wall per step is an upper bound on the untraced one."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), defaultdict(float)
    for e in sorted(dev, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        by_name[e.name[:40]] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = busy / 1e3
    _log(f"[trace] {arch}: {steps} engine iterations under torch.profiler: "
         f"wall {wall * 1e3 / steps:.1f} ms/iteration, device busy "
         f"{busy_ms / steps:.1f} ms/iteration (idle share "
         f"{1 - busy_ms / (wall * 1e3):.3f}), {len(dev) / steps:.0f} device "
         f"ops/iteration; device time by kernel: "
         + ", ".join(f"{n} {t / 1e3 / steps:.2f} ms" for n, t in top))


def engine_phase(arch, *, max_seq, chunk, prompt_lens, new_tokens, seed,
                 trace=False):
    """Serve ``prompt_lens`` greedy requests on the full-width ``arch``
    with both kernels; returns the launch counts of that run. ``trace``:
    afterwards, trace a few iterations of a fresh run of the same
    requests."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.consmax_decode.ops import consmax_decode_op
    from repro_torch.kernels.consmax_prefill.ops import consmax_prefill_op
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.weights import init_params

    cfg = get_config(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    scfg = ServeConfig(max_slots=8, max_seq=max_seq, prefill_chunk=chunk,
                       decode_kernel=True, prefill_kernel=True,
                       score_norm=cfg.score_norm)
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in prompt_lens]

    def serve(batch):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        uids = [eng.submit(prompts[i], new_tokens) for i in batch]
        consmax_decode_op.launches = consmax_prefill_op.launches = 0
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"consmax_decode": consmax_decode_op.launches,
                  "consmax_prefill": consmax_prefill_op.launches}
        return eng, [results.get(u) for u in uids], wall, counts

    eng, toks, wall, counts = serve(range(len(prompts)))
    if any(t is None or len(t) != new_tokens for t in toks):
        raise AssertionError(f"{arch}: a request did not finish")
    chunks = sum(-(-n // chunk) for n in prompt_lens)
    if counts["consmax_prefill"] != chunks * cfg.n_layers:
        raise AssertionError(f"{arch}: prefill kernel launches {counts}")
    if counts["consmax_decode"] < cfg.n_layers:
        raise AssertionError(f"{arch}: decode kernel never launched")
    ttft = np.mean(list(eng.ttft.values()))
    gen = sum(len(t) for t in toks)
    _log(f"[engine] {arch}: {len(prompts)} requests, {sum(prompt_lens)} "
         f"prompt + {gen} generated tokens in {wall:.3f} s on one wall "
         f"clock: {gen / wall:.1f} generated tok/s, "
         f"{sum(prompt_lens) / wall:.1f} prompt tok/s, mean TTFT "
         f"{ttft:.3f} s; {chunks} prefill chunks, "
         f"{counts['consmax_decode'] // cfg.n_layers} decode steps; kernel "
         f"launches {counts}")
    del eng
    solo = min(range(len(prompts)), key=lambda i: prompt_lens[i])
    _, alone, _, _ = serve([solo])
    same = alone[0] == toks[solo]
    _log(f"[engine] {arch}: request {solo} served alone == served among "
         f"the others: {same}")
    if not same:
        raise AssertionError(f"{arch}: solo and batched tokens differ")
    if trace:
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda")
        for p in prompts:
            eng.submit(p, new_tokens)
        trace_steps(eng, arch, skip=8, steps=6)
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    _log(smi)
    _log(f"[header] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("[header] TF32 off for fp32 matmuls and cuDNN convolutions")

    t0 = time.perf_counter()
    built = _build.build()
    _log(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s "
         f"(one nvcc per source, in parallel)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    rows = kernel_phase(flush)
    del flush
    for name, row in rows.items():
        _log(f"[kernels] {name}: {row['ms'] * 1e3:.1f} us (plain "
             f"{row['plain_ms'] * 1e3:.1f} us), bound "
             f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}")
    _log(f"[kernels] largest row relative L2 error of all checks "
         f"{_worst_rel[0]:.3e} (bound {REL_L2_BOUND:.3e})")
    _log(f"[kernels] tolerance: {TOL_NOTE}; no single PyTorch call "
         f"computes ConSmax attention, so library_ms is null "
         f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    model_phase()
    _log(f"[model] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lens = np.linspace(200, 6000, 12).astype(int)
    counts = engine_phase("qwen2-1.5b", max_seq=8192, chunk=512,
                          prompt_lens=list(np.random.default_rng(2)
                                           .permutation(lens)),
                          new_tokens=32, seed=0, trace=True)
    _log(f"[engine] qwen2-1.5b phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_phase("gpt2-consmax", max_seq=1024, chunk=128,
                 prompt_lens=[20, 700, 131, 256, 999, 64], new_tokens=16,
                 seed=3)
    _log(f"[engine] gpt2-consmax phase {time.perf_counter() - t0:.1f} s")

    src = {"consmax_decode": ("src/repro_torch/kernels/consmax_decode/csrc/"
                              "consmax_decode.cu",
                              "src/repro/kernels/consmax_decode/kernel.py:171"),
           "consmax_prefill": ("src/repro_torch/kernels/consmax_prefill/csrc/"
                               "consmax_prefill.cu",
                               "src/repro/kernels/consmax_prefill/kernel.py:128")}
    kernels = [dict(name=name, route="cuda", source=src[name][0],
                    replaces=src[name][1], launches=counts[name],
                    **rows[name], library_ms=None) for name in src]
    _log(f"[done] {time.perf_counter() - t_start:.1f} s")
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
