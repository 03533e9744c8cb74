"""Serve ``chip_smoke.py``'s engine phases from several source trees, one
process per run, in turns: the trees in the order given, then reversed.

    python3 tools/engine_ab.py [--rows kernel|plain|engines|all] \
        PARENT_ROOT CHANGE_ROOT [...]

``--rows kernel`` (part of the default ``all``) runs each tree's own
qwen2-1.5b phases with both ConSmax kernels: phase 5's contiguous bf16
engine (``engine_phase``: twelve greedy prompts of 200-6,000 tokens, 32
new tokens each, 8 slots x 8192 rows, chunk 512, traced) and phases 7 and
8's paged engines (``paged_engine_phase``: 16 slots over 128 pages of 256,
prefix cache, bf16 and int8 KV, each traced).

``--rows plain`` runs, through each tree's public API only (so a tree from
before the static session and the graph-safe plain walks runs too):

* ``ServeSession`` rows (``[ab-session]``): b 4 x 512 prompt tokens, 32
  greedy steps, bf16, random weights from a seed: qwen2-1.5b at full width
  with the decode kernel and with the plain decode (max_seq 32,768, the
  default), gpt2-consmax at full width with softmax (max_seq 1,024), and
  xlstm-1.3b at full width (b 2 x 256); ms per decode step (a
  ``steps``-token call's wall less a one-token call's, over ``steps - 1``)
  and tok/s, for the tree's default session and, where the tree's session
  takes ``cuda_graphs``, with ``cuda_graphs=False``;
* continuous engines with both kernel flags off (``[ab-engine]`` and
  ``[trace]``; ``--rows engines`` runs these alone): qwen2-1.5b at full
  width, 8 slots x 8192 rows, chunk 512, contiguous (``kv_chunk`` 1024)
  and paged (128 pages of 256), and gpt2-consmax with softmax and with
  softermax at full width, 8 x 1024 rows, chunk 128, ``kv_chunk`` 128,
  contiguous and paged (64 pages of 128); six requests,
  16 new tokens each, every other one sampled, served twice by one engine
  (no prefix cache; the first pass captures any graphs): the second
  pass's generated tok/s on one wall clock, each graph's capture seconds
  (with its nodes and conditional nodes where the tree counts them) and
  the graph pool's MiB, then 3 traced iterations (after 4) of the same
  requests on the same engine: wall and device-busy ms per iteration and
  the idle share; for the tree's default engine and, where it is graphed,
  with ``cuda_graphs=False``.

Each argument is a checkout of this repository (for example a ``git
archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists, and ``.`` for the working tree). Each run imports
that tree's ``chip_smoke.py`` and ``repro_torch`` and builds its kernels
into that tree's ``build/`` (a tree whose kernel sources match an earlier
one's reuses its libraries). The script prints the card's name and power
limit, then each run's lines: ``[engine]`` / ``[paged ...]`` (generated
tok/s and mean TTFT on one wall clock), ``[graphs]`` where the tree's
engines replay CUDA graphs (captures and their seconds, replays per
iteration, the graph pool's MiB), ``[trace]`` (wall and device-busy ms
per iteration, idle share, device ops and graph replays per iteration)
and the ``[ab-...]`` rows. These host-bound metrics move by machine as
much as by code, so compare trees only within one call. Needs one card.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

PRELUDE = """
import sys, numpy as np
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as C
from repro_torch.kernels import _build
_build.build()
"""
KERNEL_RUN = PRELUDE + """
lens = np.linspace(200, 6000, 12).astype(int)
C.engine_phase("qwen2-1.5b", max_seq=8192, chunk=512,
               prompt_lens=list(np.random.default_rng(2).permutation(lens)),
               new_tokens=32, seed=0, trace=True)
C.paged_engine_phase()
C.paged_engine_phase(kv_dtype="int8")
"""
PLAIN_COMMON = PRELUDE + """
import inspect, time, torch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeSession
from repro_torch.serve.sampling import SamplingParams
from repro_torch.weights import init_params

torch.backends.cuda.matmul.allow_tf32 = False
SEED = 17
HOT = dict(temperature=0.8, top_k=50, top_p=0.95, min_p=0.05)


def model_of(arch, **over):
    cfg = get_config(arch, **over)
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
"""
SESSION_RUN = PLAIN_COMMON + """
session_modes = [{}]
if "cuda_graphs" in inspect.signature(ServeSession).parameters:
    session_modes.append(dict(cuda_graphs=False))


def session_rows(tag, arch, over, serve, b, prompt, steps):
    cfg, model = model_of(arch, **over)
    scfg = ServeConfig(score_norm=cfg.score_norm, **serve)
    prompts = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, prompt)), dtype=torch.int32, device="cuda")
    for mode in session_modes:
        sess = ServeSession(cfg, scfg, model, device="cuda", **mode)
        sess.generate(prompts[:, :16], steps=3)
        walls = {}
        for n in (1, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.generate(prompts, steps=n).cpu()
            walls[n] = time.perf_counter() - t0
        ms = 1e3 * (walls[steps] - walls[1]) / (steps - 1)
        print(f"[ab-session] {tag} {mode or 'default'}: graphed "
              f"{getattr(sess, 'graphed', False)}, {ms:.3f} ms per decode "
              f"step, {b * steps / walls[steps]:.1f} tok/s", flush=True)
        del sess
        torch.cuda.empty_cache()


session_rows("qwen2-1.5b decode kernel", "qwen2-1.5b", {},
             dict(decode_kernel=True), 4, 512, 32)
session_rows("qwen2-1.5b plain decode", "qwen2-1.5b", {}, {}, 4, 512, 32)
session_rows("gpt2-consmax softmax", "gpt2-consmax",
             dict(score_norm="softmax"), dict(max_seq=1024), 4, 512, 32)
session_rows("xlstm-1.3b", "xlstm-1.3b", {}, dict(max_seq=512), 2, 256, 32)
"""
ENGINE_RUN = PLAIN_COMMON + """
def engine_rows(tag, cfg, model, scfg, new_tokens=16):
    r = np.random.default_rng(SEED)
    reqs = [(r.integers(0, cfg.vocab_size, int(n)).tolist(),
             SamplingParams(**HOT, seed=500 + i) if i % 2 else None)
            for i, n in enumerate(r.integers(scfg.max_seq // 27,
                                             int(scfg.max_seq / 2.7), 6))]
    graphed = getattr(ContinuousBatchingEngine(cfg, scfg, model,
                                               device="cuda"),
                      "graphed", False)
    torch.cuda.empty_cache()
    for mode in [{}] + ([dict(cuda_graphs=False)] if graphed else []):
        eng = ContinuousBatchingEngine(cfg, scfg, model, device="cuda",
                                       **mode)
        for _ in range(2):        # the first pass captures any graphs
            uids = [eng.submit(p, new_tokens, sampling=sp) for p, sp in reqs]
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        gen = sum(len(res[u]) for u in uids)
        name = f"{tag} {mode or 'default'}"
        caps = "; ".join(
            f"{step}{' draw' if draw else ''} {sec:.3f} s" + (
                ", {:,} nodes, {} conditional".format(
                    *eng.graph_nodes[step, draw])
                if hasattr(eng, "graph_nodes") else "")
            for (step, draw), sec in getattr(eng, "capture_seconds",
                                             {}).items())
        print(f"[ab-engine] {name}: graphed "
              f"{getattr(eng, 'graphed', False)}, {gen} generated tokens "
              f"in {wall:.3f} s ({gen / wall:.1f} tok/s)"
              + (f"; captures: {caps}; graph pool "
                 f"{eng.graph_pool_bytes / 2**20:.1f} MiB" if caps else ""),
              flush=True)
        for p, sp in reqs:
            eng.submit(p, new_tokens, sampling=sp)
        C.trace_steps(eng, name, skip=4, steps=3)
        del eng
        torch.cuda.empty_cache()


for arch, over, common, pages in (
        ("qwen2-1.5b", {}, dict(max_seq=8192, prefill_chunk=512,
                                kv_chunk=1024), dict(page_size=256,
                                                     num_pages=128)),
        ("gpt2-consmax", dict(score_norm="softmax"),
         dict(max_seq=1024, prefill_chunk=128, kv_chunk=128),
         dict(page_size=128, num_pages=64)),
        ("gpt2-consmax", dict(score_norm="softermax"),
         dict(max_seq=1024, prefill_chunk=128, kv_chunk=128),
         dict(page_size=128, num_pages=64))):
    cfg, model = model_of(arch, **over)
    for kind, extra in (("contiguous", {}), ("paged", dict(
            paged_kv=True, prefix_cache=False, **pages))):
        scfg = ServeConfig(max_slots=8, score_norm=cfg.score_norm,
                           **common, **extra)
        engine_rows(f"{arch} {cfg.score_norm} flags off {kind}", cfg, model,
                    scfg)
    del model
    torch.cuda.empty_cache()
"""
KEEP = ("[engine] qwen2-1.5b: 12", "[paged bfloat16] qwen2-1.5b",
        "[paged int8] qwen2-1.5b", "[graphs]", "[trace]", "[ab-")


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", choices=("kernel", "plain", "engines", "all"),
                    default="all")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    runs = {"kernel": [KERNEL_RUN], "plain": [SESSION_RUN, ENGINE_RUN],
            "engines": [ENGINE_RUN],
            "all": [KERNEL_RUN, SESSION_RUN, ENGINE_RUN]}[args.rows]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = [Path(r).resolve() for r in args.roots]
    first = trees[0] / "build" / "kernels"
    for tree in trees + trees[::-1]:
        if tree != trees[0] and first.is_dir():
            # same sources, same hashed file names: only missing ones build
            shutil.copytree(first, tree / "build" / "kernels",
                            dirs_exist_ok=True)
        for run in runs:
            proc = subprocess.run([sys.executable, "-c", run], cwd=tree,
                                  capture_output=True, text=True,
                                  timeout=900)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(KEEP)]
            print(f"{tree}: exit {proc.returncode}", flush=True)
            for ln in lines:
                print(f"  {ln[:700]}", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
