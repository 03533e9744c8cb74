"""Serve ``chip_smoke.py``'s qwen2-1.5b engine phases from several source
trees, one process per run, in turns: the trees in the order given, then
reversed.

    python3 tools/engine_ab.py PARENT_ROOT CHANGE_ROOT [...]

Each run calls its tree's own phases: phase 5's contiguous bf16 engine
(``engine_phase``: twelve greedy prompts of 200-6,000 tokens, 32 new
tokens each, 8 slots x 8192 rows, chunk 512, traced) and phases 7 and 8's
paged engines (``paged_engine_phase``: 16 slots over 128 pages of 256,
prefix cache, bf16 and int8 KV, each traced). Each argument is a checkout
of this repository (for example a ``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists, and ``.`` for the
working tree). Each run imports that tree's ``chip_smoke.py`` and
``repro_torch`` and builds its kernels into that tree's ``build/`` (a tree
whose kernel sources match an earlier one's reuses its libraries). The
script prints the card's name and power limit, then each run's lines:
``[engine]`` / ``[paged ...]`` (generated tok/s and mean TTFT on one wall
clock), ``[graphs]`` where the tree's engines replay CUDA graphs (captures
and their seconds, replays per iteration, the graph pool's MiB) and
``[trace]`` (wall and device-busy ms per iteration, idle share, device ops
and graph replays per iteration). These host-bound metrics move by machine
as much as by code, so compare trees only within one call. Needs one card.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

RUN = """
import sys, numpy as np
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as C
from repro_torch.kernels import _build
_build.build()
lens = np.linspace(200, 6000, 12).astype(int)
C.engine_phase("qwen2-1.5b", max_seq=8192, chunk=512,
               prompt_lens=list(np.random.default_rng(2).permutation(lens)),
               new_tokens=32, seed=0, trace=True)
C.paged_engine_phase()
C.paged_engine_phase(kv_dtype="int8")
"""
KEEP = ("[engine] qwen2-1.5b: 12", "[paged bfloat16] qwen2-1.5b",
        "[paged int8] qwen2-1.5b", "[graphs]", "[trace]")


def main(roots):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = [Path(r).resolve() for r in roots]
    first = trees[0] / "build" / "kernels"
    for tree in trees + trees[::-1]:
        if tree != trees[0] and first.is_dir():
            # same sources, same hashed file names: only missing ones build
            shutil.copytree(first, tree / "build" / "kernels",
                            dirs_exist_ok=True)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(KEEP)]
        print(f"{tree}: exit {proc.returncode}", flush=True)
        for ln in lines:
            print(f"  {ln[:700]}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
