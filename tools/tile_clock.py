"""Split the attention mainloop's tile step into its parts, on one card.

    python3 tools/tile_clock.py [TREE ...]

Each TREE is a checkout of this repository (default: this one). For each,
the script compiles that tree's ``consmax_prefill`` library with
``-DATTN_TILE_CLOCK`` into ``build/tile_clock/<n>/`` (one nvcc per tree,
all at once): an instantiation of ``attn_walk_kernel`` in which thread 0 of
every consumer warpgroup stamps ``clock64()`` at each tile's points (the
``full`` wait's start and end, S issued and landed, the epilogue's end,
P V issued and landed, the stage released) and at its walk's (entry, the
tile loop's start and end, the rows stored, the combine done). The
kernels' own build never defines the macro. It binds the library through
this tree's ops (as ``tools/mainloop_ab.py`` does) and runs
``chip_smoke.py``'s timed prefill shapes: qwen2-1.5b (12 heads, 2 KV heads,
dk 128) c 512 at fill 4096, bf16 and int8, contiguous and paged at page
size 256, at prefill_kv_block 512 and at one shard; gemma2-2b's local layer
(8 heads, 4 KV heads, dk 256, window 4096, softcap 50) c 512 at fill 6656,
bf16 and int8 contiguous, at 512 and at one shard. Each launch runs after
a 256 MB read (L2 cold, as the serving path finds it).

Per case it prints the median cycles per tile of each segment, the tile
period (one tile's ``full`` wait to the next's), and the cycles per walk
outside the tile loop, with microseconds at the card's maximum SM clock,
and the launch's time with the stamps on and off (CUDA events, 20
launches). The card's name and power limit come first. Everything also
goes to ``build/tile_clock/split.json``. Needs one card.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as CS  # noqa: E402
import mainloop_ab as AB  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
import repro_torch.kernels.consmax_prefill.ops as PO  # noqa: E402

CAP = 160                       # tiles stamped per walk (one shard: 128)
TILE = ("full wait", "S issue", "S product", "epilogue", "P V issue",
        "P V product", "release")          # segments between the points
WALK = ("before the loop", "after the loop", "combine")


def build(trees):
    procs, libs = {}, {}
    t0 = time.perf_counter()
    for n, tree in enumerate(trees):
        kdir = tree / "src/repro_torch/kernels"
        out = ROOT / "build/tile_clock" / str(n)
        out.mkdir(parents=True, exist_ok=True)
        libs[n] = out / "libconsmax_prefill.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DATTN_TILE_CLOCK",
               f"-I{kdir / 'csrc'}", "-o", str(libs[n]),
               str(kdir / "consmax_prefill/csrc/consmax_prefill.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {trees[n]}:\n{log}")
        print(f"[clock] built {trees[n]} with the stamps "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return libs


def cases():
    """name -> (launch(), plan arguments) at chip_smoke.py's timed shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for arch, H, hkv, dk, idx, kw in (
            ("qwen2-1.5b", 12, 2, 128, 3584,
             dict(window=0, softcap=0.0)),
            ("gemma2-2b", 8, 4, 256, 6144,
             dict(window=4096, softcap=50.0))):
        c, L = 512, 8192
        kw = dict(kw, merged=True, scale=1.0)
        q = CS._rand(gen, (1, c, H, dk), dk ** -0.5)
        k, v = CS._rand(gen, (1, L, hkv, dk)), CS._rand(gen, (1, L, hkv, dk))
        beta, gamma = CS._head_params(gen, H)
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([c], dtype=torch.int32, device="cuda")
        kq, ks, _ = CS._quantize(k, "int8")
        vq, vs, _ = CS._quantize(v, "int8")
        (kp, vp, kqp, vqp, ksp, vsp), table = CS._paginate_rows(
            [k, v, kq, vq, ks, vs], [idx + c], 256, 64, seed=7)
        forms = {"bf16": (k, v, {}), "int8": (kq, vq, dict(k_scale=ks,
                                                           v_scale=vs))}
        paged = {"bf16": (kp, vp, {}), "int8": (kqp, vqp, dict(
            k_scale=ksp, v_scale=vsp))}
        for bk in (512, L):
            shard = "bk 512" if bk < L else "one shard"
            for dt in ("bf16", "int8"):
                kk, vv, sc = forms[dt]
                out[f"{arch} {dt} contiguous {shard}"] = (
                    functools.partial(PO.consmax_prefill_cuda, q, kk, vv, ti,
                                      tn, beta, gamma, bk=bk, **sc, **kw),
                    (q, kk, vv, ti, tn, beta, gamma, dict(bk=bk, **sc)))
                if arch != "qwen2-1.5b":
                    continue
                kk, vv, sc = paged[dt]
                out[f"{arch} {dt} paged 256 {shard}"] = (
                    functools.partial(PO.consmax_prefill_paged_cuda, q, kk,
                                      vv, table, ti, tn, beta, gamma, bk=bk,
                                      **sc, **kw),
                    (q, kk, vv, ti, tn, beta, gamma,
                     dict(bk=bk, page_table=table, **sc)))
    return out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def split(stamps):
    """Median cycles of each segment over every stamped tile and walk of
    one launch; stamps (CTAs, 2, CAP + 1, 8) int64, 0 = not stamped."""
    tiles = stamps[:, :, :CAP]
    walks = stamps[:, :, CAP]
    live = walks[:, :, 1] > 0                  # walks that reached the loop
    segs = {name: [] for name in (*TILE, "tile", "period", *WALK)}
    n_tiles = []
    for cta, cw in live.nonzero().tolist():
        t = tiles[cta, cw]
        n = int((t[:, 0] > 0).sum())
        n_tiles.append(n)
        for j in range(n):
            row = t[j].tolist()
            for i, name in enumerate(TILE):
                segs[name].append(row[i + 1] - row[i])
            segs["tile"].append(row[7] - row[0])
            if j + 1 < n:
                segs["period"].append(int(t[j + 1, 0]) - row[0])
        w = walks[cta, cw].tolist()
        segs["before the loop"].append(w[1] - w[0])
        segs["after the loop"].append(w[3] - w[2])
        if w[4]:
            segs["combine"].append(w[4] - w[3])
    res = {name: median(v) for name, v in segs.items()}
    res["walks"] = len(n_tiles)
    res["tiles"] = sum(n_tiles)
    res["tiles per walk"] = median(n_tiles)
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tile_clock: no CUDA device")
    trees = [Path(a).resolve() for a in sys.argv[1:]] or [ROOT]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    name, power, clock = (x.strip() for x in smi.stdout.split(","))
    mhz = float(clock.split()[0])
    print(f"{name}, {power}", flush=True)
    paths = build(trees)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    report = {"device": name, "power_limit": power, "max_sm_mhz": mhz,
              "cap": CAP, "trees": {}}
    all_cases = cases()
    ops_lib = PO._lib
    for n, tree in enumerate(trees):
        PO._lib = ops_lib
        lib = AB.bind(paths[n], PO)
        lib.attn_tile_clock.argtypes = [AB.ctypes.c_void_p, AB.ctypes.c_int]
        PO._lib = lambda lib=lib: lib
        rows = {}
        for case, (fn, (q, k, v, ti, tn, beta, gamma, pkw)) in (
                all_cases.items()):
            plan, _ = PO.prefill_plan("consmax_prefill", q, k, v, ti, tn,
                                      beta, gamma, **pkw)
            ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
            buf = torch.zeros((ctas, 2, CAP + 1, 8), dtype=torch.int64,
                              device="cuda")
            _build.check(lib, lib.attn_tile_clock(buf.data_ptr(), CAP),
                         "attn_tile_clock")
            fn()
            buf.zero_()
            flush.max()
            fn()
            torch.cuda.synchronize()
            res = split(buf.cpu())
            res["ms stamped"] = CS._time_ms(fn, flush, 20)
            _build.check(lib, lib.attn_tile_clock(None, CAP),
                         "attn_tile_clock")
            res["ms"] = CS._time_ms(fn, flush, 20)
            res["grid"] = list(plan.grid)
            rows[case] = res
            us = lambda c: f"{c:.0f} ({c / mhz:.3f} us)"  # noqa: E731
            print(f"[clock] {tree.name or tree} {case}: grid {plan.grid}, "
                  f"{res['walks']} walks, {res['tiles']} tiles (median "
                  f"{res['tiles per walk']} a walk); median cycles per tile: "
                  + ", ".join(f"{s} {us(res[s])}" for s in TILE)
                  + f"; tile {us(res['tile'])}, period {us(res['period'])}; "
                  "per walk: " + ", ".join(f"{s} {us(res[s])}" for s in WALK)
                  + f"; launch {res['ms'] * 1e3:.1f} us "
                  f"({res['ms stamped'] * 1e3:.1f} us stamped)", flush=True)
        report["trees"][str(tree)] = rows
    out = ROOT / "build/tile_clock"
    out.mkdir(parents=True, exist_ok=True)
    (out / "split.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
