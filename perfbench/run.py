"""Run one cell of the port's serving benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, the last
line of standard output, and each number the output check compared beside
its limit as the last lines of standard error. Exits non-zero, with no
result, without a CUDA card (or with fewer than the cell asks for), without
the port's sources beside ``perfbench/``, or when the process has loaded
JAX or the JAX package."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str, code: int):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8-kv", "fp8-operands"),
                    help="not a benchmark run: judge at each served "
                         "position the token the reference puts first on "
                         "fp8 operands (fp8-operands, the output check's "
                         "control), or serve with the port's fp8_e4m3 KV "
                         "cache (fp8-kv)")
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        _fail(f"the port's sources are not at {src / 'repro_torch'}", 3)
    # every cache of the program inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(src), str(ROOT)]

    import torch
    from perfbench import harness as H

    cell = H.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card", 2)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", 2)
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != src / "repro_torch":
        _fail(f"repro_torch imported from {repro_torch.__file__}, not from "
              f"{src}", 3)
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    result = H.run(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t_start=T_START,
                   control=args.control)
    found = H.forbidden_modules(sys.modules)
    if found:
        _fail(f"loaded modules of JAX or the JAX package: {found}", 4)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
