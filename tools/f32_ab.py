"""Time the fp32 full-sequence attention kernel (csrc/attn_f32.cuh, the
``consmax_attn`` and ``softmax_attn`` libraries' fp32 entry points) of
several source trees, and of cut-down variants of this tree's kernel, in
one process, on one card.

    python3 tools/f32_ab.py PARENT_ROOT CHANGE_ROOT [...] [--variants]

Each tree argument is a checkout of this repository (for example a ``git
archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists, and ``.`` for the working tree). For each tree the
script compiles both libraries from that tree's sources with this tree's
nvcc flags, all in parallel, into ``build/f32_ab/<n>/`` and binds them
through this tree's ops (the fp32 entry points have kept their
signatures). With ``--variants`` it also compiles this tree's kernel with
one part taken out, to show where its time goes (the outputs of these are
wrong by design, and only timed):

    1xtf32    one TF32 product instead of three (hi.hi only)
    nosplit   the operands fed to the tensor cores unsplit (lo = hi = x)
    noexp     the ConSmax weight replaced by the scaled score (no expf,
              no division)
    noS       no S = Q K^T product (the weights of zero scores)

Then, at the paper's qwen2-1.5b shape (b 2 x s 4096, 12 / 2 heads, dk 128,
causal, fp32), it times each build's ConSmax Eq. 2, Eq. 3 and softmax
forms in turns, the trees in the order given and then reversed (CUDA
events, L2 flushed before each call), and prints each time and each
tree's largest difference from the first tree's output. Prints the card's
name and power limit first. Needs one card.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
import repro_torch.kernels.consmax_attn.ops as AO  # noqa: E402
import repro_torch.kernels.softmax_attn.ops as SO  # noqa: E402

NAMES = {"consmax_attn": AO, "softmax_attn": SO}
VARIANTS = {
    "1xtf32": [("mma_tf32(part[j], al[x], bh[j][x]);", ""),
               ("mma_tf32(part[j], ah[x], bl[j][x]);", ""),
               ("mma_tf32(part[n][h], pl[x], bh[n][x][h]);", ""),
               ("mma_tf32(part[n][h], ph[x], bl[n][x][h]);", "")],
    "nosplit": [("  hi = tf32_rna(x);\n"
                 "  lo = tf32_rna(x - __uint_as_float(hi));",
                 "  hi = __float_as_uint(x);\n  lo = hi;")],
    "noexp": [("? consmax_weight<kForm == kF32Eq3>(sc[j][e] * a.scale,",
               "? (sc[j][e] * a.scale +"),
              ("bet[i], gam[i], cm[i],\n", "bet[i] + gam[i] + cm[i] +\n")],
    "noS": [("for (int kk = 0; kk < DK / 16; ++kk) {",
             "for (int kk = 0; kk < 0; ++kk) {")],
}


def sources(label, tree):
    """The csrc directory of ``tree``, or for a variant a copy of this
    tree's with the variant's edits."""
    if label not in VARIANTS:
        return tree / "src/repro_torch/kernels"
    out = ROOT / "build/f32_ab/src" / label
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "src/repro_torch/kernels", out)
    f = out / "csrc/attn_f32.cuh"
    text = f.read_text()
    for a, b in VARIANTS[label]:
        if a not in text:
            raise RuntimeError(f"variant {label}: edit no longer applies")
        text = text.replace(a, b)
    f.write_text(text)
    return out


def build(builds):
    """One nvcc per (build, library), all at once; returns the library
    paths."""
    procs, libs = {}, {}
    t0 = time.perf_counter()
    for n, (label, tree) in enumerate(builds):
        kdir = sources(label, tree)
        out = ROOT / "build/f32_ab" / str(n)
        out.mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            lib = out / f"lib{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{kdir / 'csrc'}",
                   "-o", str(lib), str(kdir / name / "csrc" / f"{name}.cu")]
            procs[n, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            libs[n, name] = lib
    for (n, name), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {builds[n][0]} {name}:\n"
                               f"{log}")
        regs = re.findall(r"Compiling entry function '\w*attn_f32_kernelILi"
                          r"128ELi(\d)E\w*'.*?Used (\d+) registers", log,
                          re.S)
        print(f"[f32_ab] built {builds[n][0]} {name}: dk 128 fp32 kernel "
              f"registers {sorted({int(r) for _, r in regs})} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return libs


def bind(path, module):
    """The library at ``path`` with ``module``'s argument types set."""
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    load = _build.load
    _build.load = lambda name: lib
    try:
        return module._lib.__wrapped__()
    finally:
        _build.load = load


def main():
    if not torch.cuda.is_available():
        raise SystemExit("f32_ab: no CUDA device")
    args = [a for a in sys.argv[1:] if a != "--variants"]
    builds = [(Path(a).resolve().name or a, Path(a).resolve())
              for a in args]
    if "--variants" in sys.argv:
        builds += [(v, ROOT) for v in VARIANTS]
    if not builds:
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    paths = build(builds)
    libs = {n: {name: bind(paths[n, name], mod)
                for name, mod in NAMES.items()} for n in range(len(builds))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 4096, 12, 128), generator=gen, device="cuda")
    k = torch.randn((2, 4096, 2, 128), generator=gen, device="cuda")
    v = torch.randn((2, 4096, 2, 128), generator=gen, device="cuda")
    beta, gamma = CS._head_params(gen, 12)
    cases = {
        "consmax_attention fp32 Eq. 2": lambda: AO.consmax_attention_cuda(
            q, k, v, beta, gamma),
        "consmax_attention fp32 Eq. 3": lambda: AO.consmax_attention_cuda(
            q, k, v, beta, gamma, merged=True),
        "softmax_attention fp32": lambda: SO.softmax_attention_cuda(q, k, v),
    }
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    order = list(range(len(builds)))
    order += order[::-1]
    for case, fn in cases.items():
        outs, ts = {}, {}
        for n in order:
            for name, mod in NAMES.items():
                mod._lib = (lambda lib: (lambda: lib))(libs[n][name])
            outs.setdefault(n, fn())
            ts.setdefault(n, []).append(CS._time_ms(fn, flush, 10))
        torch.cuda.synchronize()
        ref = outs[0]
        print(f"[f32_ab] {case} at qwen2-1.5b b 2 x s 4096: " + "; ".join(
            f"{builds[n][0]}: {ts[n][0]:.4f}, {ts[n][1]:.4f} ms (max |diff| "
            f"vs {builds[0][0]} {float((outs[n] - ref).abs().max()):.3e})"
            for n in range(len(builds))), flush=True)


if __name__ == "__main__":
    main()
