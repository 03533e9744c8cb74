"""Time the hand-written attention kernels of several source trees in one
process, on one card, in turns: the Hopper mainloop's (prefill and both
full-sequence kernels) and the decode kernels.

    python3 tools/mainloop_ab.py PARENT_ROOT CHANGE_ROOT [...]

Each argument is a checkout of this repository (for example a
``git archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists, and ``.`` for the working tree). For each tree the
script compiles ``consmax_prefill``, ``consmax_attn``, ``softmax_attn`` and
``consmax_decode`` from that tree's ``src/repro_torch/kernels`` with this
tree's nvcc flags, all in parallel, into ``build/ab/<n>/``, and binds them
through this tree's ops (the kernels' C entry points have kept their
signatures, and the prefill entry points' KV-shard arguments come after
the stream, so an older prefill library ignores them and walks unsplit; a
library from before an entry point this tree's ops bind gets a stub of it,
see ``OPTIONAL``). Then, per case (the prefill kernels at the timed
chunk of ``chip_smoke.py`` for qwen2-1.5b, gemma2-2b's local layer,
phi3.5-moe and phi-3-vision-4.2b: c 512 at fill 4096, 6656, 4096 and 2048,
bf16, int8 and fp8_e4m3, contiguous and paged at page size 256, at
prefill_kv_block 512, 256, 64 and one shard; causal whole-prompt attention
at qwen2-1.5b b 2 x s 4096, Eq. 2, Eq. 3 and softmax; the gemma2-2b local
layer; qwen2-1.5b decode, b 8 x L 8192 at fills 1 .. 8192, bf16 and int8,
contiguous and paged at page sizes 256 and 16), it times the trees in the
order given and then reversed (CUDA events, L2 flushed before each call),
and prints each tree's times and its largest difference from the first
tree's output. Prints the card's name and power limit first. Needs one
card.
"""
from __future__ import annotations

import ctypes
import functools
import re
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
import repro_torch.kernels.consmax_decode.ops as DO  # noqa: E402
import repro_torch.kernels.consmax_prefill.ops as PO  # noqa: E402
import repro_torch.kernels.softmax_attn.ops as SO  # noqa: E402

NAMES = {"consmax_prefill": PO, "consmax_attn": AO, "softmax_attn": SO,
         "consmax_decode": DO}
# entry points this tree's ops bind that an older library may lack, and the
# stub it gets (the decode kernel's shared-memory byte count: any size
# passes the wrapper's check, and the older launch checks bk itself)
OPTIONAL = {"consmax_decode_smem_bytes": lambda dk, kv, paged, bk: 1}


def build(trees):
    """One nvcc per (tree, library), all at once; returns the library
    paths, raising with the compiler's output if one fails."""
    procs, libs = {}, {}
    t0 = time.perf_counter()
    for n, tree in enumerate(trees):
        kdir = tree / "src/repro_torch/kernels"
        out = ROOT / "build/ab" / str(n)
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
            raise RuntimeError(f"nvcc failed for {trees[n]} {name}:\n{log}")
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers",
                                                   log)})
        spills = sorted({int(x) for x in re.findall(
            r"(\d+) bytes spill stores", log)})
        print(f"[ab] built {trees[n]} {name}: registers {regs}, spill "
              f"stores {spills} B ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return libs


def bind(path, module):
    """The library at ``path`` with ``module``'s argument types set."""
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for name, stub in OPTIONAL.items():
        if not hasattr(lib, name):
            setattr(lib, name, stub)
    load = _build.load
    _build.load = lambda name: lib
    try:
        return module._lib.__wrapped__()
    finally:
        _build.load = load


# the prefill kernels' timed chunks (c 512): arch -> H, hkv, dk, L, index,
# mask and weight keywords
PREFILL = {
    "qwen2-1.5b": (12, 2, 128, 8192, 3584, dict(window=0, softcap=0.0)),
    "gemma2-2b": (8, 4, 256, 8192, 6144, dict(window=4096, softcap=50.0)),
    "phi3.5-moe": (32, 8, 128, 8192, 3584, dict(window=0, softcap=0.0)),
    "phi-3-vision": (32, 32, 96, 4096, 1536, dict(window=0, softcap=0.0)),
}
SWEEP_BK = (512, 256, 64)


def prefill_cases(gen):
    """Both prefill kernels at each arch's chunk, per K/V dtype, at each bk
    of the sweep and at one shard."""
    out, c = {}, 512
    for arch, (H, hkv, dk, L, idx, mask) in PREFILL.items():
        kw = dict(mask, merged=True, scale=1.0)
        q = CS._rand(gen, (1, c, H, dk), dk ** -0.5)
        k, v = CS._rand(gen, (1, L, hkv, dk)), CS._rand(gen, (1, L, hkv, dk))
        beta, gamma = CS._head_params(gen, H)
        ti = torch.tensor([idx], dtype=torch.int32, device="cuda")
        tn = torch.tensor([c], dtype=torch.int32, device="cuda")
        for dt in ("bf16", "int8", "fp8_e4m3"):
            kk, vv, sc = k, v, {}
            if dt != "bf16":
                kk, ks, _ = CS._quantize(k, dt)
                vv, vs, _ = CS._quantize(v, dt)
                sc = dict(k_scale=ks, v_scale=vs)
            pools, table = CS._paginate_rows(
                [kk, vv, *sc.values()], [idx + c], 256, L // 256, seed=7)
            psc = dict(zip(sc, pools[2:]))
            for bk in (*SWEEP_BK, L):
                at = f"bk {bk}" if bk < L else "one shard"
                out[f"consmax_prefill {arch} {dt}, c 512 at fill "
                    f"{idx + c}, {at}"] = functools.partial(
                        PO.consmax_prefill_cuda, q, kk, vv, ti, tn, beta,
                        gamma, bk=bk, **sc, **kw)
                out[f"consmax_prefill_paged {arch} {dt}, page size 256, "
                    f"{at}"] = functools.partial(
                        PO.consmax_prefill_paged_cuda, q, *pools[:2], table,
                        ti, tn, beta, gamma, bk=bk, **psc, **kw)
    return out


def cases():
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = prefill_cases(gen)
    H, hkv, dk, L = 12, 2, 128, 8192
    beta, gamma = CS._head_params(gen, H)
    kw = dict(window=0, softcap=0.0, merged=True, scale=1.0)
    qa = CS._rand(gen, (2, 4096, H, dk))
    ka, va = CS._rand(gen, (2, 4096, hkv, dk)), CS._rand(gen, (2, 4096, hkv,
                                                                 dk))
    qg = CS._rand(gen, (1, 8192, 8, 256))
    kg, vg = CS._rand(gen, (1, 8192, 4, 256)), CS._rand(gen, (1, 8192, 4,
                                                               256))
    bg, gg = CS._head_params(gen, 8)
    # decode: the qwen2-1.5b timed case
    fills = [1, 256, 257, 1000, 3000, 4096, 8191, 8192]
    lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
    qd = CS._rand(gen, (8, H, dk), dk ** -0.5)
    kd, vd = CS._rand(gen, (8, L, hkv, dk)), CS._rand(gen, (8, L, hkv, dk))
    kdq, kds, _ = CS._quantize(kd, "int8")
    vdq, vds, _ = CS._quantize(vd, "int8")
    dec = {}
    for ps in (256, 16):
        n_pages = sum(-(-f // ps) for f in fills) + 64
        dec[ps] = CS._paginate_rows([kd, vd, kdq, vdq, kds, vds], fills, ps,
                                    n_pages, seed=ps)
    dkw = dict(kw, bk=256)

    def paged(ps, quant):
        (kp, vp, kqp, vqp, ksp, vsp), table = dec[ps]
        if quant:
            return lambda: DO.consmax_decode_paged_cuda(
                qd, kqp, vqp, table, lens, beta, gamma, k_scale=ksp,
                v_scale=vsp, **dkw)
        return lambda: DO.consmax_decode_paged_cuda(qd, kp, vp, table, lens,
                                                    beta, gamma, **dkw)

    return {
        **out,
        "consmax_attention Eq. 2, qwen2-1.5b b 2 x s 4096": lambda: (
            AO.consmax_attention_cuda(qa, ka, va, beta, gamma)),
        "consmax_attention Eq. 3, same": lambda: AO.consmax_attention_cuda(
            qa, ka, va, beta, gamma, merged=True),
        "softmax_attention, same": lambda: SO.softmax_attention_cuda(
            qa, ka, va),
        "consmax_attention, gemma2-2b local dk 256 s 8192": lambda: (
            AO.consmax_attention_cuda(qg, kg, vg, bg, gg, window=4096,
                                      softcap=50.0)),
        "consmax_decode bf16, b 8 x L 8192 at fills 1 .. 8192": lambda: (
            DO.consmax_decode_cuda(qd, kd, vd, lens, beta, gamma, **dkw)),
        "consmax_decode int8, same": lambda: DO.consmax_decode_cuda(
            qd, kdq, vdq, lens, beta, gamma, k_scale=kds, v_scale=vds,
            **dkw),
        "consmax_decode_paged bf16, page size 256": paged(256, False),
        "consmax_decode_paged bf16, page size 16": paged(16, False),
        "consmax_decode_paged int8, page size 256": paged(256, True),
        "consmax_decode_paged int8, page size 16": paged(16, True),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mainloop_ab: no CUDA device")
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    paths = build(trees)
    libs = {n: {name: bind(paths[n, name], mod)
                for name, mod in NAMES.items()} for n in range(len(trees))}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    order = list(range(len(trees)))
    order += order[::-1]
    for case, fn in cases().items():
        outs, ts = {}, {}
        for n in order:
            for name, mod in NAMES.items():
                mod._lib = (lambda lib: (lambda: lib))(libs[n][name])
            outs.setdefault(n, fn())
            ts.setdefault(n, []).append(CS._time_ms(fn, flush, 50) * 1e3)
        torch.cuda.synchronize()
        ref = outs[0].float()
        print(f"[ab] {case}: " + "; ".join(
            f"{trees[n].name or trees[n]}: {ts[n][0]:.2f}, {ts[n][1]:.2f} us"
            f" (max |diff| vs {trees[0].name} "
            f"{float((outs[n].float() - ref).abs().max()):.3e})"
            for n in ts), flush=True)


if __name__ == "__main__":
    main()
