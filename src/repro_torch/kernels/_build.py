"""Build, load and check the operands of the hand-written CUDA kernels.

Each kernel lives in ``kernels/<name>/csrc/<name>.cu`` with a plain C entry
point (pointers and the CUDA stream as ``void*``, a returned
``cudaGetLastError()``). At first use it is compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the repo root — a directory
``.gitignore`` lists — and loaded with ``ctypes``. A library's file name
carries a hash of its sources and flags, so an edited source rebuilds and an
unchanged one is reused. ``build`` starts one ``nvcc`` per missing library,
all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of the
port, on machines that have neither a card nor ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = _KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
COMMON_INCLUDE = _KERNELS_DIR / "csrc"
KERNELS = ("consmax_decode", "consmax_prefill", "consmax_attn",
           "softmax_attn", "consmax_lut")
HEAD_DIMS = (32, 64, 96, 128, 256)      # the head_dims the kernels compile
# K/V element types of the serving kernels -> their kv_type code (KVCode in
# csrc/consmax_common.cuh); int8 / fp8_e4m3 caches come with fp32 scales
KV_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
SMEM_PER_BLOCK = 232_448               # bytes a Hopper block may opt in to
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _sources(name: str) -> list[Path]:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; expected one of {KERNELS}")
    return [_KERNELS_DIR / name / "csrc" / f"{name}.cu",
            *sorted(COMMON_INCLUDE.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = shutil.which("nvcc") or str(home / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked on PATH and in "
                           f"{home / 'bin'}): the CUDA kernels cannot be "
                           "built here")
    return nvcc


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` each, all in parallel. Returns ``{name: seconds}`` for the
    libraries compiled by this call; raises with the compiler's output if
    one fails. The compiler's report (registers, spills) is kept beside
    each library as ``<library>.log``."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{COMMON_INCLUDE}", "-o", str(tmp),
               str(_sources(name)[0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    seconds, failed = {}, {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode:
            failed[name] = log
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)                 # atomic: readers never see
                                             # a half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{log}" for n, log in failed.items()))
    return seconds


def ptxas_report(name: str) -> list[dict]:
    """What ``ptxas -v`` said of each kernel of built library ``name``:
    ``[{"kernel": mangled name, "registers": n, "smem": static bytes,
    "spill_stores": bytes, "spill_loads": bytes}]``, from the log kept
    beside the library."""
    log = library_path(name).with_suffix(".log").read_text()
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=m.group(1), registers=0, smem=0,
                       spill_stores=0, spill_loads=0)
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(sm.group(1)) if sm else 0
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (building it first if
    needed), loaded once per process."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check_kv_scales(kernel: str, k, v, k_scale, v_scale):
    """Raise unless the cache's scales match its dtype: an int8 / fp8_e4m3
    cache needs fp32 ``k_scale``/``v_scale`` shaped like it without its dk
    axis, a float cache (bf16 on the card; any float dtype in the plain
    versions) takes none. Checked on every device, before the plain
    version or the kernel runs."""
    if v.dtype != k.dtype:
        raise TypeError(f"{kernel}: k is {k.dtype}, v is {v.dtype}")
    given = (k_scale is not None, v_scale is not None)
    if k.dtype not in (torch.int8, torch.float8_e4m3fn):
        if any(given):
            raise ValueError(f"{kernel}: a {k.dtype} cache takes no "
                             "k_scale/v_scale")
        return
    if not all(given):
        raise ValueError(f"{kernel}: a {k.dtype} cache needs its k_scale "
                         "and v_scale")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or t.shape != k.shape[:-1]:
            raise ValueError(f"{kernel}: {name} must be float32 of shape "
                             f"{tuple(k.shape[:-1])}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def check_operands(kernel: str, q, k, v, *, slots: dict, heads: dict,
                   page_table=None, k_scale=None, v_scale=None) -> int:
    """Raise unless the attention operands agree: ``q`` bf16
    (b, [s,] H, dk) against ``k``/``v`` (b, L, hkv, dk) — a serving cache
    (decode q (b, H, dk), prefill chunk (b, c, H, dk)) or a full sequence's
    keys and values (b, skv, hkv, dk) — or, with ``page_table`` (b, npg)
    int32, page pools (P, ps, hkv, dk); k/v bf16, or int8 / fp8_e4m3 with
    their scales (``check_kv_scales``); dk in ``HEAD_DIMS``, H a multiple
    of hkv, ``slots`` tensors (b,) and ``heads`` tensors (H,); and every
    operand on ``q``'s device, contiguous and aligned for the kernel's
    vector loads (16 bytes for q/k/v, 4 for the rest). Returns the cache's
    kv_type code (``KV_TYPES``)."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{kernel}: q must be bfloat16 on CUDA, got "
                        f"{q.dtype}")
    if k.dtype not in KV_TYPES:
        raise TypeError(f"{kernel}: k/v must be one of "
                        f"{[str(t) for t in KV_TYPES]} on CUDA, got "
                        f"{k.dtype}")
    check_kv_scales(kernel, k, v, k_scale, v_scale)
    _check_layout(kernel, q, k, v, slots=slots, heads=heads,
                  page_table=page_table, k_scale=k_scale, v_scale=v_scale)
    return KV_TYPES[k.dtype]


def _check_layout(kernel: str, q, k, v, *, slots: dict, heads: dict,
                  page_table=None, k_scale=None, v_scale=None):
    """``check_operands`` past the dtypes: shapes, head_dim, heads, the
    page table, and every operand's device, contiguity and alignment."""
    b, H, dk = q.shape[0], q.shape[-2], q.shape[-1]
    if k.shape != v.shape or k.ndim != 4 or k.shape[3] != dk or (
            page_table is None and k.shape[0] != b):
        raise ValueError(f"{kernel}: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if dk not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {dk} not in {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"{kernel}: {H} query heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    for group, n in ((slots, b), (heads, H)):
        for name, t in group.items():
            if t.shape != (n,):
                raise ValueError(f"{kernel}: {name} must have shape ({n},), "
                                 f"got {tuple(t.shape)}")
    extra = {}
    if page_table is not None:
        if (page_table.dtype != torch.int32 or page_table.ndim != 2
                or page_table.shape[0] != b or page_table.shape[1] < 1):
            raise ValueError(f"{kernel}: page_table must be ({b}, npg >= 1) "
                             f"int32, got {tuple(page_table.shape)} "
                             f"{page_table.dtype}")
        extra["page_table"] = page_table
    if k_scale is not None:
        extra.update(k_scale=k_scale, v_scale=v_scale)
    _check_placement(kernel, q.device, {"q": q, "k": k, "v": v, **slots,
                                        **heads, **extra},
                     align={"q": 16, "k": 16, "v": 16})


def check_sequence_operands(kernel: str, q, k, v, *, heads: dict):
    """Full-sequence attention: ``q`` (b, sq, H, dk) against ``k``/``v``
    (b, skv, hkv, dk) in the model layout, checked as ``check_operands``
    does, with ``heads`` tensors (H,); q, k and v all bfloat16 (the wgmma
    mainloop) or all float32 (the fp32 SIMT kernel, ``csrc/attn_f32.cuh``).
    The serving kernels (``check_operands``) take bf16 queries only."""
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype for t in (k, v)):
        raise TypeError(f"{kernel}: q, k, v must be all bfloat16 or all "
                        f"float32 on CUDA, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4:
        raise ValueError(f"{kernel}: q must be (b, sq, H, dk), got "
                         f"{tuple(q.shape)}")
    _check_layout(kernel, q, k, v, slots={}, heads=heads)


def check_codes(kernel: str, codes, c=None):
    """The LUT: ``codes`` int8 with n >= 1 elements, contiguous, at any
    address (the kernel takes 16-byte loads only where the codes allow);
    ``c``, when a tensor, a 0-d fp32 tensor on the codes' device."""
    if codes.dtype != torch.int8:
        raise TypeError(f"{kernel}: codes must be int8, got {codes.dtype}")
    if codes.numel() < 1:
        raise ValueError(f"{kernel}: codes must hold n >= 1 elements")
    ops = {"codes": codes}
    if isinstance(c, torch.Tensor):
        if c.dtype != torch.float32 or c.ndim != 0:
            raise ValueError(f"{kernel}: C must be a 0-d float32 tensor, got "
                             f"{tuple(c.shape)} {c.dtype}")
        ops["C"] = c
    _check_placement(kernel, codes.device, ops, align={"codes": 1})


def _check_placement(kernel: str, device, operands: dict, *, align: dict):
    """Every operand on ``device``, contiguous, and aligned to
    ``align[name]`` bytes (4 for a name not in ``align``)."""
    for name, t in operands.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}, expected "
                             f"{device}")
        to = align.get(name, 4)
        if not t.is_contiguous() or t.data_ptr() % to:
            raise ValueError(f"{kernel}: {name} must be contiguous" + (
                f" and {to}-byte aligned" if to > 1 else ""))


def data_ptr(t):
    """A tensor's address for a ``ctypes.c_void_p`` argument; None (a null
    pointer) for an absent optional operand."""
    return None if t is None else t.data_ptr()


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
