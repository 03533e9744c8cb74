"""Launch plans of the CUDA kernels, and the capture that records them.

A kernel wrapper (``kernels/<name>/ops.py``) computes its launch as a
``LaunchPlan`` in plain Python before it launches anything: the operand
checks (``_build.check_operands``), the grid and the block, the dynamic
shared memory (the Python twin of the library's own layout arithmetic),
what each grid dimension is, which tile of each output a block writes, and
the index operands (page table, index, lengths) the blocks read. The real
launch takes its outputs' shapes and its scratch from the plan, and
``capture`` records the plan instead of launching:

    with capture() as plans:
        out = consmax_decode_op(...)   # any device: checks + plan, zeros

Inside ``capture`` a wrapper called on any device runs its checks and its
plan, appends the plan to ``plans`` and returns zeros of its output's shape:
it builds nothing, launches nothing and runs no plain version. Listeners
(``listen``) hear each captured launch as one opaque operation, so an op
recorder around a serving step sees the launch and none of the plain
version's ops. ``analysis/kernel_contracts.py`` checks the recorded plans.

Grid dimensions are ``"independent"``: a CUDA grid runs its blocks
concurrently, in no order, so a block may rely on no other block of its
launch. An output written by several blocks of one tile is a race, unless
the plan names the grid dimensions over which one writer per tile is
elected at run time and the election's operand (``elected_over``,
``election``): the decode kernel's last shard of each (slot, KV head),
found by an integer ticket, and the prefill kernels' last live KV shard
of each row tile, found the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.kernels import cache_layout as CL
from repro_torch.kernels._build import SMEM_PER_BLOCK

# The consumer warpgroups' rows and the KV tile of the attention mainloop
# (kWalkRows, kWalkBN in csrc/attn_mainloop.cuh)
WALK_ROWS = 64
WALK_BN = 64
@dataclasses.dataclass
class OutputTile:
    """One output of a launch: its shape and dtype, the tile index a block
    writes (``tile_of(bx, by, bz)``), and the grid dimensions over which
    one writer per tile is elected at run time (empty: every block writes
    its own tile)."""
    name: str
    shape: tuple
    dtype: str
    tile_of: object
    elected_over: tuple = ()

    def to_json(self) -> dict:
        return {"name": self.name, "shape": list(self.shape),
                "dtype": self.dtype, "elected_over": list(self.elected_over)}


@dataclasses.dataclass
class LaunchPlan:
    """One kernel launch as the wrapper plans it."""
    name: str
    kernel: str                       # the CUDA kernel template launched
    grid: tuple
    block: int
    smem: int                         # dynamic shared memory, bytes
    static_smem: int = 0              # static shared memory, where known
    dims: tuple | None = ("independent",) * 3
    outputs: list = dataclasses.field(default_factory=list)
    scratch_bytes: int = 0            # device scratch the wrapper allocates
    index_operands: list = dataclasses.field(default_factory=list)
    n_index: int = 0                  # the declared number of index operands
    election: str | None = None       # the operand electing a tile's writer
    layout: dict = dataclasses.field(default_factory=dict)  # smem key

    def to_json(self) -> dict:
        return {"name": self.name, "kernel": self.kernel,
                "grid": [int(g) for g in self.grid], "block": self.block,
                "smem_bytes": self.smem, "static_smem_bytes": self.static_smem,
                "dimension_semantics": (list(self.dims) if self.dims
                                        else None),
                "outputs": [o.to_json() for o in self.outputs],
                "scratch_bytes": self.scratch_bytes,
                "index_operands": [[n, list(s), d] for n, s, d in
                                   self.index_operands],
                "n_index": self.n_index, "election": self.election,
                "layout": dict(self.layout)}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def index_operand(name: str, t: torch.Tensor) -> tuple:
    return (name, tuple(t.shape), dtype_name(t.dtype))


# ------------------------------------------------------------- capture ----
_CAPTURES: list = []
_LISTENERS: list = []


def capturing() -> bool:
    return bool(_CAPTURES)


@contextlib.contextmanager
def capture():
    """Record launch plans instead of launching; yields the list."""
    plans: list = []
    _CAPTURES.append(plans)
    try:
        yield plans
    finally:
        _CAPTURES.remove(plans)


@contextlib.contextmanager
def listen(on_launch):
    """Call ``on_launch(plan, inputs, outputs)`` for every captured launch
    (inputs: the wrapper's tensor operands; outputs: the zeros returned)."""
    _LISTENERS.append(on_launch)
    try:
        yield
    finally:
        _LISTENERS.remove(on_launch)


def record(plan: LaunchPlan, inputs: dict, device) -> torch.Tensor:
    """Record ``plan`` in every active capture and return zeros of its last
    output (the tensor the kernel writes for the caller; scratch outputs
    such as the decode kernel's partials come first)."""
    for plans in _CAPTURES:
        plans.append(plan)
    out = plan.outputs[-1]
    dtype = getattr(torch, out.dtype)
    with _opaque():
        zeros = torch.zeros(out.shape, dtype=dtype, device=device)
    for fn in list(_LISTENERS):
        fn(plan, inputs, zeros)
    return zeros


_OPAQUE = [0]


@contextlib.contextmanager
def _opaque():
    _OPAQUE[0] += 1
    try:
        yield
    finally:
        _OPAQUE[0] -= 1


def opaque() -> bool:
    """True while ``record`` makes a captured launch's outputs: an op
    recorder skips those ops (the launch is one opaque operation)."""
    return _OPAQUE[0] > 0


# ------------------------------------------------ the attention mainloop ----
def walk_smem_bytes(dk: int, quantized: bool, consumers: int) -> int:
    """WalkLayout<dk, TKV, consumers>::kBytes (csrc/attn_mainloop.cuh): the
    mbarriers' 128 bytes, the Q tiles, the ring of bf16 K/V stages and, for
    codes, one staging slot of codes and row scales per stage."""
    stages = 2 if dk == 256 and quantized else 3
    tile = WALK_BN * dk * 2
    code_row = dk + (16 if dk < 256 else 0)
    code_slot = 2 * WALK_BN * code_row + 2 * WALK_BN * 4
    kv = 128 + consumers * WALK_ROWS * dk * 2
    codes = kv + stages * 2 * tile
    return codes + (stages * code_slot if quantized else 0)


def walk_plan(name: str, *, b: int, c: int, H: int, hkv: int, dk: int,
              kv_dtype, index_operands=(), n_index=0, out_shape, out_dtype,
              L: int | None = None, bk: int | None = None) -> LaunchPlan:
    """The mainloop's launch (``launch_walk``): two consumer warpgroups of
    64 rows on each K/V tile at dk <= 128 (row tiles of 128 folded rows),
    one at dk 256 (64), and a producer warpgroup, 128 threads each. Without
    ``bk`` (the full-sequence kernels) ns is 1; with ``bk`` (the prefill
    kernels, over ``L`` logical cache rows) the rows are cut into
    ``cache_layout.prefill_shards(L, bk)``. Grid (nr row tiles x ns, hkv,
    b): block (bx, by, bz) walks shard bx % ns of row tile bx // ns of KV
    head by in batch row bz and writes that shard's fp32 partial (one
    writer each); at ns > 1 the output rows of a row tile are written by
    ONE of its blocks, elected at run time by the integer ticket (the one
    holding the last live shard to finish; block 0 for a row tile with
    none)."""
    g = H // hkv
    quantized = kv_dtype in (torch.int8, torch.float8_e4m3fn)
    consumers = 2 if dk <= 128 else 1
    nr = -(-(c * g) // (consumers * WALK_ROWS))
    shard_rows, ns = (L, 1) if bk is None else CL.prefill_shards(L, bk,
                                                                 WALK_BN)
    out = OutputTile("out", tuple(out_shape), dtype_name(out_dtype),
                     lambda bx, by, bz: (bz, by, bx // ns),
                     elected_over=(0,) if ns > 1 else ())
    outputs = [out]
    if ns > 1:
        outputs.insert(0, OutputTile(
            "partials", (b, hkv, ns, c * g, dk), "float32",
            lambda bx, by, bz: (bz, by, bx % ns, bx // ns)))
    return LaunchPlan(
        name=name, kernel="attn_walk_kernel", grid=(nr * ns, hkv, b),
        block=128 * (consumers + 1),
        smem=walk_smem_bytes(dk, quantized, consumers), outputs=outputs,
        scratch_bytes=b * hkv * ns * c * g * dk * 4 if ns > 1 else 0,
        index_operands=list(index_operands), n_index=n_index,
        election="tickets" if ns > 1 else None,
        layout=dict(dk=dk, kv_type=int(quantized), consumers=consumers,
                    shard_rows=shard_rows, ns=ns))


def f32_layout(dk: int) -> dict:
    """F32Layout<dk> (csrc/attn_f32.cuh): warps of 16 folded rows, keys per
    K/V tile, ring stages (3 where they fit, else 2) and the dynamic shared
    memory: 128 bytes of mbarriers, the Q rows at dk + 16 floats each, then
    per stage the K rows (dk + 16 floats) and the V rows (dk + 4)."""
    warps = 4 if dk == 256 else 8
    keys = 32 if dk == 256 else 64
    rows = 16 * warps
    base = 128 + rows * (dk + 16) * 4
    stage = keys * (2 * dk + 20) * 4
    stages = 3 if base + 3 * stage <= SMEM_PER_BLOCK else 2
    return dict(warps=warps, threads=32 * warps, rows=rows, keys=keys,
                stages=stages, smem=base + stages * stage)


def f32_plan(name: str, *, b: int, sq: int, H: int, hkv: int, dk: int,
             out_shape) -> LaunchPlan:
    """The fp32 full-sequence kernel (csrc/attn_f32.cuh): a 1-D grid of
    ceil(sq g / rows) row tiles x b x hkv CTAs, the row tile slowest and
    reversed (the last rows first). Block bx writes the folded rows of row
    tile ``tiles - 1 - bx // (b hkv)`` of KV head ``bx % (b hkv) % hkv`` in
    batch row ``bx % (b hkv) // hkv``."""
    lay = f32_layout(dk)
    tiles = -(-(sq * (H // hkv)) // lay["rows"])
    groups = b * hkv
    return LaunchPlan(
        name=name, kernel="attn_f32_kernel", grid=(tiles * groups, 1, 1),
        block=lay["threads"], smem=lay["smem"],
        outputs=[OutputTile("out", tuple(out_shape), "float32",
                            lambda bx, by, bz: (
                                bx % groups // hkv, bx % groups % hkv,
                                tiles - 1 - bx // groups))],
        layout=dict(dk=dk, stages=lay["stages"], keys=lay["keys"]))
