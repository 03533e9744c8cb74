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
found by an integer ticket.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# The consumer warpgroups' rows and the KV tile of the attention mainloop
# (kWalkRows, kWalkBN in csrc/attn_mainloop.cuh)
WALK_ROWS = 64
WALK_BN = 64
# The fp32 full-sequence kernel (csrc/attn_f32.cuh): positions per block,
# threads, KV rows per shared-memory tile
F32_ROWS = 32
F32_THREADS = 256
F32_KEYS = 16


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
              kv_dtype, wide: bool, index_operands=(), n_index=0,
              out_shape, out_dtype) -> LaunchPlan:
    """The mainloop's launch (``launch_walk``): grid (ceil(c g / (64
    consumers)), hkv, b), 128 (consumers + 1) threads, two consumer
    warpgroups when ``wide`` and dk <= 128. Block (bx, by, bz) writes the
    output rows of its folded row tile bx of KV head by in batch row bz."""
    consumers = 2 if wide and dk <= 128 else 1
    g = H // hkv
    rows = consumers * WALK_ROWS
    quantized = kv_dtype in (torch.int8, torch.float8_e4m3fn)
    grid = (-(-(c * g) // rows), hkv, b)
    return LaunchPlan(
        name=name, kernel="attn_walk_kernel", grid=grid,
        block=128 * (consumers + 1),
        smem=walk_smem_bytes(dk, quantized, consumers),
        outputs=[OutputTile("out", tuple(out_shape), dtype_name(out_dtype),
                            lambda bx, by, bz: (bz, by, bx))],
        index_operands=list(index_operands), n_index=n_index,
        layout=dict(dk=dk, kv_type=int(quantized), consumers=consumers))


def f32_plan(name: str, *, b: int, sq: int, H: int, dk: int,
             out_shape) -> LaunchPlan:
    """The fp32 full-sequence kernel (csrc/attn_f32.cuh): grid (ceil(sq /
    32), H, b), 256 threads, K/V tiles of 16 rows in static shared memory;
    block (bx, by, bz) writes positions 32 bx .. 32 bx + 31 of head by in
    batch row bz."""
    return LaunchPlan(
        name=name, kernel="attn_f32_kernel",
        grid=(-(-sq // F32_ROWS), H, b), block=F32_THREADS, smem=0,
        static_smem=2 * F32_KEYS * dk * 4,
        outputs=[OutputTile("out", tuple(out_shape), "float32",
                            lambda bx, by, bz: (bz, bx, by))])
