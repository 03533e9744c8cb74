"""Conditional CUDA graph nodes (``csrc/graph_cond.cu``): work captured
into an IF node of the graph being captured, which a replay runs only
where a device bool holds. This is the CUDA counterpart of XLA's while loop
with a trip count traced on the device: the reference's ``fori_loop(0, hi,
...)`` in ``core/attention._kv_walk`` becomes one IF node per block on
``j < hi``.

``graph(pool=..., stream=...)`` is ``torch.cuda.graph`` for a capture
that may make such nodes. Before the capture begins it makes the device's
body stream (one per device, made with the runtime, so no other user of
PyTorch's stream pool gets it, with cuBLAS warmed on it). While the capture
runs it registers the capture, so that ``if_node`` finds its body stream
and the memory pool the bodies allocate from. After the capture it counts
the graph's nodes, then instantiates it.

``with if_node(pred):`` captures its block into an IF node on ``pred``, a
0-d bool tensor on the card. The block's ops go to the body stream and
allocate from the bodies' pool, which the graph holds. The block runs
once, at capture; a replay executes it only where ``pred`` is
true. Nothing falls back: ``if_node`` raises outside a ``graph`` capture,
and so does a CUDA runtime or driver older than 12.4 (the graph's capture
then fails).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

MIN_CUDA = 12040          # conditional nodes, cudaStreamBeginCaptureToGraph


@functools.cache
def _lib():
    lib = _build.load("graph_cond")
    p = ctypes.c_void_p
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_cond_stream_create.argtypes = [ctypes.POINTER(p)]
    lib.graph_cond_begin_if.argtypes = [p, p, p]
    lib.graph_cond_end.argtypes = [p]
    for f in (lib.graph_cond_versions, lib.graph_cond_stream_create,
              lib.graph_cond_begin_if, lib.graph_cond_end):
        f.restype = ctypes.c_int
    return lib


def versions() -> tuple[int, int]:
    """(the library's CUDA runtime, the driver's CUDA version), as integers
    (12040 = 12.4)."""
    lib = _lib()
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.graph_cond_versions(ctypes.byref(rt),
                                              ctypes.byref(drv)),
                 "cudaDriverGetVersion")
    return rt.value, drv.value


CU_GRAPH_NODE_TYPE_CONDITIONAL = 13


@functools.cache
def _driver() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def count_nodes(raw_graph: int) -> tuple[int, int]:
    """(top-level nodes, conditional nodes) of the cudaGraph_t
    ``raw_graph``, as the driver lists them (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``; the CUDA 12 runtime's ``cudaGraphNodeGetType``
    fails on a conditional node under a CUDA 13 driver)."""
    cu = _driver()
    g, n, kind = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0), ctypes.c_int()
    err = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    err = err or cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    cond = 0
    for node in nodes:
        err = cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType: CUDA driver error {err}")
        cond += kind.value == CU_GRAPH_NODE_TYPE_CONDITIONAL
    return n.value, cond


_BODY: dict = {}


def _body_stream(device) -> torch.cuda.ExternalStream:
    """The stream IF-node bodies are captured on, on ``device``: made once
    (outside any capture) with ``cudaStreamCreateWithFlags``, never one of
    PyTorch's pool streams (an engine's side stream may be one, and a
    stream cannot capture two graphs at once); fp32 and bf16 GEMMs run on
    it once, so cuBLAS has its workspace for the stream before a capture."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    s = _BODY.get(index)
    if s is None:
        _build._not_capturing("making the conditional-body stream", device)
        rt, drv = versions()
        if min(rt, drv) < MIN_CUDA:
            raise RuntimeError(
                f"conditional graph nodes need CUDA {MIN_CUDA // 1000}."
                f"{MIN_CUDA % 1000 // 10} or newer; the runtime is {rt}, "
                f"the driver {drv}")
        with torch.cuda.device(index):
            handle = ctypes.c_void_p()
            lib = _lib()
            _build.check(lib, lib.graph_cond_stream_create(
                ctypes.byref(handle)), "cudaStreamCreateWithFlags")
            s = torch.cuda.ExternalStream(handle.value,
                                          device=torch.device("cuda", index))
            with torch.cuda.stream(s):
                for dt in (torch.float32, torch.bfloat16):
                    a = torch.ones(2, 16, 16, dtype=dt, device=s.device)
                    torch.bmm(a, a)
                    torch.mm(a[0], a[0])
            s.synchronize()
        _BODY[index] = s
    return s


@dataclass
class Capture:
    """One ``graph`` capture: its CUDA graph, the pool its bodies allocate
    from (``held`` once a body has), its body stream, and, after the
    capture, the graph's top-level nodes and conditional nodes as the
    driver lists them."""
    graph: torch.cuda.CUDAGraph
    body_pool: tuple
    body: torch.cuda.ExternalStream
    held: bool = False
    nodes: int = 0
    conditional: int = 0


_ACTIVE: dict = {}


@contextlib.contextmanager
def graph(*, pool, stream):
    """Capture the with-block on ``stream`` into a new CUDA graph in
    ``pool`` (``torch.cuda.graph``), in which ``if_node`` makes conditional
    nodes; yields the ``Capture``, whose ``graph`` is instantiated and
    counted when the block ends. The bodies allocate from a pool of their
    own (PyTorch's allocator records one capture into a pool at a time,
    and admits to the capture's pool only the parent stream's capture),
    which the graph holds: it is released when the graph is collected."""
    cap = Capture(torch.cuda.CUDAGraph(keep_graph=True),
                  torch.cuda.graph_pool_handle(), _body_stream(stream.device))
    key = stream.cuda_stream
    try:
        with torch.cuda.graph(cap.graph, pool=pool, stream=stream):
            _ACTIVE[key] = cap
            try:
                yield cap
            finally:
                del _ACTIVE[key]
        cap.nodes, cap.conditional = count_nodes(cap.graph.raw_cuda_graph())
        cap.graph.instantiate()
    finally:
        if cap.held:
            weakref.finalize(cap.graph, torch._C._cuda_releasePool,
                             cap.body.device.index, cap.body_pool)


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Capture the with-block into an IF node on ``pred`` (a 0-d bool
    tensor on the capturing device) of the graph ``graph`` is capturing on
    the current stream."""
    parent = torch.cuda.current_stream(pred.device)
    cap = _ACTIVE.get(parent.cuda_stream)
    if cap is None:
        raise RuntimeError(
            "if_node: the current stream is not capturing through "
            "kernels.graph_cond.graph (a conditional node needs the "
            "capture's body stream and pool)")
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"if_node: pred must be one bool, got "
                         f"{tuple(pred.shape)} {pred.dtype}")
    lib = _lib()
    _build.check(lib, lib.graph_cond_begin_if(
        parent.cuda_stream, cap.body.cuda_stream, pred.data_ptr()),
        "graph_cond_begin_if")
    index = pred.device.index
    try:
        # this thread's allocations go to the bodies' pool; the first
        # body's use of it stays held (by the graph, see ``graph``)
        torch._C._cuda_beginAllocateCurrentThreadToPool(index,
                                                        cap.body_pool)
        first, cap.held = not cap.held, True
        try:
            with torch.cuda.stream(cap.body):
                yield
        finally:
            torch._C._cuda_endAllocateToPool(index, cap.body_pool)
            if not first:
                torch._C._cuda_releasePool(index, cap.body_pool)
    finally:
        err = lib.graph_cond_end(cap.body.cuda_stream)
    _build.check(lib, err, "graph_cond_end")
