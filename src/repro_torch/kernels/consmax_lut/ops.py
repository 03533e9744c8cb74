"""Public wrapper of the bitwidth-split LUT kernel (the paper's Eq. 4, the
int8 inference path).

``consmax_lut_op(scores_int8, c, scale=...)`` maps int8 scores of any
shape to fp32 ``C * exp(scale * s)`` through the two 16-entry tables of
``make_luts``, dispatching by the scores' device: on the CPU it computes
the plain version (``ref.lut_product``, the kernel's own tables and
multiply order); on a CUDA device it launches the kernel in
``csrc/consmax_lut.cu`` (built at first use, see ``kernels/_build.py``) or
raises. There is no fallback.

``consmax_lut_op.launches`` counts kernel launches (CUDA only): the kernel
adds one to the wrapper's device counter (``_build.counted``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consmax_lut.ref import lut_product


def make_luts(scale: float, device=None):
    """(msb_lut, lsb_lut): 16-entry fp32 tables e^{scale*16*m} for
    m = -8..7 and e^{scale*l} for l = 0..15, on ``device``."""
    m = torch.arange(-8, 8, dtype=torch.float32, device=device)
    l = torch.arange(16, dtype=torch.float32, device=device)
    return torch.exp(scale * 16.0 * m), torch.exp(scale * l)


@functools.cache
def _lib():
    lib = _build.load("consmax_lut")
    p = ctypes.c_void_p
    lib.consmax_lut_launch.argtypes = [p] * 4 + [ctypes.c_float, p,
                                                 ctypes.c_longlong, p, p]
    lib.consmax_lut_launch.restype = ctypes.c_int
    return lib


def consmax_lut_cuda(scores_int8, c, msb_lut, lsb_lut):
    """Launch the CUDA kernel on contiguous int8 scores of any shape (at any
    address: codes that do not start on a 16-byte boundary take the kernel's
    code-by-code path) with the tables of ``make_luts`` (on the same device).
    ``c``: a float, or a 0-d fp32 tensor on the device (read there: no
    host sync). Returns fp32 of the scores' shape."""
    _build.check_codes("consmax_lut", scores_int8, c)
    msb_lut = msb_lut.float().contiguous()
    lsb_lut = lsb_lut.float().contiguous()
    for name, t in (("msb_lut", msb_lut), ("lsb_lut", lsb_lut)):
        if t.shape != (16,) or t.device != scores_int8.device:
            raise ValueError(f"consmax_lut: {name} must be (16,) on "
                             f"{scores_int8.device}, got {tuple(t.shape)} "
                             f"on {t.device}")
    out = torch.empty(scores_int8.shape, dtype=torch.float32,
                      device=scores_int8.device)
    c_ptr, c_val = ((c.data_ptr(), 0.0) if isinstance(c, torch.Tensor)
                    else (None, float(c)))
    lib = _lib()
    err = lib.consmax_lut_launch(
        scores_int8.data_ptr(), msb_lut.data_ptr(), lsb_lut.data_ptr(), c_ptr,
        c_val, out.data_ptr(), scores_int8.numel(),
        torch.cuda.current_stream(scores_int8.device).cuda_stream,
        _build.launch_counter("consmax_lut", scores_int8.device))
    _build.check(lib, err, "consmax_lut")
    return out


@_build.counted("consmax_lut")
def consmax_lut_op(scores_int8, c, *, scale: float):
    """scores_int8: int8, any shape (contiguous on CUDA); c: the merged
    constant e^{-beta}/gamma
    (a float or a 0-d fp32 tensor); scale: the score quantization step.
    Returns fp32 of the same shape, ``C * exp(scale * s)`` through the
    bitwidth-split tables. The reference's ``block`` is a TPU tile size and
    is not taken."""
    luts = make_luts(scale, scores_int8.device)
    if scores_int8.device.type == "cpu":
        return lut_product(scores_int8, c, *luts)
    if scores_int8.device.type != "cuda":
        raise NotImplementedError(
            f"consmax_lut: no kernel for device {scores_int8.device}")
    return consmax_lut_cuda(scores_int8, c, *luts)
