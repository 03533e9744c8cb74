"""The prefill kernel's share of its roofline over the traced slice, in %:
the least time of the append chunks served in the slice (per chunk and
layer the larger of 4 dk H flops per visible pair at 989 TFLOP/s and q, out
and the K / V rows [0, start + n) once at 3.35 TB/s), over the device time
of the kernels the prefill op launches."""
from perfbench import roofline as RL

KERNELS = ("attn_walk_kernel",)


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl["work"].chunks:
        return None
    t = sum(s for n, s in sl["kernel_s"].items()
            if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    m = ctx["dims"]
    least = m["layers"] * sum(
        RL.prefill_chunk_bound_s(start, n, m["H"], m["hkv"], m["dk"],
                                 ctx["kv_bytes"])
        for start, n in sl["work"].chunks)
    return 100.0 * least / t
