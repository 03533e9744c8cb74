"""The decode kernel's share of its roofline over the traced slice, in %:
the least time of the decode rows served in the slice (per row and layer
each live K and V row, q and out once at 3.35 TB/s, or 4 dk H flops per key
at 989 TFLOP/s if larger), over the device time of the kernels the decode
op launches."""
from perfbench import roofline as RL

KERNELS = ("decode_partials",)


def read(ctx):
    sl = ctx["slice"]
    if sl is None or not sl["work"].decode_keys:
        return None
    t = sum(s for n, s in sl["kernel_s"].items()
            if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    m = ctx["dims"]
    least = m["layers"] * sum(
        RL.decode_row_bound_s(keys, m["H"], m["hkv"], m["dk"],
                              ctx["kv_bytes"])
        for keys in sl["work"].decode_keys)
    return 100.0 * least / t
