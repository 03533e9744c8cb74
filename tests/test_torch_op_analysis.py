"""The port's collective accounting (``distributed/op_analysis``) and op
cost (``distributed/op_cost``), one for one with the reference's
``tests/test_hlo_analysis.py``.

The reference parses collectives out of a canned HLO module; the port
costs collective records ``{kind, shape, dtype, group_size}``. The records
below are the canned module's collectives (an all-gather over groups of
2, a reduce-scatter over 8, one permute, and an all-reduce over groups of
4 inside a 12-trip loop, here 12 records), and they must give the
reference's bytes, counts and ring seconds — the reference's own
``collective_stats`` on its canned HLO is run beside them (the module is
pure Python).
"""
import pytest
import torch

from repro.distributed import hlo_analysis as JHA
from repro_torch.distributed import op_analysis as OA
from repro_torch.distributed.op_cost import op_cost

from test_hlo_analysis import HLO

RECORDS = (
    [{"kind": "all-gather", "shape": [128], "dtype": "float32",
      "group_size": 2},
     {"kind": "reduce-scatter", "shape": [16], "dtype": "float32",
      "group_size": 8},
     {"kind": "collective-permute", "shape": [16], "dtype": "float32",
      "group_size": 2}]
    + [{"kind": "all_reduce", "shape": [64], "dtype": "float32",
        "group_size": 4}] * 12)


def test_shape_bytes():
    assert OA.shape_bytes([64], torch.float32) == 256
    assert OA.shape_bytes((16, 512), "bfloat16") == 16384
    assert OA.shape_bytes((), torch.bool) == 1        # scalar -> 1 elem
    assert OA.shape_bytes((8,), torch.float8_e4m3fn) == 8


def test_shape_bytes_unknown_dtype_counted_not_costed():
    unknown = {}
    assert OA.shape_bytes((128, 256), "float4_e2m1fn_x2",
                          unknown=unknown) == 0
    assert unknown == {"float4_e2m1fn_x2": 1}
    assert OA.shape_bytes((8,), "float4_e2m1fn_x2", unknown=unknown) == 0
    assert unknown == {"float4_e2m1fn_x2": 2}
    assert OA.shape_bytes((2, 2), "someday_dtype") == 0


def test_collective_stats_unknown_dtype_in_summary():
    recs = [dict(r) for r in RECORDS]
    recs[0]["dtype"] = "float4_e2m1fn_x2"
    st = OA.collective_stats(recs, link_bw=50e9, num_devices=8)
    assert st.bytes_by_kind["all-gather"] == 0
    assert st.count_by_kind["all-gather"] == 1
    assert st.summary()["unknown_dtypes"] == {"float4_e2m1fn_x2": 1}
    assert "unknown_dtypes" not in OA.collective_stats(
        RECORDS, link_bw=50e9, num_devices=8).summary()


def test_collective_stats_counts_equal_reference():
    st = OA.collective_stats(RECORDS, link_bw=50e9, num_devices=8)
    assert st.bytes_by_kind["all-gather"] == 512
    assert st.bytes_by_kind["reduce-scatter"] == 512
    assert st.bytes_by_kind["collective-permute"] == 64
    assert st.bytes_by_kind["all-reduce"] == 12 * 256
    assert st.count_by_kind["all-reduce"] == 12
    ref = JHA.collective_stats(HLO, link_bw=50e9, num_devices=8)
    assert dict(st.bytes_by_kind) == dict(ref.bytes_by_kind)
    assert dict(st.count_by_kind) == dict(ref.count_by_kind)


def test_ring_model_math_equals_reference():
    st = OA.collective_stats(RECORDS, link_bw=1.0, num_devices=8)
    # all-gather 512 * 1/2 + reduce-scatter 512 * 7/8 + permute 64
    # + all-reduce 12 * 2 * 256 * 3/4
    assert abs(st.seconds - 5376) < 1e-6
    ref = JHA.collective_stats(HLO, link_bw=1.0, num_devices=8)
    assert abs(st.seconds - ref.seconds) < 1e-6


def test_multiplicity_and_missing_group_size():
    st = OA.collective_stats([{"kind": "all-reduce", "shape": [64],
                               "dtype": "float32", "multiplicity": 12}],
                             link_bw=1.0, num_devices=4)
    assert st.bytes_by_kind["all-reduce"] == 12 * 256
    assert abs(st.seconds - 4608) < 1e-6
    with pytest.raises(ValueError):
        OA.normalize_kind("gather-everything")


def test_op_cost_matmul_transcendental_and_bytes():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = op_cost(lambda: torch.exp(a @ b))
    assert c.matmul_flops == 2 * 8 * 16 * 4
    assert c.transcendentals == 32
    assert c.flops == 2 * 8 * 16 * 4 + 32
    # mm reads 8x16 + 16x4 and writes 8x4 fp32; exp reads and writes 8x4
    assert c.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * 32


def test_op_cost_views_gathers_and_slice_updates():
    t = torch.zeros(1000, 64)
    assert op_cost(lambda: t.view(64, 1000).t()[3]).bytes == 0
    idx = torch.tensor([1, 5, 9])
    # a gather reads the rows it takes: output twice plus the indices
    assert op_cost(lambda: t[idx]).bytes == 2 * 3 * 64 * 4 + 3 * 8
    # an in-place row update charges the rows and the index, twice
    rows = torch.ones(3, 64)
    c = op_cost(lambda: t.index_put_((idx,), rows))
    assert c.bytes == 2 * (3 * 64 * 4 + 3 * 8)
    # a slice copy charges the slice read and written, not the buffer
    assert op_cost(lambda: t[:2].copy_(rows[:2])).bytes == 2 * 2 * 64 * 4


def test_memory_tracker_follows_live_bytes():
    x = torch.zeros(256)

    def step(x):
        big = torch.ones(1024)           # 4 KiB, freed before the end
        small = big[:16].sum() + x       # 1 KiB kept as output
        del big
        x.add_(1.0)                      # in place: the alias
        return small, x

    with OA.track_memory((x,)) as mem:
        out = step(x)
    summary = OA.memory_summary(mem, out)
    assert summary["argument_bytes"] == 1024
    assert summary["alias_bytes"] == 1024
    assert summary["output_bytes"] == 2048
    assert OA.peak_bytes(summary) >= 1024 + 4096 + 1024
