"""Sync-free context-parallel decode of the port (``core/context_parallel``)
on 4 gloo ranks over one ``seq`` group, against the reference's
``decode_attention`` on the whole cache, at the reference test's shapes
(``tests/test_context_parallel.py``: b 2, L 256, H 4, hkv 2, d 16, fp32).

The paper's property, counted by ``distributed/comm.py``: the ConSmax
combine is exactly one all-reduce, softmax's three (a max and two sums),
and softmax moves more bytes. Each result is within relative 1e-5 of the
reference (fp32; the ranks' partial sums regroup the reference's one sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import random

from repro.configs.base import ConSmaxConfig
from repro.core import attention as A
from repro.core.consmax import consmax_init
from repro.nn.module import Ctx
from torch_mesh_worker import spawn

WORLD = 4


@pytest.fixture(scope="module")
def cp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp")
    b, L, H, hkv, d = 2, 256, 4, 2, 16
    q = random.normal(random.key(1), (b, 1, H, d), jnp.float32) * 0.1
    k = random.normal(random.key(2), (b, L, hkv, d), jnp.float32)
    v = random.normal(random.key(3), (b, L, hkv, d), jnp.float32)
    idx = jnp.array([200, 131], jnp.int32)
    params = consmax_init(Ctx(random.key(0)), "n", H, ConSmaxConfig())
    np.savez(tmp / "in.npz", q=q, k=k, v=v, index=idx,
             beta=params["beta"], gamma=params["gamma"])
    refs = {kind: np.asarray(A.decode_attention(
        q, k, v, idx, norm_kind=kind, norm_params=params,
        merged=kind == "consmax")) for kind in ("consmax", "softmax")}
    return spawn("cp", WORLD, dict(inputs=str(tmp / "in.npz")), tmp), refs


@pytest.mark.parametrize("kind", ["consmax", "softmax"])
def test_cp_decode_matches_reference_on_every_rank(cp_run, kind):
    results, refs = cp_run
    ref = refs[kind]
    for rank, res in enumerate(results):
        got = np.asarray(res[kind]["out"], np.float32)
        rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
        assert rel < 1e-5, (kind, rank, rel)


def test_cp_decode_collective_counts(cp_run):
    results, _ = cp_run
    for res in results:
        cs, sm = res["consmax"]["counts"], res["softmax"]["counts"]
        assert sum(c["calls"] for c in cs.values()) == 1, cs
        assert cs["all_reduce"]["calls"] == 1
        assert sum(c["calls"] for c in sm.values()) == 3, sm
        assert sm["all_reduce"]["calls"] == 3
        assert (sum(c["bytes"] for c in sm.values())
                > sum(c["bytes"] for c in cs.values()))
        # the one ConSmax collective is output-sized: b * H * d fp32
        assert cs["all_reduce"]["bytes"] == 2 * 4 * 16 * 4
