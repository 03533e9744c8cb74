"""The port's logical-axis rules (``distributed/sharding``) against the
reference's, in-process.

* ``make_rules`` equals the reference's table on meshes (1, 1), (2, 4),
  (16, 16) and (2, 16, 16), for every fsdp / seq_shard_kv / serve_tp2d /
  expert_shard choice. Both packages' resolvers read only the mesh's axis
  names and sizes, so a duck-typed mesh serves them without devices.
* ``resolve_spec`` and its fallbacks equal the reference's for every leaf
  of ``lm_axes``, ``cache_axes`` (plain, quantized, paged) and
  ``state_axes``, on every arch of ``ARCH_IDS`` at full width (meta /
  abstract shapes). The port's block leaves are per layer: their spec is
  the reference's stacked spec without its leading (``layers``, never
  sharded) entry, their fallbacks the stacked leaf's.
* ``lm_axes`` and ``state_axes`` equal the reference's leaf by leaf,
  through ``weights.ref_leaf``.
* ``shard`` returns its very argument outside ``activation_sharding`` and
  for a plain tensor inside it.
* The dry run replicates nothing at the four sites where DTensor used to
  refuse the reference's placements (``_ReplicateOnRefusal``'s ``op:``
  fallbacks), on fake meshes: the q / k / v head views where the heads do
  not divide the model axis (``sharding.rows_times``), the head-group and
  score views where the KV heads fall back (``attention_on_shards``), the
  MoE dispatch's views and xLSTM's ``log_sigmoid_forward``. Real ranks of a
  (2, 2) gloo mesh run such cells (three heads on two, one KV head on two,
  the MoE, the xLSTM) with logits equal to one device's within 1e-5 of
  their scale, as ``tests/test_torch_dryrun.py``'s gpt2 cell (the xLSTM
  decode step 1e-4: see ``REL``). One subprocess per world,
  each with a 120 s limit.
"""
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.train import step as JTS
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import step as TS
from repro_torch.weights import ref_leaf
from torch.distributed.tensor import Replicate, Shard

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


class DuckMesh:
    """Axis names and sizes, the only part of a mesh the resolvers read."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape, dtype=np.int8)
        self.shape = tuple(shape)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("fsdp", [True, "zero1", False])
def test_make_rules_equal_reference(shape, fsdp):
    mesh = DuckMesh(shape, MESHES[shape])
    for ssk, tp2d, ex in itertools.product([False, "dp", "model", "2d"],
                                           [False, True], [False, True]):
        kw = dict(fsdp=fsdp, seq_shard_kv=ssk, serve_tp2d=tp2d,
                  expert_shard=ex)
        assert SH.make_rules(mesh, **kw) == JSH.make_rules(mesh, **kw), kw


def _check_leaf(port_shape, ref_shape, axes_port, axes_ref, mesh, rules,
                jrules, stacked, where):
    pf, jf = [], []
    got = SH.resolve_spec(port_shape, axes_port, mesh, rules, pf)
    want = _spec(JSH.resolve_spec(ref_shape, axes_ref, mesh, jrules, jf))
    if stacked:
        assert want[:1] in ((), (None,)), (where, want)
        want = want[1:]
    assert got == want, (where, got, want)
    assert [(lg, d) for _, lg, d in pf] == [(lg, d) for _, lg, d in jf], where
    return len(pf)


def _rules(mesh, **kw):
    return SH.make_rules(mesh, **kw), JSH.make_rules(mesh, **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_equal_reference(arch):
    cfg, jcfg = tget(arch), jget(arch)
    jabs = dict(_flat(JT.lm_abstract(jcfg)))
    jax_axes = dict(_flat(JT.lm_axes(jcfg)))
    tabs = {n: p for n, p in T.lm_abstract(cfg).named_parameters()}
    axes = T.lm_axes(cfg)
    n_fb = 0
    for shape in [(16, 16), (2, 16, 16), (2, 4)]:
        mesh = DuckMesh(shape, MESHES[shape])
        for kw in (dict(fsdp=True), dict(fsdp=False),
                   dict(fsdp=True, expert_shard=True)):
            rules, jrules = _rules(mesh, **kw)
            seen = set()
            for name, p in tabs.items():
                rl = ref_leaf(name)
                if rl in seen:
                    continue
                seen.add(rl)
                n_fb += _check_leaf(tuple(p.shape), jabs[rl].shape,
                                    axes[name], jax_axes[rl], mesh, rules,
                                    jrules, rl != name, (arch, name, kw))
    # the optimizer state: m / v take their parameter's spec and fallbacks
    mesh = DuckMesh((16, 16), MESHES[(16, 16)])
    rules, jrules = _rules(mesh, fsdp=True)
    tcfg, jtcfg = TrainConfig(), JTrainConfig()
    jstate = JTS.abstract_state(jcfg, jtcfg) if arch in (
        "qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b") \
        else None
    if jstate is not None:
        jst_axes = JTS.state_axes(jcfg, jtcfg)
        st_axes = TS.state_axes(cfg, tcfg)
        jm = dict(_flat(jstate["opt"]["m"]))
        jma = dict(_flat(jst_axes["opt"]["m"]))
        for name, p in tabs.items():
            rl = ref_leaf(name)
            _check_leaf(tuple(p.shape), jm[rl].shape,
                        st_axes["opt"]["m"][name], jma[rl], mesh, rules,
                        jrules, rl != name, (arch, "opt.m", name))
    assert n_fb >= 0


def _cache_trees(cfg, jcfg, kind):
    b, L = 128, 32768
    if kind == "paged":
        pages, ps = 2048, 16
        return (T.init_paged_caches(cfg, b, pages, ps, device="meta"),
                jax.eval_shape(lambda: JT.init_paged_caches(jcfg, b, pages,
                                                            ps)))
    dt = "int8" if kind == "quantized" else "bfloat16"
    jdt = jnp.int8 if kind == "quantized" else jnp.bfloat16
    return (T.init_caches(cfg, b, L, dt, device="meta"),
            jax.eval_shape(lambda: JT.init_caches(jcfg, b, L, kv_dtype=jdt)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    cfg, jcfg = tget(arch), jget(arch)
    kinds = ["plain", "quantized"]
    if all(k in ("attn", "attn_moe", "global", "local")
           for k in cfg.block_pattern):
        kinds.append("paged")
    for kind in kinds:
        caches, jcaches = _cache_trees(cfg, jcfg, kind)
        quant, paged = kind == "quantized", kind == "paged"
        axes = T.cache_axes(cfg, quantized=quant, paged=paged)
        jaxes = JT.cache_axes(jcfg, quantized=quant, paged=paged)
        assert len(caches) == len(axes) == cfg.n_super_layers
        leaves = dict(_flat(caches[0]))
        leaf_axes = dict(_flat(axes[0]))
        jleaves, jleaf_axes = dict(_flat(jcaches)), dict(_flat(jaxes))
        assert set(leaves) == set(jleaves) == set(leaf_axes)
        for name in leaves:
            assert "layers," + leaf_axes[name] == jleaf_axes[name], name
        for shape in [(16, 16), (2, 16, 16), (2, 4)]:
            mesh = DuckMesh(shape, MESHES[shape])
            for ssk in (False, "dp", "model", "2d"):
                rules, jrules = _rules(mesh, seq_shard_kv=ssk)
                for name, t in leaves.items():
                    _check_leaf(tuple(t.shape), jleaves[name].shape,
                                leaf_axes[name], jleaf_axes[name], mesh,
                                rules, jrules, True, (arch, kind, name, ssk))


@pytest.mark.parametrize("arch", ARCH_IDS + ["gpt2-consmax"])
def test_lm_axes_equal_reference(arch):
    jaxes = dict(_flat(JT.lm_axes(jget(arch))))
    axes = T.lm_axes(tget(arch))
    for name, ax in axes.items():
        rl = ref_leaf(name)
        assert (ax if rl == name else "layers," + ax) == jaxes[rl], name
    assert {ref_leaf(n) for n in axes} == set(jaxes)


def _as_ref(tree):
    """A port axes tree keyed by the port's parameter names, as the
    reference's nested tree (block leaves with their ``layers`` axis)."""
    if not isinstance(tree, dict):
        return tree
    if tree and all("." in k or k in ("embed", "final_norm")
                    for k in tree):
        out = {}
        for name, ax in tree.items():
            rl = ref_leaf(name)
            node = out
            *parents, leaf = rl.split(".")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = ax if rl == name else "layers," + ax
        return out
    return {k: _as_ref(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["fsdp", "zero1", "int8_ef"])
def test_state_axes_equal_reference(case):
    kw = ({"grad_compression": "int8_ef"} if case == "int8_ef"
          else {"fsdp": case == "fsdp"} if case == "fsdp"
          else {"fsdp": "zero1"})
    for arch in ("gpt2-consmax", "qwen2-1.5b", "phi3.5-moe-42b-a6.6b"):
        got = _as_ref(TS.state_axes(tget(arch), TrainConfig(**kw)))
        want = JTS.state_axes(jget(arch), JTrainConfig(**kw))
        assert got == want, (arch, case)


def test_shard_returns_its_argument_outside_a_context():
    x = torch.ones(2, 3)
    assert SH.shard(x, "act_batch,act_embed") is x
    mesh = DuckMesh((2, 4), MESHES[(2, 4)])
    with SH.activation_sharding(mesh, SH.make_rules(mesh)):
        assert SH.shard(x, "act_batch,act_embed") is x


def test_placements_and_local_shape():
    mesh = DuckMesh((2, 16, 16), MESHES[(2, 16, 16)])
    spec = (("pod", "data"), None, "model")
    assert SH.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements((), mesh) == (Replicate(),) * 3
    assert SH.local_shape((64, 3, 32), spec, mesh) == (2, 3, 2)


# ----------------------------------------- the dry run's fallback sites ----
SITE_CELLS = [
    dict(name="qwen2-heads-not-dividing-decode", arch="qwen2-1.5b",
         shape="decode_32k", mesh=[2, 8]),
    dict(name="qwen2-heads-not-dividing-prefill", arch="qwen2-1.5b",
         shape="prefill_32k", mesh=[2, 8]),
    dict(name="chatglm3-kv-heads-fall-back-decode", arch="chatglm3-6b",
         shape="decode_32k", mesh=[2, 4], overrides=dict(n_kv_heads=2)),
    dict(name="chatglm3-kv-heads-fall-back-prefill", arch="chatglm3-6b",
         shape="prefill_32k", mesh=[2, 4], overrides=dict(n_kv_heads=2)),
    dict(name="chatglm3-kv-heads-fall-back-train", arch="chatglm3-6b",
         shape="train_4k", mesh=[2, 4], overrides=dict(n_kv_heads=2)),
    dict(name="phi3.5-moe-prefill", arch="phi3.5-moe-42b-a6.6b",
         shape="prefill_32k", mesh=[2, 2, 2], batch=4),
    dict(name="xlstm-decode", arch="xlstm-1.3b", shape="decode_32k",
         mesh=[2, 4]),
]
for _c in SITE_CELLS:
    _c.setdefault("batch", 8)
    _c.setdefault("seq", 64)


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    return W.spawn("sites", 1, dict(cells=SITE_CELLS),
                   tmp_path_factory.mktemp("sites"))[0]


@pytest.mark.parametrize("name", [c["name"] for c in SITE_CELLS])
def test_no_replication_at_the_fallback_sites(sites, name):
    rec = sites[name]
    assert rec["collectives"]
    if name.startswith("xlstm"):
        # the log-sigmoid site; the mLSTM decode step's einsums (batch and
        # heads split over two axes) still replicate their heads
        assert not [f for f in rec["op_fallbacks"]
                    if f[1] == "op:log_sigmoid_forward"], rec
    else:
        assert rec["op_fallbacks"] == [], rec


F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
RANK_CELLS = [
    dict(name="three-heads-on-two", arch="qwen2-1.5b", shape="decode_32k",
         overrides=dict(F32, n_heads=3, head_dim=32)),
    dict(name="kv-heads-fall-back-decode", arch="chatglm3-6b",
         shape="decode_32k", overrides=F32),
    dict(name="kv-heads-fall-back-prefill", arch="chatglm3-6b",
         shape="prefill_32k", overrides=F32),
    dict(name="moe-decode", arch="phi3.5-moe-42b-a6.6b", shape="decode_32k",
         overrides=F32),
    dict(name="xlstm-decode", arch="xlstm-1.3b", shape="decode_32k",
         overrides=F32),
]
for _c in RANK_CELLS:
    _c.update(batch=8, seq=64, mesh=[2, 2])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.spawn("cells", 4, dict(cells=RANK_CELLS),
                   tmp_path_factory.mktemp("ranks"))


# Logits of the sharded step against one device's, relative to their
# largest: 1e-5, the gpt2 cell's bound (tests/test_torch_dryrun.py). The
# xLSTM decode step reads a random recurrent state, and its per-head
# normalization of small outputs amplifies the reordered sums of the
# sharded products: before the changes these tests cover, the same cell
# measured 1.75e-4 at a scale of 3.34 (5.2e-5), so its bound is 1e-4
REL = {"xlstm-decode": 1e-4}


@pytest.mark.parametrize("name", [c["name"] for c in RANK_CELLS])
def test_sharded_cells_equal_one_device(ranks, name):
    for res in ranks:
        got = res[name]
        assert got["shape"] == [8, 512]
        assert got["err"] <= REL.get(name, 1e-5) * max(got["scale"], 1.0), \
            got
