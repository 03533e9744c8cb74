"""The port's MoE (``repro_torch/models/moe.py``) against the reference's
``models/moe.py``, on the CPU: ``moe_apply`` outputs and aux for the
phi3.5-moe and grok smoke settings (silu-GLU and gelu-GLU experts) with the
softmax and the consmax router, a one-token (decode) and a chunk-sized call;
the capacity-drop case of ``tests/test_moe.py:56``; the capacity formula;
per-leaf gradients against ``jax.grad``.

Inputs are numpy draws from fixed seeds; weights come from the reference's
``moe_init``. Tolerances:

* fp32 compute: 1e-5 of the largest |y|. Both sides run the same fp32
  ops (router, products, weighted sum) in other summation orders; measured
  ~3e-7. The top-k expert choice must be identical (a near-tie flip would
  move a token's output by O(1)): the tests assert that no gap between the
  k-th and (k+1)-th router probability is below 1e-6 on their seeds, and
  that both packages pick the same experts.
* bf16 compute: 2^-6 of the largest |y|: each expert product rounds to bf16
  (2^-9 relative) in another accumulation order, three products deep.
* aux: 1e-6 relative (fp32 means over the same probabilities).
* gradients: 1e-5 of each leaf's largest |g| at fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.registry import get_config as jget
from repro.models import moe as JM
from repro.nn.module import Ctx
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import moe as TM

ARCHS = ["phi3.5-moe-42b-a6.6b", "grok-1-314b"]


def _pair(arch, router="softmax", cd="float32", **moe):
    jc = jget(arch, smoke=True, compute_dtype=cd)
    tc = tget(arch, smoke=True, compute_dtype=cd)
    kw = dict(n_experts=4, top_k=2, d_ff_expert=256, router_norm=router,
              **moe)
    jc, tc = jc.replace(moe=JMoEConfig(**kw)), tc.replace(
        moe=TMoEConfig(**kw))
    p = JM.moe_init(Ctx(random.key(0)), "moe", jc)
    if router == "consmax":                    # away from the init values
        p = dict(p, beta=jnp.float32(0.3), gamma=jnp.float32(2.5))
    mod = TM.MoE(tc, device="cpu")
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in p.items()})
    return jc, tc, p, mod


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _min_gap(p, x, jc):
    """Smallest gap between the k-th and (k+1)-th router probability."""
    logits = np.asarray(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                   p["router"]))
    if jc.moe.router_norm == "consmax":
        probs = np.exp(logits - float(p["beta"])) / float(p["gamma"])
    else:
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    srt = -np.sort(-probs, axis=-1)
    k = jc.moe.top_k
    return float((srt[..., k - 1] - srt[..., k]).min())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("router", ["softmax", "consmax"])
@pytest.mark.parametrize("b,s", [(3, 1), (2, 24)])
def test_moe_apply_matches_reference(arch, router, b, s):
    jc, tc, p, mod = _pair(arch, router)
    x = _x(b, s, jc.d_model, seed=s)
    assert _min_gap(p, x, jc) > 1e-6
    jy, jaux = JM.moe_apply(p, jnp.asarray(x), jc)
    with torch.no_grad():
        ty, taux = TM.moe_apply(mod, torch.tensor(x), tc)
        _, t_idx, _ = TM.route(mod, torch.tensor(x), tc)
    _, j_idx = jax.lax.top_k(
        jnp.einsum("bsd,de->bse", jnp.asarray(x), p["router"]),
        jc.moe.top_k)                          # both norms are monotone
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    jy = np.asarray(jy)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    jc, tc, p, mod = _pair(arch, cd="bfloat16")
    x = _x(2, 16, jc.d_model, seed=7)
    jy, _ = JM.moe_apply(p, jnp.asarray(x, jnp.bfloat16), jc)
    with torch.no_grad():
        ty, _ = TM.moe_apply(mod, torch.tensor(x).bfloat16(), tc)
    assert ty.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                               atol=2 ** -6 * np.abs(jy).max())


def test_capacity_drops_match_reference():
    """``tests/test_moe.py:56``: capacity factor 0.01, so 8 slots per
    expert for 128 assignments; the dropped tokens (zero rows) and every
    kept row equal the reference's."""
    jc, tc, p, mod = _pair("phi3.5-moe-42b-a6.6b", capacity_factor=0.01)
    x = _x(1, 64, jc.d_model, seed=1)
    assert TM.capacity(64, 2, 4, 0.01) == 8
    jy, _ = JM.moe_apply(p, jnp.asarray(x), jc)
    with torch.no_grad():
        ty, _ = TM.moe_apply(mod, torch.tensor(x), tc)
    jy = np.asarray(jy)
    zeros = np.abs(jy).sum(-1) == 0
    assert zeros.mean() > 0.3
    np.testing.assert_array_equal(ty.abs().sum(-1).numpy() == 0, zeros)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())


def test_capacity_matches_reference():
    for s in (1, 2, 7, 16, 64, 512, 513, 2048, 4096):
        for k, E, cf in ((1, 4, 1.25), (2, 4, 1.25), (2, 8, 1.25),
                         (2, 16, 1.25), (2, 16, 0.01), (2, 16, 2.0)):
            assert TM.capacity(s, k, E, cf) == JM._capacity(s, k, E, cf)
    assert TM.capacity(512, 2, 16, 1.25) == 80       # a serving chunk
    assert TM.capacity(1, 2, 16, 1.25) == 2          # decode: no drops


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.3]], np.float32)
    vals, idx = TM.top_k(torch.tensor(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_aux_grows_with_router_skew():
    """The Switch aux loss, as the reference's
    ``test_aux_loss_balanced_vs_skewed``: a router pinned to one expert
    scores above a random one, and both equal the reference's."""
    jc, tc, p, mod = _pair("phi3.5-moe-42b-a6.6b")
    x = _x(2, 32, jc.d_model, seed=3)
    skew = np.eye(jc.d_model, jc.moe.n_experts, dtype=np.float32) * 50
    auxes = []
    for router in (np.asarray(p["router"]), skew):
        _, jaux = JM.moe_apply(dict(p, router=jnp.asarray(router)),
                               jnp.asarray(x), jc)
        with torch.no_grad():
            mod.router.copy_(torch.tensor(router))
            _, taux = TM.moe_apply(mod, torch.tensor(x), tc)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
        auxes.append(float(taux))
    assert auxes[1] > auxes[0]


@pytest.mark.parametrize("router", ["softmax", "consmax"])
def test_moe_grads_match_jax_grad(router):
    """d(sum(y * r) + aux) per leaf: router, experts and the consmax
    router's beta / gamma."""
    jc, tc, p, mod = _pair("phi3.5-moe-42b-a6.6b", router)
    x = _x(2, 12, jc.d_model, seed=5)
    r = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(params):
        y, aux = JM.moe_apply(params, jnp.asarray(x), jc)
        return jnp.sum(y * r) + aux
    jg = jax.grad(jloss)(p)
    mod.requires_grad_(True)
    y, aux = TM.moe_apply(mod, torch.tensor(x), tc)
    (y * torch.tensor(r)).sum().add(aux).backward()
    for name, t in mod.named_parameters():
        ref = np.asarray(jg[name])
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
        assert np.abs(ref).max() > 0, name


def test_dispatch_backward_under_deterministic_algorithms():
    """Forward and backward through the drop-row scatter (duplicate
    indices: every dropped slot lands on it) run under
    ``use_deterministic_algorithms``, as the card's resume check does, and
    the output shape does not follow the routing."""
    jc, tc, _, mod = _pair("phi3.5-moe-42b-a6.6b", capacity_factor=0.01)
    mod.requires_grad_(True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for seed in (1, 2):
            y, aux = TM.moe_apply(mod, torch.tensor(_x(1, 64, jc.d_model,
                                                       seed)), tc)
            (y.sum() + aux).backward()
            outs.append(y.shape)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert outs[0] == outs[1] == (1, 64, jc.d_model)
