"""Expert-parallel MoE dispatch over an explicit all-to-all — the
reference's ``models/moe_ep.py``.

Per data rank: route its tokens, sort the (token, expert) slots by the
rank that owns their expert, fill fixed-capacity send buffers, exchange
them (``all_to_all``), run the local experts' GLU, send the results back
(``all_to_all``), unsort and combine with the routing weights. Experts are
split over the group in contiguous blocks (rank r owns experts
``[r E/n, (r+1) E/n)``, E % n == 0). Traffic is two activation-sized
all-to-alls per layer, two more in backward: ``Comm.all_to_all`` is
differentiable, so autograd flows back through both exchanges.

The parameters come in whole (replicated, or unsharded by FSDP for the
forward); each rank reads its experts' rows of ``gate`` / ``up`` /
``down``, so its gradients land there and are zero elsewhere. Averaging
the gradients over the data ranks then gives the global-mean gradient:
each expert's rows get every rank's tokens once, from the rank that owns
it.

The aux loss is each rank's router statistic averaged over the group (the
reference's ``pmean``); its gradient stays on the local term, which,
averaged over the ranks, is the gradient of the mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.comm import Comm
from repro_torch.models import moe as MOE


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _pmean_value(comm: Comm, t):
    """The group mean of the 0-d ``t`` as its value; the gradient flows to
    the local ``t`` alone."""
    mean = comm.all_reduce(t.detach().clone()) / comm.size
    return t + (mean - t).detach()


def _capacity_dispatch(key, n_bins: int, cap: int):
    """Stable sort of ``key`` (values in [0, n_bins], n_bins = dropped);
    returns (order, the buffer row of each sorted slot: bin * cap + rank in
    its bin, or the drop row n_bins * cap past capacity, and keep)."""
    order = torch.argsort(key, stable=True)
    ks = key[order]
    oh = F.one_hot(ks, n_bins + 1)[:, :n_bins].to(torch.int32)
    pos = (oh.cumsum(dim=0) - 1).gather(
        1, ks.clamp(max=n_bins - 1)[:, None])[:, 0]
    keep = (pos < cap) & (ks < n_bins)
    return order, torch.where(keep, ks * cap + pos, n_bins * cap), keep


def _scatter(rows: int, bidx, values, fill):
    """A (rows, ...) buffer of ``fill`` with ``values`` at ``bidx``; slots
    at the drop row ``rows`` land on a spare row that is cut off."""
    buf = torch.full((rows + 1,) + values.shape[1:], fill,
                     dtype=values.dtype, device=values.device)
    return buf.index_put((bidx,), values)[:rows]


def moe_apply_ep(p: MOE.MoE, x, cfg: ModelConfig, comm: Comm):
    """x: (b, s, d), this rank's rows -> (y (b, s, d) in the compute dtype,
    aux 0-d fp32 averaged over the group)."""
    m = cfg.moe
    n, r = comm.size, comm.rank
    E, k = m.n_experts, m.top_k
    if E % n:
        raise ValueError(f"expert parallelism: {E} experts over {n} ranks")
    e_loc = E // n
    b, s, d = x.shape
    cdt = cfg.cdtype()
    T = b * s
    slots = T * k
    act = (F.silu if cfg.mlp == "silu_glu"
           else lambda t: F.gelu(t, approximate="tanh"))

    w, idx, aux = MOE.route(p, x, cfg)
    aux = _pmean_value(comm, aux)
    x2d = x.reshape(T, d)
    slot_e = idx.reshape(slots)                        # destination expert
    slot_tok = torch.arange(slots, device=x.device) // k
    dst = slot_e // e_loc                              # destination rank
    c_pair = _round8(int(slots * m.capacity_factor / n))
    order, bidx, keep = _capacity_dispatch(dst, n, c_pair)
    send_x = _scatter(n * c_pair, bidx, x2d[slot_tok[order]].to(cdt), 0)
    send_e = _scatter(n * c_pair, bidx,
                      (slot_e % e_loc)[order].to(torch.int32), -1)

    # all-to-all 1: slots to the rank owning their expert
    recv_x = comm.all_to_all(send_x)
    recv_e = comm.all_to_all(send_e)

    # the local experts' dispatch, as moe.dispatch does per row
    c_loc = min(_round8(int(n * c_pair * m.capacity_factor / e_loc)),
                n * c_pair)
    key = torch.where(recv_e >= 0, recv_e, e_loc).long()
    order2, bidx2, keep2 = _capacity_dispatch(key, e_loc, c_loc)
    buf = _scatter(e_loc * c_loc, bidx2, recv_x[order2], 0)
    buf = buf.reshape(e_loc, c_loc, d)
    lo, hi = r * e_loc, (r + 1) * e_loc
    h = act(torch.bmm(buf, p.gate[lo:hi].to(cdt))) * torch.bmm(
        buf, p.up[lo:hi].to(cdt))
    out = torch.bmm(h, p.down[lo:hi].to(cdt)).reshape(e_loc * c_loc, d)
    y_sorted = out[bidx2.clamp(max=e_loc * c_loc - 1)] * keep2[:, None].to(
        cdt)
    y_recv = y_sorted[torch.argsort(order2)]           # inverse permutation

    # all-to-all 2: results back to the rank that sent the slot
    y_send = comm.all_to_all(y_recv)
    y_slot_sorted = y_send[bidx.clamp(max=n * c_pair - 1)] * keep[
        :, None].to(cdt)
    y_slots = y_slot_sorted[torch.argsort(order)]
    y = (y_slots.reshape(b, s, k, d) * w.to(cdt)[..., None]).sum(dim=2)
    return y, aux
