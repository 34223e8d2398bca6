"""Explicit expert-parallel MoE dispatch on a logical mesh: two
all-to-alls over the expert axis (the port of the JAX package's
``parallel/moe_ep.py``).

Per rank, as the reference's ``shard_map`` body:

  route the rank's tokens -> per-destination-rank capacity buffers
  all-to-all over the expert ('model') axis      [token payload only]
  local expert FFN (weights all-gathered over the FSDP axes, as FSDP does)
  all-to-all back -> combine with gates

One controller runs every rank's step in turn, and each collective is a
copy between the ranks' tensors: on a mesh that repeats a device a copy
on that device, between two cards a peer copy (docs/port.md §parallel).
Wire bytes per rank per layer and direction: ``E · cap · d`` in the
model dtype, which is ``tokens_loc · top_k · d`` times the capacity
factor, the minimum for token-choice routing up to the capacity's slack.

Each all-to-all and each FSDP gather reports its bytes, summed over the
ranks, to ``launch/hlo_cost.py``'s ``record_collective`` (the dry run's
explicit collectives), and so does each transpose in the backward (the
all-to-all of the gradients, the reduce-scatter of a gathered weight's
gradient) when autograd computes it. Each call leaves its counts in
``moe_ep_apply.last``: the dropped assignments per rank (a tensor on rank
0's device), the bytes each all-to-all copies (all of them, and those
between distinct ranks), ``cap`` and ``n_loc``.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch.launch.hlo_cost import record_collective

from .sharding import P, shard, unshard


def _group(mesh, rank: int, axes) -> list:
    """The ranks that share ``rank``'s coordinates off ``axes``, in
    row-major order over ``axes`` (the order of a collective over
    them)."""
    base = mesh.coords(rank)
    out = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        out.append(mesh.rank({**base, **dict(zip(axes, idx))}))
    return out


def _report(kind: str, t, nbytes: int, nelems: int, back: str,
            back_share: int = 1) -> None:
    """Report a collective of ``kind`` that produced ``t``, and, when a
    gradient will flow through ``t``, its transpose ``back`` (moving a
    ``back_share``-th of the bytes) once that gradient is computed."""
    record_collective(kind, nbytes, nelems)
    if t.requires_grad:
        t.register_hook(lambda g: record_collective(
            back, nbytes // back_share, nelems // back_share))


def moe_ep_apply(xt, idx, gates, w_gate, w_up, w_down, *, mesh, dp_axes,
                 ep_axis: str, fsdp_axes, capacity_factor: float,
                 top_k: int, n_experts: int):
    """xt: (N, d) tokens; idx/gates: (N, k) routing; weights (E, d, f) and
    (E, f, d). Returns the (N, d) combined expert outputs on rank 0's
    device.

    Tokens split contiguously over ``dp_axes + (ep_axis,)``, data-major,
    and each rank prices its own capacity ``cap`` from its ``n_loc``
    tokens. Weights are placed by ``P(ep_axis, fsdp_axes, None)``
    (views, :func:`~repro_torch.parallel.sharding.shard`); with
    ``fsdp_axes`` each rank gathers its experts' ``(E_loc, d, f)`` along
    dim 1 for the call and frees them after.
    """
    ep = mesh.shape[ep_axis]
    e_loc = n_experts // ep
    n, d = xt.shape
    # tokens shard over dp AND ep axes: without the ep split, the ep ranks
    # of one dp row would all route the same (replicated) tokens
    tok_axes = tuple(dp_axes or ()) + (ep_axis,)
    dp_size = 1
    for a in tok_axes:
        dp_size *= mesh.shape[a]
    n_loc = n // dp_size
    cap = int(max(top_k, capacity_factor * n_loc * top_k / n_experts))
    dtype = xt.dtype
    fsdp = tuple(fsdp_axes or ())

    tok_spec = P(tok_axes, None)
    xs, ids, gs = (shard(t, tok_spec, mesh) for t in (xt, idx, gates))
    w_spec = P(ep_axis, fsdp_axes, None)
    wg, wu, wd = (shard(w, w_spec, mesh) for w in (w_gate, w_up, w_down))
    ranks = range(mesh.size)
    devs = mesh.devices

    # per rank: each assignment's place in its expert's local capacity;
    # the send buffer is (ep, E_loc, C, d), dim 0 the destination rank,
    # and a dropped assignment goes to a spare row past it
    plans, sends = [], []
    for r in ranks:
        nk = ids[r].reshape(-1)
        onehot = F.one_hot(nk, n_experts)
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
        keep = pos < cap
        slot = nk * cap + pos.clamp(max=cap - 1)
        buf = torch.zeros((n_experts * cap + 1, d), dtype=dtype,
                          device=devs[r])
        buf.index_copy_(0, torch.where(keep, slot, n_experts * cap),
                        xs[r].repeat_interleave(top_k, dim=0))
        sends.append(buf[:-1].view(ep, e_loc, cap, d))
        plans.append((slot, keep))

    def all_to_all(bufs, recv_shape, place):
        """Rank ``r`` at ep coordinate ``j`` receives, from the rank at
        ep coordinate ``s`` of its group, that rank's ``bufs[.][j]``,
        written by ``place(out, s, piece)``."""
        out, moved = [], [0, 0]
        for r in ranks:
            j = mesh.coords(r)[ep_axis]
            recv = torch.empty(recv_shape, dtype=dtype, device=devs[r])
            for s, src in enumerate(_group(mesh, r, (ep_axis,))):
                piece = bufs[src][j]
                place(recv, s, piece)
                moved[0] += piece.numel() * piece.element_size()
                moved[1] += (src != r) * piece.numel() * piece.element_size()
            out.append(recv)
        _report("all-to-all", out[0], moved[0], moved[0] // xt.itemsize,
                "all-to-all")
        return out, moved

    # token payload crosses the wire exactly once each way; recv is laid
    # out (E_loc, ep_src, C, d) so each local expert's rows are contiguous
    recvs, sent = all_to_all(
        sends, (e_loc, ep, cap, d),
        lambda out, s, piece: out[:, s].copy_(piece))
    del sends
    ys = []
    for r in ranks:
        wgr, wur, wdr = wg[r], wu[r], wd[r]
        if fsdp:  # the FSDP gather: undo the dim-1 shard for this layer
            peers = _group(mesh, r, fsdp)
            wgr, wur, wdr = (torch.cat([w[p].to(devs[r]) for p in peers],
                                       dim=1) for w in (wg, wu, wd))
            if r == 0:  # one gather per weight; every rank's is this shape
                for w in (wgr, wur, wdr):
                    k = w.numel() * mesh.size
                    _report("all-gather", w, k * w.element_size(), k,
                            "reduce-scatter", len(peers))
        xr = recvs[r].view(e_loc, ep * cap, d)
        h = F.silu(torch.bmm(xr, wgr)) * torch.bmm(xr, wur)
        ys.append(torch.bmm(h, wdr).view(e_loc, ep, cap, d))
        del wgr, wur, wdr, h
    del recvs
    # back: (ep_dest == expert rank, E_loc, C, d), the layout of the send
    # buffer; y's slice [:, s] holds source s's rows
    backs, returned = all_to_all(
        [y.transpose(0, 1) for y in ys], (ep, e_loc, cap, d),
        lambda out, s, piece: out[s].copy_(piece))
    del ys
    outs = []
    for r in ranks:
        slot, keep = plans[r]
        val = backs[r].view(n_experts * cap, d)[slot]
        val = torch.where(keep[:, None], val, 0)
        outs.append((val.view(n_loc, top_k, d)
                     * gs[r][..., None].to(dtype)).sum(1))
    out = unshard(outs, tok_spec, mesh)
    _moe_ep_apply.last = {
        "dropped": torch.stack([(~keep).sum().to(devs[0])
                                for _, keep in plans]),
        "a2a_bytes": (sent[0], returned[0]),
        "a2a_cross_bytes": (sent[1], returned[1]),
        "cap": cap, "n_loc": n_loc,
    }
    return out


moe_ep_apply.last = None
#: The function itself, under a name that a caller wrapping
#: ``moe_ep.moe_ep_apply`` does not replace: the counts stay on it.
_moe_ep_apply = moe_ep_apply
