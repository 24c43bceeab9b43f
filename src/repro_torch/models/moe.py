"""Mixture-of-Experts FFN (arctic-480b, grok-1-314b).

GShard-style top-k dispatch with capacity, written as einsums over a
one-hot dispatch tensor, as in the reference:

* tokens are routed in groups of ``min(MOE_GROUP, S)`` (dispatch memory
  (B, groups, G, E, C) with capacity C = max(int(G k cf / E), k)), so a
  decode step routes one token per group;
* the top-k is iterative: each round takes the argmax expert of what is
  left (the lowest index on ties, as ``jnp.argmax``) and gives the token
  the next free slot of that expert; a token past capacity is dropped;
* ``dispatch`` is in ``cfg.dtype``, ``combine`` in fp32, normalised by
  the token's kept gate mass;
* the router's GShard load-balancing term is returned beside the output
  (`moe_mlp`); `moe_mlp_y`, the residual block's FFN, drops it.

Arctic's "dense residual": a SwiGLU runs beside the experts and both add
into the residual stream.

On a mesh (DTensor, `parallel.axes`) the reference's ``shard``
annotations pin the groups to the batch axes and the expert tensors to
the ``experts`` axis (expert parallelism where the expert count divides
the ``model`` axis, arctic's 128; else the ``mlp`` dim carries the
tensor parallelism, grok-1's 8 on 16), the expert weights are gathered
over their ZeRO-3 dim before use, and under the serving rules the
experts run weight-stationary (`_expert_ffn_weight_stationary`, the
reference's).  The routing (argmax, the comparison one-hots, the
cumulative positions) runs on the DTensors as it does on tensors; the
einsums run per rank (`parallel.axes.einsum`): torch 2.11's DTensor
cannot flatten the split experts dim inside them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.axes import (P, _mesh, einsum, gather_fsdp,
                                       is_dtensor, placements,
                                       reduce_grad_partial, reduce_partial,
                                       resolve, serving_mode, shard)

MOE_GROUP = 2048          # dispatch group size (tokens)


def init_moe(cfg: ModelConfig, gen: torch.Generator, scale: float,
             lead: tuple = ()):
    """Router (scale 0.02) and expert weights drawn from ``gen``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = dict(
        router=cm._normal(gen, (*lead, d, e), 0.02),
        we_gate=cm._normal(gen, (*lead, e, d, f), scale),
        we_up=cm._normal(gen, (*lead, e, d, f), scale),
        we_down=cm._normal(gen, (*lead, e, f, d), scale),
    )
    if cfg.dense_residual:
        p["dense"] = cm.init_mlp(cfg, gen, scale, lead)
    return p


def moe_specs(cfg: ModelConfig):
    p = dict(router=(None, None),
             we_gate=("experts", "fsdp", "mlp"),
             we_up=("experts", "fsdp", "mlp"),
             we_down=("experts", "mlp", "fsdp"))
    if cfg.dense_residual:
        p["dense"] = cm.mlp_specs()
    return p


def capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def route(cfg: ModelConfig, gates, c: int):
    """Iterative top-k with positional (capacity) assignment.

    gates (B, ng, G, E) fp32 -> dispatch (B, ng, G, E, C) in
    ``cfg.dtype`` (1 where a token takes a slot) and combine (same shape,
    fp32: the token's gate there over its kept gate mass).  The same
    float operations as the reference, in the same order.
    """
    b, ng, g, e = gates.shape
    dev = gates.device
    remaining = gates
    dispatch = torch.zeros((b, ng, g, e, c), dtype=cfg.dtype, device=dev)
    combine = torch.zeros((b, ng, g, e, c), dtype=torch.float32, device=dev)
    fill = torch.zeros((b, ng, e), dtype=torch.int32, device=dev)
    gate_sum = torch.zeros((b, ng, g), dtype=torch.float32, device=dev)
    slots = torch.arange(c, dtype=torch.float32, device=dev)
    experts = torch.arange(e, device=dev)
    for _ in range(cfg.top_k):
        idx = remaining.argmax(-1)                        # (B,ng,G)
        # one-hot by comparison: the same ops on every device (F.one_hot
        # takes another path on meta tensors, see launch.dryrun)
        mask = (idx[..., None] == experts).float()
        gval = (remaining * mask).sum(-1)                 # (B,ng,G)
        remaining = remaining * (1.0 - mask)
        pos = mask.cumsum(2) - mask + fill[:, :, None, :].float()
        slot = (pos * mask).sum(-1)                       # (B,ng,G)
        ok = (slot < c) & (gval > 0)
        # jax.nn.one_hot gives a zero row for a slot past capacity, where
        # F.one_hot would raise: compare against the slot indices instead
        slot_oh = (slot[..., None] == slots).float() * ok[..., None].float()
        d_k = mask[..., None] * slot_oh[..., None, :]     # (B,ng,G,E,C)
        dispatch = dispatch + d_k.to(cfg.dtype)
        combine = combine + d_k * gval[..., None, None]
        gate_sum = gate_sum + gval * ok.float()
        fill = fill + (mask * ok[..., None].float()).sum(2).to(torch.int32)
    combine = combine / gate_sum.clamp_min(1e-9)[..., None, None]
    return dispatch, combine


def _moe_y(cfg: ModelConfig, p, x):
    """x (B, S, d) -> (y (B, S, d), gates (B, ng, G, E))."""
    b, s, d = x.shape
    g = min(MOE_GROUP, s)
    if s % g:
        raise ValueError(f"sequence {s} is not a multiple of the dispatch "
                         f"group {g}")
    ng = s // g
    x = reduce_grad_partial(x)
    xg = shard(x.reshape(b, ng, g, d), "batch", None, None, None)
    logit = _router_logits(xg.float(), p["router"].float())
    gates = torch.softmax(logit, -1)                      # (B,ng,G,E)
    dispatch, combine = route(cfg, gates, capacity(cfg, g))

    # dispatch -> expert FFN -> combine; on a mesh the one-hots are
    # split over the experts' axes as the reference's partitioner
    # propagates its pin of xe back into them: each rank dispatches to,
    # and combines from, its own experts' slots
    dt = cfg.dtype
    dispatch = shard(dispatch, "batch", None, None, "experts", None)
    xe = einsum("bngec,bngd->bnecd", dispatch, xg)
    if serving_mode() and _mesh() is not None and is_dtensor(xe):
        ye = _expert_ffn_weight_stationary(cfg, p, xe)
    else:
        specs = moe_specs(cfg)

        def w(name):
            return gather_fsdp(p[name].to(dt), specs[name])

        xe = shard(xe, "batch", None, "experts", None, None)
        h = (F.silu(einsum("bnecd,edf->bnecf", xe, w("we_gate")))
             * einsum("bnecd,edf->bnecf", xe, w("we_up")))
        h = shard(h, "batch", None, "experts", None, "mlp")
        ye = reduce_partial(einsum("bnecf,efd->bnecd", h, w("we_down")))
    combine = shard(combine.to(dt), "batch", None, None, "experts", None)
    y = reduce_partial(einsum("bngec,bnecd->bngd", combine, ye))
    y = y.reshape(b, s, d)
    if cfg.dense_residual:
        y = y + cm.mlp(cfg, p["dense"], x)
    return y, gates


def _router_logits(xg, router):
    """``xg @ router``.  On a mesh whose experts split the ``model`` axis
    (arctic-style expert parallelism, training rules) the product runs on
    each model rank's experts (the router's columns), forward and
    backward, as the reference's partitioner splits it; the logits are
    then gathered for the routing, which runs on every rank."""
    if not (is_dtensor(router) and _mesh() is not None) or serving_mode():
        return einsum("bngd,de->bnge", xg, router)
    spec = resolve((None, "experts"), router.shape)
    if len(spec) < 2:
        return einsum("bngd,de->bnge", xg, router)
    mesh = router.device_mesh
    split = placements(spec, mesh)
    logit = einsum("bngd,de->bnge", xg,
                   router.redistribute(mesh, [
                       q if q == Shard(1) else p
                       for p, q in zip(router.placements, split)]))
    return logit.redistribute(mesh, [Replicate() if q == Shard(3) else q
                                     for q in logit.placements])


def _expert_ffn_weight_stationary(cfg: ModelConfig, p, xe):
    """Serving: the weight-stationary expert FFN, the reference's.

    Left to itself the partitioner would all-gather the expert weights
    over their ZeRO-3 dim at every decode step.  Here the expert weights
    stay in their resident (experts -> model, hidden -> data) shards, the
    small decode activations are brought to the experts' layout, each
    rank computes its hidden-dim partial, and the down projection's
    partial sums are all-reduced over the hidden dim's axes: one
    ``Partial`` placement and one redistribute.
    """
    dt = cfg.dtype
    mesh = xe.device_mesh
    names = list(mesh.mesh_dim_names)
    specs = moe_specs(cfg)
    wg_spec = resolve(specs["we_gate"], p["we_gate"].shape)
    wd_spec = resolve(specs["we_down"], p["we_down"].shape)
    e_axes = wg_spec[0] if len(wg_spec) > 0 else None       # experts
    f_axes = wd_spec[1] if len(wd_spec) > 1 else None       # hidden
    xe_place = placements(P(None, None, e_axes), mesh)
    xl = xe.to(dt).redistribute(mesh, xe_place).to_local()

    def local(name, spec):
        return p[name].redistribute(mesh, placements(spec, mesh)).to_local(
        ).to(dt)

    h = (F.silu(torch.einsum("bnecd,edf->bnecf", xl,
                             local("we_gate", wg_spec)))
         * torch.einsum("bnecd,edf->bnecf", xl, local("we_up", wg_spec)))
    ye = torch.einsum("bnecf,efd->bnecd", h, local("we_down", wd_spec))
    out = list(xe_place)
    for ax in ((f_axes,) if isinstance(f_axes, str) else f_axes or ()):
        out[next(i for i, n in enumerate(names)
                 if ax in n.split("_"))] = Partial()
    y = DTensor.from_local(ye, mesh, out, run_check=False)
    return y.redistribute(mesh, [Replicate() if isinstance(pl, Partial)
                                 else pl for pl in out])


def moe_mlp(cfg: ModelConfig, p, x):
    """x (B, S, d) -> (y (B, S, d), GShard load-balancing aux loss)."""
    y, gates = _moe_y(cfg, p, x)
    e = cfg.n_experts
    me = gates.mean((0, 1, 2))                            # (E,)
    top1 = gates.argmax(-1)[..., None] == torch.arange(e, device=x.device)
    fe = top1.float().mean((0, 1, 2))
    return y, e * (me * fe).sum()


def moe_mlp_y(cfg: ModelConfig, p, x):
    """The residual block's FFN: ``moe_mlp``'s output without the aux
    term, which it does not compute (a recomputed block would otherwise
    rerun the combine einsum to re-save the aux term's operands)."""
    return _moe_y(cfg, p, x)[0]
