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

The port runs on one card: the reference's weight-stationary expert
schedule for a serving mesh (``_expert_ffn_weight_stationary``) and its
``shard`` annotations have no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig

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
    xg = x.reshape(b, ng, g, d)
    logit = torch.einsum("bngd,de->bnge", xg.float(), p["router"].float())
    gates = torch.softmax(logit, -1)                      # (B,ng,G,E)
    dispatch, combine = route(cfg, gates, capacity(cfg, g))

    # dispatch -> expert FFN -> combine
    dt = cfg.dtype
    xe = torch.einsum("bngec,bngd->bnecd", dispatch, xg)
    h = (F.silu(torch.einsum("bnecd,edf->bnecf", xe, p["we_gate"].to(dt)))
         * torch.einsum("bnecd,edf->bnecf", xe, p["we_up"].to(dt)))
    ye = torch.einsum("bnecf,efd->bnecd", h, p["we_down"].to(dt))
    y = torch.einsum("bngec,bnecd->bngd", combine.to(dt), ye).reshape(b, s, d)
    if cfg.dense_residual:
        y = y + cm.mlp(cfg, p["dense"], x)
    return y, gates


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
