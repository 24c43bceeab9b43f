"""AdamW written out by hand, as the reference's ``train/optimizer.py``.

Production knobs:

* ``state_dtype`` — Adam moments can be held in bf16 for the giant MoE
  archs (arctic-480b / grok-1-314b), where fp32 m+v would not fit;
* global-norm gradient clipping (the norm reported before clipping),
* decoupled weight decay on matrices only (``ndim >= 2``), added to the
  step after the moments,
* linear warmup + cosine decay schedule.

``torch.optim.AdamW`` is another function: it adds eps elsewhere,
decays every leaf, and decays before the moments.  Here every scalar is
an fp32 tensor on the params' device, as JAX's weak typing keeps them,
and every division is tensor by tensor (on the card ``tensor / float``
multiplies by the reciprocal).  The global norm sums the leaves in
sorted-key order, the order ``jax.tree_util`` flattens a dict in.

Optimizer state is a tree congruent with the params:
``dict(m=..., v=..., step=int32 0-d tensor)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, map_tree, unzip


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: torch.dtype = torch.float32


def _f32(x, like):
    """``x`` as an fp32 0-d tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (a 0-d tensor): linear warmup, then a
    cosine decay to ``min_lr_frac``; fp32 throughout."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(cfg: AdamWConfig, params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    dev = next(leaves(params)).device
    return dict(m=map_tree(zeros, params), v=map_tree(zeros, params),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def state_specs(param_specs_tree):
    """Logical axis names of the state: the moments shard exactly like
    the params (ZeRO), the step is a scalar."""
    return dict(m=param_specs_tree, v=param_specs_tree, step=())


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32, the leaves
    added in sorted-key order."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, *,
                  in_place: bool = False):
    """One AdamW step.  Returns (new_params, new_state, metrics).

    ``in_place``: each leaf's new param and moments are written into its
    old tensors, leaf by leaf (the returned trees hold the same tensors):
    the reference's donation of params and optimizer state, one leaf's
    temporaries alive at a time.  On DTensors every leaf is updated on
    its local shard, with no redistribute; the norm's sum of squares is
    the only collective.
    """
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - _f32(cfg.b1, stepf) ** stepf
    bc2 = 1 - _f32(cfg.b2, stepf) ** stepf
    b1, b2 = cfg.b1, cfg.b2

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:     # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if in_place:
            return p.copy_(new_p), m.copy_(m32), v.copy_(v32)
        return new_p, m32.to(cfg.state_dtype), v32.to(cfg.state_dtype)

    new_p, new_m, new_v = unzip(
        map_tree(upd, params, grads, state["m"], state["v"]), 3)
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_p, dict(m=new_m, v=new_v, step=step), metrics
