"""The train step: loss, gradient accumulation, optimizer.

The built step is ``(params, opt_state, batch) -> (params, opt_state,
metrics)``, the reference's ``train/step.py`` on one card:

* next-token cross-entropy in fp32 (logZ by max shift; not
  ``F.cross_entropy``), with an optional z-loss,
* gradients by ``torch.autograd`` on the fp32 params (the forward casts
  them to ``cfg.dtype`` as it does for serving, and recomputes each
  block's activations in the backward pass: `models.common.recompute`),
* accumulation over ``accum`` microbatches with the reference's strided
  split (microbatch m holds rows ``i % accum == m``): the gradients
  summed in fp32 and divided tensor by tensor, one microbatch's
  activations alive at a time,
* an optional ``compress_grads`` hook on the accumulated gradients
  (`repro_torch.parallel.compression`), then the AdamW update
  (`repro_torch.train.optimizer`).

The reference's ``shard`` annotations are the identity here, as in the
port's models; `batch_specs` keeps the batch's logical mesh axes as data
(`launch.dryrun` prices the production meshes with them).
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.train import optimizer as opt
from repro_torch.tree import map_tree


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean next-token CE.  logits (B,S,V), fp32 math."""
    lg = logits.to(torch.float32)
    m = lg.amax(-1, keepdim=True)
    z = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]  # logZ
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(z - gold)
    if z_loss > 0.0:
        ce = ce + z_loss * torch.mean(torch.square(z))
    return ce


def build_loss_fn(api: ModelApi, *, z_loss: float = 0.0):
    def loss_fn(params, batch):
        logits = api.forward(params, batch)
        return cross_entropy(logits, batch["labels"], z_loss=z_loss)
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` by autograd: the
    loss detached, the gradient tree congruent with ``params`` (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    flat = []

    def track(p):
        t = p.detach().requires_grad_(True)
        flat.append(t)
        return t

    tracked = map_tree(track, params)
    with torch.enable_grad():
        loss = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    pairs = iter(zip(flat, grads))

    def fill(_):
        t, g = next(pairs)          # map_tree walks params as `track` did
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), map_tree(fill, params)


def build_train_step(api: ModelApi, opt_cfg: opt.AdamWConfig, *,
                     accum: int = 1, z_loss: float = 0.0,
                     compress_grads=None):
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics).

    batch leaves have a leading global-batch dim; with ``accum > 1``
    they are split into ``accum`` strided microbatches run one after
    another.  ``compress_grads`` is an optional fn applied to the
    accumulated gradient tree (e.g. int8 compression with error
    feedback, `repro_torch.parallel.compression`).
    """
    loss_fn = build_loss_fn(api, z_loss=z_loss)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            # Strided split: microbatch m = rows {i : i % accum == m}.
            micro = {k: x.reshape(x.shape[0] // accum, accum, *x.shape[1:])
                     .movedim(1, 0) for k, x in batch.items()}
            gsum, lsum = None, None
            for m in range(accum):
                l, g = value_and_grad(loss_fn, params,
                                      {k: x[m] for k, x in micro.items()})
                gsum = g if gsum is None else map_tree(torch.add, gsum, g)
                lsum = l if lsum is None else lsum + l
            n = torch.tensor(accum, dtype=torch.float32, device=lsum.device)
            grads = map_tree(lambda s: s / n, gsum)
            loss = lsum / n

        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, metrics = opt.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def batch_specs(api: ModelApi):
    """Logical specs for the training batch dict."""
    spec = dict(tokens=("batch", None), labels=("batch", None))
    if api.needs_ctx:
        spec["ctx"] = ("batch", None, None)
    return spec
