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

On DTensors (`launch.dryrun.partitioned_cell`) the same step is rank
0's program on a production mesh; `batch_specs` gives the batch's
logical mesh axes.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.models.registry import ModelApi
from repro_torch.parallel.axes import is_dtensor, reduce_partial, shard
from repro_torch.train import optimizer as opt
from repro_torch.tree import map_tree


def _label_logits(lg, labels):
    """``lg[..., labels]``: each position's logit of its label.

    On a DTensor whose vocab dim is split, each rank reads the labels
    that fall in its slice of the vocab (0 for the others) and the
    partial sums are all-reduced: the vocab-parallel cross-entropy.
    (DTensor's own masked gather fails on this shape.)"""
    if not is_dtensor(lg):
        return torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    mesh, pl = lg.device_mesh, list(lg.placements)
    split = [isinstance(p, Shard) and p.dim % lg.ndim == lg.ndim - 1
             for p in pl]
    if not any(split):
        return torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    lab = labels.redistribute(mesh, [
        Replicate() if v else p for v, p in zip(split, pl)]).to_local()
    _, offset = compute_local_shape_and_global_offset(lg.shape, mesh, pl)
    local = lg.to_local()
    idx = lab.long() - offset[-1]
    inside = (idx >= 0) & (idx < local.shape[-1])
    gold = torch.gather(local, -1, idx.clamp(0, local.shape[-1] - 1)[
        ..., None])[..., 0]
    gold = torch.where(inside, gold, 0.0)
    return reduce_partial(DTensor.from_local(
        gold, mesh, [Partial() if v else p for v, p in zip(split, pl)],
        run_check=False))


class _WholeVocabCE(torch.autograd.Function):
    """Each position's ``logZ - lg[label]`` of the fp32 logits ``lg``
    (..., V), computed as `cross_entropy` computes it, whose backward
    writes ``(softmax(lg) - onehot(label)) * g`` into one buffer, where
    autograd would add the label gather's gradient to the softmax's,
    out of place under a dispatch mode (the dry-run's count) and in
    place without one: the count then over-states the step's peak by a
    logits-sized buffer."""

    @staticmethod
    def forward(ctx, lg, labels):
        m = lg.amax(-1, keepdim=True)
        z = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
        ctx.save_for_backward(lg, labels, z)
        return z - torch.gather(lg, -1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        lg, labels, z = ctx.saved_tensors
        d = torch.exp(lg - z[..., None])
        d.scatter_add_(-1, labels[..., None],
                       torch.full_like(labels[..., None], -1.0,
                                       dtype=d.dtype))
        return d.mul_(g[..., None]), None


def _ce_by_rank(logits, labels):
    """Each position's CE of DTensor logits whose vocab is whole (every
    rank holds whole rows: whisper's), on each rank's own positions
    (`_WholeVocabCE`)."""
    lg = logits.to(torch.float32)
    mesh, pl = lg.device_mesh, list(lg.placements)
    lab = labels.redistribute(mesh, pl).to_local().long()
    return DTensor.from_local(_WholeVocabCE.apply(lg.to_local(), lab), mesh,
                              pl, run_check=False)


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean next-token CE.  logits (B,S,V), fp32 math.  On DTensors the
    max and the sum over a split vocab are all-reduced where they arise
    (`reduce_partial`), as the reference's partitioner does; DTensor
    would scatter them over the sequence and move the logits' gradient
    back and forth.  There the shift ``m`` is taken off the autograd
    graph (DTensor cannot differentiate the all-reduce of a max); the
    gradient through it is zero in exact arithmetic.  A vocab whole on
    every rank runs per rank (`_ce_by_rank`)."""
    if (z_loss == 0.0 and is_dtensor(logits) and not any(
            isinstance(p, Shard) and p.dim % logits.ndim == logits.ndim - 1
            for p in logits.placements)):
        return torch.mean(_ce_by_rank(logits, labels))
    lg = logits.to(torch.float32)
    m = (reduce_partial(lg.detach().amax(-1, keepdim=True))
         if is_dtensor(lg) else lg.amax(-1, keepdim=True))
    z = (torch.log(reduce_partial(torch.sum(torch.exp(lg - m), dim=-1)))
         + m[..., 0])                                     # logZ
    gold = _label_logits(lg, labels)
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
    for a leaf the loss does not reach, as ``jax.grad`` gives).  On
    DTensors each gradient is laid out as its param (the reference's
    step has the params' shardings as its outputs'): a replicated leaf's
    partial sums are all-reduced here, and the update needs no
    collective."""
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
        if g is None:
            return torch.zeros_like(t)
        if is_dtensor(g) and g.placements != t.placements:
            return g.redistribute(t.device_mesh, t.placements)
        return g

    return loss.detach(), map_tree(fill, params)


def _strided(x, names, accum: int):
    """``x``'s ``accum`` strided microbatches, stacked: ``[m]`` holds the
    rows ``i % accum == m``.  A DTensor ``x`` (logical ``names``) is
    first placed by `shard` as one microbatch's shape resolves
    (`resolve`'s divisibility fallback, as the reference's ``shard``
    calls place the microbatch's activations): where the microbatch's
    rows do not divide the batch's mesh axes, the rows are gathered over
    the axes they cannot split."""
    x = shard(x, *names, shape=(x.shape[0] // accum, *x.shape[1:]))
    return x.reshape(x.shape[0] // accum, accum, *x.shape[1:]).movedim(1, 0)


def build_train_step(api: ModelApi, opt_cfg: opt.AdamWConfig, *,
                     accum: int = 1, z_loss: float = 0.0,
                     compress_grads=None, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics).

    batch leaves have a leading global-batch dim; with ``accum > 1``
    they are split into ``accum`` strided microbatches run one after
    another.  ``compress_grads`` is an optional fn applied to the
    accumulated gradient tree (e.g. int8 compression with error
    feedback, `repro_torch.parallel.compression`).  ``donate``: the
    update writes into the given params and optimizer state
    (`optimizer.apply_updates`' ``in_place``), as the reference's jitted
    step donates them.

    The step runs on DTensors as it does on tensors: the strided split's
    reshape keeps a batch sharded on dim 0 sharded on the outer factor,
    so each rank's microbatch rows are its own rows, with no collective
    where a microbatch's rows divide the batch's mesh axes (`_strided`).
    """
    loss_fn = build_loss_fn(api, z_loss=z_loss)
    names = batch_specs(api)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            # Strided split: microbatch m = rows {i : i % accum == m}.
            micro = {k: _strided(x, names[k], accum)
                     for k, x in batch.items()}
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
            opt_cfg, params, grads, opt_state, in_place=donate)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def batch_specs(api: ModelApi):
    """Logical specs for the training batch dict."""
    spec = dict(tokens=("batch", None), labels=("batch", None))
    if api.needs_ctx:
        spec["ctx"] = ("batch", None, None)
    return spec
