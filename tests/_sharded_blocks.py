"""One rank of a real multi-rank run of a partitioned model (the
recurrent and cross-attention families).

Run as ``python tests/_sharded_blocks.py <case json> <rank> <store dir>``
with ``src/`` on the path, once for each rank of the case's mesh; every
rank prints one JSON line: for each phase, the largest absolute
difference between the partitioned run's values and the plain model's on
the same inputs.

The dry-run counts rank 0's step over the fake process group, which moves
no data; here every rank of a small ``(data, model)`` mesh runs the step
over ``gloo`` on the CPU, so each per-rank plan (the pieces' all-to-alls,
the state's gathers, the sequence-parallel rows, the permuted shards)
moves real values.  The case is ``dict(arch, cfg, mesh, batch, seq)``:
``arch`` names a smoke config, ``cfg`` overrides its fields (fp32 compute,
so that only the order of sums differs), ``mesh`` the (data, model) sizes.
As in the dry-run's count, a plain tensor meeting a DTensor (the rotary
tables) is taken as replicated.  The context families get random frames
or patch embeddings (``ctx``, split over the batch) from the same
generator, and a random cache's cross K/V.
Phases: ``forward`` (the logits), ``decode`` (the logits and every cache
leaf after two steps from a random cache) and ``grad`` (every parameter's
gradient of a weighted sum of the logits; the difference relative to the
largest gradient); for xlstm and zamba2 also ``mlstm_update`` /
``mamba_update`` (the first mLSTM or Mamba2 block's update of a random
residual, relative to the plain update's largest value) and
``mlstm_grad`` / ``mamba_grad`` (that block's gradients of a random
weighting of its update, each relative to the plain gradient's largest
value).  A case's
``extras`` run other models on the same process group, each under the
reference's A/B knobs it names.
"""
import dataclasses
import functools
import json
import math
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.registry import get_smoke
from repro_torch.launch.dryrun import knobs_set
from repro_torch.launch.mesh import Mesh, rules_for
from repro_torch.models import mamba2, xlstm
from repro_torch.models import transformer as tt
from repro_torch.models.registry import get_model
from repro_torch.parallel.axes import (is_spec_leaf, placements, resolve,
                                       sharding_rules)
from repro_torch.tree import leaves, map_tree


def spread(spec, tree, dm):
    """Each leaf of ``tree`` as a DTensor placed by its spec, every rank's
    local shard cut from the same whole tensor."""
    if not is_spec_leaf(spec):
        return {k: spread(v, tree[k], dm) for k, v in spec.items()}
    return distribute_tensor(tree, dm,
                             placements(resolve(spec, tree.shape), dm))


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(a, b):
    return float((whole(a).double() - b.double()).abs().max())


def run(case, rank, store_dir):
    """The case's phases, then each of its ``extras`` (``dict(arch, cfg,
    batch, seq, env)``: another model on the same process group and mesh,
    with the reference's A/B knobs ``env`` set around it), the latter's
    differences keyed ``<extra>.<phase>``."""
    shape = tuple(case["mesh"])
    world = math.prod(shape)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{store_dir}/store", world),
        rank=rank, world_size=world)
    torch.manual_seed(0)
    os.environ["REPRO_FP32_PROBS"] = "1"
    mesh = Mesh(("data", "model"), shape)
    dm = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                    mesh_dim_names=("data", "model"))
    dm["data", "model"]._flatten("data_model")
    out = phases(case, mesh, dm)
    for name, extra in case.get("extras", {}).items():
        with knobs_set(extra["env"]):
            out.update({f"{name}.{k}": v for k, v in
                        phases(dict(extra, mesh=shape), mesh, dm).items()})
    dist.destroy_process_group()
    return out


def block_update(fwd, stack, params, dp, dm, gen, rows, mesh, rules):
    """The first block of the stacked leaves ``stack`` (``fwd(layer, x)``:
    an mLSTM or a Mamba2 block), its update of a random residual (its
    output less its input), partitioned against plain, relative to the
    plain update's largest value: at init a block moves the logits too
    little for the forward's absolute difference to show its plan.  The
    residual is laid out as the model lays it out (`transformer.
    residual_spec`: its rows split over ``model`` under
    ``REPRO_SP_RESIDUAL``)."""
    d = params[stack]["norm"].shape[-1]
    x = torch.randn((*rows, d), generator=gen)
    with torch.no_grad():
        want = fwd(tt._layer(params[stack], 0), x) - x
    with sharding_rules(mesh, rules), implicit_replication(), \
            torch.no_grad():
        dx = spread(tt.residual_spec(), x, dm)
        got = fwd(tt._layer(dp[stack], 0), dx) - dx
    return err(got, want) / float(want.abs().max())


def block_grad(fwd, stack, params, specs, dm, gen, rows, mesh, rules):
    """The first block of ``stack`` (as `block_update`): the gradients of
    a random weighting of its update on a random residual, of each of
    its weights and of the residual, partitioned against plain, each
    relative to the plain gradient's largest value; the largest of
    these.  The block's backward plan (its collectives' gradients, each
    rank's rows' and columns' shares) moves the whole model's gradients
    at init too little for the ``grad`` phase to see it."""
    d = params[stack]["norm"].shape[-1]
    x = torch.randn((*rows, d), generator=gen)
    wts = torch.randn((*rows, d), generator=gen)

    def grads(stacked, x_, w_):
        flat = [x_.requires_grad_(True), *leaves(stacked)]
        for t in flat[1:]:
            t.requires_grad_(True)
        ((fwd(tt._layer(stacked, 0), x_) - x_) * w_).sum().backward()
        return [flat[0].grad] + [t.grad[0] for t in flat[1:]]

    want = grads(map_tree(torch.clone, params[stack]), x.clone(), wts)
    with sharding_rules(mesh, rules), implicit_replication():
        spec = tt.residual_spec()
        got = grads(spread(specs[stack], params[stack], dm),
                    spread(spec, x, dm), spread(spec, wts, dm))
    return max(err(g, w) / float(w.abs().max()) for g, w in zip(got, want))


#: the families whose first block's update is held alone: (stacked leaves,
#: block forward)
UPDATES = {"xlstm-1.3b": ("mlstm", xlstm.mlstm_fwd),
           "zamba2-2.7b": ("mamba", mamba2.mamba_fwd)}


def phases(case, mesh, dm):
    """The forward, decode and gradient differences of the case's model
    on the mesh ``mesh`` (its DeviceMesh ``dm``)."""
    cfg = dataclasses.replace(get_smoke(case["arch"]), dtype=torch.float32,
                              **case["cfg"])
    api = get_model(cfg)
    rules = rules_for(mesh)
    gen = torch.Generator().manual_seed(1)
    b, s = case["batch"], case["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    # the context families' frames / patch embeddings
    ctx = (torch.randn((b, cfg.n_ctx_tokens, cfg.d_model), generator=gen)
           if api.needs_ctx else None)
    params = api.init(0, device="cpu")
    out = {}

    def batch(toks, dist_):
        out = dict(tokens=dist_(("batch", None), toks))
        if ctx is not None:
            out["ctx"] = dist_(("batch", None, None), ctx)
        return out

    def plain_(spec, t):
        return t

    def spread_(spec, t):
        return spread(spec, t, dm)

    with torch.no_grad():
        want = api.forward(params, batch(tokens, plain_))
    with sharding_rules(mesh, rules), implicit_replication(), \
            torch.no_grad():
        dp = spread(api.param_specs(), params, dm)
        got = api.forward(dp, batch(tokens, spread_))
    out["forward"] = err(got, want)
    if case["arch"] in UPDATES:
        stack, fwd = UPDATES[case["arch"]]
        out[f"{stack}_update"] = block_update(
            functools.partial(fwd, cfg), stack, params, dp, dm, gen, (b, s),
            mesh, rules)
        out[f"{stack}_grad"] = block_grad(
            functools.partial(fwd, cfg), stack, params, api.param_specs(),
            dm, torch.Generator().manual_seed(2), (b, s), mesh, rules)

    # decode: two steps from a random cache (positive where a leaf must
    # be: the mLSTM's normaliser state is read through an abs; the
    # context families' cross K/V are random too)
    cache = api.init_cache(b, s, device="cpu")
    cache = {k: (v if k == "length" else map_tree(
        lambda t: torch.randn(t.shape, generator=gen).abs() * 0.5, v))
        for k, v in cache.items()}
    step = torch.randint(0, cfg.vocab, (2, b), generator=gen)
    with torch.no_grad():
        plain = {k: (v if k == "length" else map_tree(torch.clone, v))
                 for k, v in cache.items()}
        want_logits = []
        for i in range(2):
            y, plain = api.decode(params, plain, step[i])
            want_logits.append(y)
    with sharding_rules(mesh, rules), implicit_replication(), \
            torch.no_grad():
        dc = spread(api.cache_specs(shard_seq=True), cache, dm)
        e = 0.0
        for i in range(2):
            y, dc = api.decode(dp, dc, spread(("batch",), step[i], dm))
            e = max(e, err(y, want_logits[i]))
        out["decode_logits"] = e
        out["decode_cache"] = max(err(g, w) for g, w in zip(
            leaves(dc), leaves(plain)))

    # grad: every parameter's gradient of sum(logits * weights)
    wts = torch.randn(want.shape, generator=gen)

    def grads(p, b_, weights):
        flat = list(leaves(p))
        for t in flat:
            t.requires_grad_(True)
        y = api.forward(p, b_)
        (y * weights).sum().backward()
        return [t.grad for t in flat]

    plain_params = api.init(0, device="cpu")
    want_g = grads(plain_params, batch(tokens, plain_), wts)
    with sharding_rules(mesh, rules), implicit_replication():
        dp = spread(api.param_specs(), api.init(0, device="cpu"), dm)
        got_g = grads(dp, batch(tokens, spread_),
                      spread(("batch", None, "vocab"), wts, dm))
    out["grad"] = max(err(g, w) for g, w in zip(got_g, want_g)) / max(
        float(w.abs().max()) for w in want_g)
    return out


if __name__ == "__main__":
    print(json.dumps(run(json.loads(sys.argv[1]), int(sys.argv[2]),
                         sys.argv[3])))
