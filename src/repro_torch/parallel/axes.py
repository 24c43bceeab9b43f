"""Logical-axis rules: logical axis names -> mesh axes, as pure logic.

The reference's ``parallel/axes.py`` without JAX.  Models name each
array dim with a *logical* axis; a launcher installs rules that map the
names onto the axes of a mesh (`launch.mesh`).  The same names resolve
on a 1x1 host mesh, the 16x16 ``pod`` or the (2, 16, 16) ``multipod``:
scaling the pod count is a change of rules, not of code.

Logical axes used across the framework:

* ``batch``    — data-parallel batch dim -> ('pod', 'data')
* ``fsdp``     — parameter / optimizer-state sharding (ZeRO-3) -> 'data'
  (+ 'pod' on the multi-pod mesh)
* ``embed``    — the d_model dim of a weight: 'fsdp' under training
  rules, kept 'data'-sharded (weights resident) under serving rules
* ``heads``    — attention-head tensor parallelism -> 'model'
* ``kv_heads`` — GQA KV heads -> 'model' *only if divisible*
* ``mlp``      — FFN hidden dim -> 'model'
* ``vocab``    — embedding / logits vocab dim -> 'model'
* ``experts``  — MoE expert dim -> 'model' if divisible (EP), else the
  per-expert ``mlp`` dim carries the TP (grok-style 8e on 16-way TP)
* ``seq`` / ``kv_seq`` — sequence-parallel activations / sharded KV cache
* ``state``    — SSM value-dim tensor parallelism (xLSTM / Mamba2)

`resolve` keeps every rule of the reference: a mesh axis whose size does
not divide the dim is dropped (replication instead of uneven sharding),
a mesh axis already taken by an earlier dim is not given again (the
first dim wins), trailing ``None`` entries are trimmed, and with no rules
installed every spec is ``P()``.  `resolve_tree` maps a spec tree to a
tree of `P` (the reference's ``spec_tree_to_shardings`` without the
``NamedSharding``).

The SPMD side runs on DTensor: `placements` turns a `P` into DTensor
placements over a torch ``DeviceMesh`` (`launch.mesh.device_mesh`),
`distribute_tree` makes each leaf of a tree a DTensor from its local
shard, and `shard` (the reference's ``with_sharding_constraint`` by
logical names) redistributes a DTensor to the resolved spec.  Without
rules, or on a plain tensor, `shard` is the identity, as the reference's
is without a mesh.  The reference's ``named_sharding`` and
``spec_tree_to_shardings`` have no counterpart: a DTensor carries its
placements itself.

The models state their per-rank plans with `einsum` (its
``whole_forward`` / ``whole_grad`` for the backward products the
reference's partitioner runs otherwise than the forward),
`transpose_shard` (its collective-permute of a shard between the pod's
two axes, as one all-to-all), `gather_share` (a recurrence's state
gathered every step), `contract` (a product over one element as the
multiply the reference's compiler makes of it) and `along`.  All six
families are partitioned so (`launch.dryrun.PARTITIONED_FAMILIES`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per array dim, each ``None``, a mesh
    axis name, or a tuple of names (the dim split over several axes).
    ``tuple(P(...))`` equals ``tuple`` of the reference's ``P(...)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _rules() -> Mapping[str, tuple[str, ...]]:
    return getattr(_state, "rules", {})


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Mapping[str, Sequence[str]]):
    """Install logical->mesh axis rules (and the mesh whose axis sizes
    `resolve` divides by) for the enclosed scope, on this thread."""
    prev = (_mesh(), _rules())
    _state.mesh = mesh
    _state.rules = {k: tuple(v) if not isinstance(v, str) else (v,)
                    for k, v in rules.items()}
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


# ---------------------------------------------------------------------------
# rules presets


def single_pod_rules() -> dict:
    # kv_seq lists both axes: under the first-dim-wins dedup in
    # resolve(), a batch-sharded decode cache gets seq over 'model'
    # (flash-decoding split-KV), while the batch=1 long-context cell
    # gets seq over BOTH axes (256-way KV sharding).
    return dict(batch=("data",), fsdp=("data",), embed=("data",),
                heads=("model",), kv_heads=("model",), mlp=("model",),
                vocab=("model",), experts=("model",), seq=("model",),
                state=("model",), kv_seq=("data", "model"))


def multi_pod_rules() -> dict:
    r = single_pod_rules()
    r["batch"] = ("pod", "data")
    r["fsdp"] = ("pod", "data")
    r["embed"] = ("pod", "data")
    r["kv_seq"] = ("pod", "data", "model")
    return r


def serve_rules(multi_pod: bool = False) -> dict:
    """Weight-stationary serving layout.

    Training shards parameters over 'data' (ZeRO/FSDP) and gathers them
    again per layer, which a big batch amortises; at decode that moves
    the whole model across the mesh every step.  For serving the weights
    are sharded over both mesh axes and never gathered: 'fsdp' maps to
    nothing and the FFN / expert hidden dim takes the 'data' axis too.
    The ``__serving__`` key marks the preset (`serving_mode`).
    """
    r = single_pod_rules()
    r["fsdp"] = ()
    r["embed"] = ("data",)     # weights stay resident, 256-way with TP
    r["mlp"] = ("data", "model")
    r["state"] = ("data", "model")
    r["__serving__"] = ()          # mode marker, see serving_mode()
    if multi_pod:
        r["batch"] = ("pod", "data")
        r["kv_seq"] = ("pod", "data", "model")
        r["mlp"] = ("pod", "data", "model")
    return r


def serving_mode() -> bool:
    """True when the installed rules are the serving preset."""
    return "__serving__" in _rules()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh: a `launch.mesh.Mesh` or a torch
    ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, mesh.shape))


def resolve(names: Sequence[str | None],
            shape: Sequence[int] | None = None) -> P:
    """Logical axis names -> `P` under the installed rules.

    With ``shape`` given, any mesh axis whose size does not divide the
    corresponding dim (what is left of it after the axes before) is
    dropped (replication fallback).
    """
    rules, mesh = _rules(), _mesh()
    if not rules:
        return P()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    out, used = [], set()
    for i, name in enumerate(names):
        if name is None:
            out.append(None)
            continue
        axes = tuple(ax for ax in rules.get(name, ()) if ax not in used)
        if shape is not None and sizes:
            keep, dim = [], shape[i]
            for ax in axes:
                sz = sizes.get(ax, 1)
                if sz > 1 and dim % sz == 0:
                    keep.append(ax)
                    dim //= sz
            axes = tuple(keep)
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def is_spec_leaf(x) -> bool:
    """A spec tree's leaf: a tuple of logical names (or ``None``), one
    per array dim (``()`` for a scalar)."""
    return isinstance(x, tuple) and all(
        isinstance(n, (str, type(None))) for n in x)


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def resolve_tree(spec_tree, shape_tree):
    """A tree of `P`, one per leaf of ``spec_tree`` (dicts whose leaves
    are tuples of logical names), each resolved against the matching
    leaf of ``shape_tree`` (tensors, meta tensors included, or shapes)
    under the installed rules."""
    if is_spec_leaf(spec_tree):
        return resolve(spec_tree, _shape(shape_tree))
    return {k: resolve_tree(v, shape_tree[k]) for k, v in spec_tree.items()}


def local_shape(spec: P, shape: Sequence[int], mesh) -> tuple:
    """One device's shape of an array of ``shape`` split by ``spec`` over
    ``mesh``: each dim divided by the sizes of the axes of its entry."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            out[i] //= sizes[ax]
    return tuple(out)


# ---------------------------------------------------------------------------
# DTensor


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` over the torch ``DeviceMesh``
    ``mesh``, one per mesh dim: ``Shard(i)`` on each mesh dim that
    splits array dim ``i``, ``Replicate()`` on the others.  A dim of the
    ``DeviceMesh`` may stand for a run of mesh axes, named by them joined
    with ``"_"`` (`launch.mesh.device_mesh`): an entry of ``spec`` must
    then name whole runs.

    A dim split over several mesh dims (``batch`` over ``("pod",
    "data")``, ``kv_seq`` over ``("data", "model")``) is split major to
    minor in the order the spec lists them, which DTensor does in mesh
    order: a spec that lists them otherwise raises.
    """
    names = list(mesh.mesh_dim_names)
    runs = [n.split("_") for n in names]
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes, dims = list(_axes(entry)), []
        while axes:
            run = next((d for d, r in enumerate(runs)
                        if r == axes[:len(r)]), None)
            if run is None or (dims and run < dims[-1]):
                raise ValueError(
                    f"{spec}: the axes {entry} of dim {i} are not whole runs "
                    f"of the mesh's dims {tuple(names)} in their order")
            dims.append(run)
            axes = axes[len(runs[run]):]
        for m in dims:
            out[m] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def distribute_tree(spec_tree, tree, mesh, device=None):
    """Each leaf of ``tree`` (tensors, meta tensors included) as a
    DTensor over the ``DeviceMesh`` ``mesh``, placed by its spec in
    ``spec_tree`` resolved under the installed rules and mesh.

    A leaf that the spec leaves whole (every placement ``Replicate``, as
    on the 1x1 host mesh) and that has storage is wrapped as it is: the
    DTensor holds its values.  Any other leaf gets a zero local shard of
    `local_shape` on ``device`` (default: the mesh's device type;
    ``"meta"``: shapes without storage).
    """
    if not is_spec_leaf(spec_tree):
        return {k: distribute_tree(v, tree[k], mesh, device)
                for k, v in spec_tree.items()}
    spec = resolve(spec_tree, tree.shape)
    shape = local_shape(spec, tree.shape, _mesh()) if spec else \
        tuple(tree.shape)
    if shape == tuple(tree.shape) and not tree.is_meta:
        local = tree
    else:
        local = torch.zeros(shape, dtype=tree.dtype,
                            device=device or mesh.device_type)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


#: the logical names of a weight's ZeRO-3 dims
FSDP_NAMES = ("fsdp", "embed")


def gather_fsdp(w, names: Sequence[str | None], *,
                gather_in_serving: bool = False):
    """ZeRO-3's gather: the DTensor weight ``w`` (logical ``names``)
    redistributed so that its ``fsdp`` / ``embed`` dims are whole, its
    other dims split as the rules say.  The reference's partitioner
    gathers an FSDP weight before each product that uses it; DTensor,
    left to choose per op, may move the activations instead.  Its
    backward brings the gradient back onto the shards.  The identity
    on a plain tensor, with no rules, and under the serving rules, whose
    weights stay resident (`models.common.serving_matmul`), unless
    ``gather_in_serving`` asks for the gather there too."""
    if not is_dtensor(w) or not _rules() or (serving_mode()
                                             and not gather_in_serving):
        return w
    spec = resolve(tuple(None if n in FSDP_NAMES else n for n in names),
                   w.shape)
    want = placements(spec, w.device_mesh)
    if list(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def reduce_partial(x):
    """``x`` with every pending partial sum (a ``Partial`` placement)
    all-reduced, its other placements kept: the reference's partitioner
    reduces a product's partial sums where they arise, where DTensor
    would carry them on and gather the next weight whole to multiply
    them.  The identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    want = [Replicate() if isinstance(p, Partial) else p
            for p in x.placements]
    if getattr(x, "no_batch_product", False):
        with product_scope(None):
            return x.redistribute(x.device_mesh, want)
    return x.redistribute(x.device_mesh, want)


def batch_labels(eq: str) -> set:
    """The batch dims of the product ``eq`` (``"ab,bc->ac"``): the labels
    both operands and the output share, as ``dot_general`` names them."""
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    return set(la) & set(lb) & set(out)


@contextlib.contextmanager
def product_scope(eq: str | None):
    """Marks the product ``eq`` computed in the enclosed scope, for the
    recompute policy ``dots`` (`models.common.recompute`): a product with
    no batch dims (`batch_labels`) is one whose output that policy saves,
    as ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``
    saves a ``dot_general`` without batch dims.  ``None``: the reduction
    of such a product's partial sums (`reduce_partial`), which is part of
    the reference's product."""
    prev = getattr(_state, "no_batch_product", False)
    _state.no_batch_product = eq is None or not batch_labels(eq)
    try:
        yield
    finally:
        _state.no_batch_product = prev


def in_no_batch_product() -> bool:
    """Whether the running code computes a product marked by
    `product_scope` as one with no batch dims."""
    return getattr(_state, "no_batch_product", False)


def einsum(eq: str, a, b, product=None, *, whole_forward: str | None = None,
           whole_grad: str | None = None, share_grad: str | None = None,
           gathered_grad: bool = False):
    """``torch.einsum(eq, a, b)`` (or ``product(eq, a, b)``), on DTensors
    computed per rank with the placements stated, not chosen by DTensor:
    over each mesh dim, the label one operand splits is split in the
    other operand too where it has it (a local slice), the output is
    split on it where it keeps it, else the output is a ``Partial`` sum;
    an operand without the label gets a ``Partial`` gradient there.  Two
    operands splitting different labels over one mesh dim raise.  The
    same products run whichever torch version plans them, and no
    DTensor view of a split dim is needed.  On plain tensors the plain
    product.

    Two options name a mesh dim over which one operand splits a label
    and the other is whole, for the products the reference's partitioner
    runs otherwise (`_SplitProduct`): ``whole_forward`` gathers the split
    operand and runs the forward whole on every rank (the output whole),
    its backward on the rank's share (the split operand's gradient its
    share's; the other's a partial sum of the share's products, or whole
    where it keeps the label); ``whole_grad`` runs the forward on the
    share, as without it, and the whole operand's gradient whole on
    every rank (the split one gathered for it).  With ``whole_forward``,
    ``gathered_grad`` computes the whole operand's gradient from the
    gathered one, whole on every rank.  ``share_grad`` names a
    mesh dim over which both operands are whole: the forward and ``a``'s
    gradient run whole on every rank, and ``b``'s (the weight's) on the
    rank's share of its first dim the dim's ranks divide (`_ShareGrad`:
    zero elsewhere, a partial sum)."""
    product = product or torch.einsum
    with product_scope(eq):
        return _einsum(eq, a, b, product, whole_forward, whole_grad,
                       share_grad, gathered_grad)


def _einsum(eq, a, b, product, whole_forward, whole_grad, share_grad,
            gathered_grad):
    if not is_dtensor(a):
        return product(eq, a, b)
    mesh = a.device_mesh
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    mode = "whole_forward" if whole_forward else "whole_grad"
    name = whole_forward or whole_grad
    whole = None if name is None else mesh.mesh_dim_names.index(name)
    share = None

    def label(x, labels, p):
        if isinstance(p, Partial):
            raise ValueError(f"{eq}: an operand holds partial sums")
        return labels[p.dim % x.ndim] if isinstance(p, Shard) else None

    pa, pb, ga, gb, po = [], [], [], [], []
    for m, (xa, xb) in enumerate(zip(a.placements, b.placements)):
        sa, sb = label(a, la, xa), label(b, lb, xb)
        if sa and sb and sa != sb:
            raise ValueError(f"{eq}: mesh dim {m} splits {sa} and {sb}")
        lab = sa or sb
        if lab is None:
            pa.append(xa), pb.append(xb), ga.append(xa), gb.append(xb)
            po.append(Replicate())
            continue
        if m == whole:
            if sa and sb:
                raise ValueError(f"{eq}: both operands split {lab} over "
                                 f"{name}")
            for labels, x, pl, gl in ((la, xa, pa, ga), (lb, xb, pb, gb)):
                pl.append(x)
                gl.append(x if isinstance(x, Shard) or lab in labels
                          or mode == "whole_grad" or gathered_grad
                          else Partial())
            if mode == "whole_forward":
                po.append(Replicate())
            else:
                po.append(Shard(out.index(lab)) if lab in out else Partial())
            share = (lab, bool(sa))
            continue
        for labels, pl, gl in ((la, pa, ga), (lb, pb, gb)):
            if lab in labels:
                pl.append(Shard(labels.index(lab)))
                gl.append(pl[-1])
            else:
                pl.append(Replicate())
                gl.append(Partial())
        po.append(Shard(out.index(lab)) if lab in out else Partial())
    if share_grad is not None:
        gb[mesh.mesh_dim_names.index(share_grad)] = Partial()
    al = a.redistribute(mesh, pa).to_local(grad_placements=ga)
    bl = b.redistribute(mesh, pb).to_local(grad_placements=gb)
    if share_grad is not None:
        y = _ShareGrad.apply(eq, al, bl, mesh,
                             mesh.mesh_dim_names.index(share_grad), product)
    elif share is None:
        y = product(eq, al, bl)
    else:
        lab, in_a = share
        y = _SplitProduct.apply(eq, al, bl, lab, in_a, mesh, whole, product,
                                mode, gathered_grad)
    out = DTensor.from_local(y, mesh, po, run_check=False)
    # its partial sums' reduction belongs to the product (`reduce_partial`)
    out.no_batch_product = not batch_labels(eq)
    return out


def _wait(t):
    return t.wait() if hasattr(t, "wait") else t


def _all_gather(x, dim: int, group):
    """``x`` all-gathered along ``dim`` over the process group ``group``
    (the functional collective DTensor issues)."""
    ops = torch.ops._c10d_functional
    out = ops.wait_tensor(ops.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), group.size(), group.group_name))
    return out.movedim(0, dim)


def _product(eq: str, a, b):
    """``torch.einsum(eq, a, b)``, or, where it contracts labels whose
    sizes multiply to one (a rank's share of one element), the broadcast
    multiply the reference's compiler rewrites such a dot into (it is
    then no product)."""
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    sizes = dict(zip(la, a.shape))
    sizes.update(zip(lb, b.shape))
    summed = [c for c in sorted(set(la + lb)) if c not in out]
    if not summed or any(sizes[c] != 1 for c in summed):
        return torch.einsum(eq, a, b)
    labels = "".join(dict.fromkeys(la + lb))

    def expand(x, lx):
        perm = [lx.index(c) for c in labels if c in lx]
        x = x.permute(perm)
        for i, c in enumerate(labels):
            if c not in lx:
                x = x.unsqueeze(i)
        return x

    y = expand(a, la) * expand(b, lb)
    y = y.sum([labels.index(c) for c in summed])
    kept = [c for c in labels if c not in summed]
    return y.permute([kept.index(c) for c in out])


class _Contract(torch.autograd.Function):
    """``einsum(eq, a, b)`` whose forward and backward products each
    follow `_product`: one over a single element is a multiply."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return _product(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        la, lb = ins.split(",")
        return (None, _product(f"{out},{lb}->{la}", g, b),
                _product(f"{la},{out}->{lb}", a, g))


def contract(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` on local tensors, each of its products
    (forward and backward) a broadcast multiply where it contracts a
    single element, as the reference's compiler writes it (`_product`):
    a rank's share of one element, or a batch share of one row."""
    return _Contract.apply(eq, a, b)


class _Regather(torch.autograd.Function):
    """The all-to-all of `regather`: ``x`` (..., c, ...) a rank's block of
    its dim ``dim`` split over a group of ``n`` ranks in equal blocks;
    each rank sends every other rank the columns of its block that one
    needs (in the needed ranges' order) and receives its own.  The
    backward sends the gradients back and sums those of a column several
    ranks read.  ``owned(r)``: the columns rank ``r``'s block holds, in
    its order (default the ``r``-th of equal contiguous blocks); a rank
    receives its columns from the ranks in rank order, each's in the
    needed order."""

    @staticmethod
    def forward(ctx, x, rank, n, ranges, group, dim=-1, owned=None):
        c = x.shape[dim]
        owned = owned or (lambda q: range(q * c, (q + 1) * c))
        pos = {col: i for i, col in enumerate(owned(rank))}
        send = [[pos[i] for a, b in ranges(r) for i in range(a, b)
                 if i in pos] for r in range(n)]
        need = [i for a, b in ranges(rank) for i in range(a, b)]
        recv = [len(set(owned(q)).intersection(need)) for q in range(n)]
        idx = torch.tensor([i for s in send for i in s], dtype=torch.long,
                           device=x.device)
        ctx.save_for_backward(idx)
        ctx.sizes, ctx.c, ctx.group, ctx.dim = \
            ([len(s) for s in send], recv), c, group, dim
        xt = x.movedim(dim, 0).index_select(0, idx)
        return all_to_all(xt, recv, ctx.sizes[0], group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        send, recv = ctx.sizes
        back = all_to_all(g.movedim(ctx.dim, 0), send, recv, ctx.group)
        out = back.new_zeros((ctx.c, *back.shape[1:])).index_add_(0, idx,
                                                                   back)
        return out.movedim(0, ctx.dim), None, None, None, None, None, None


def all_to_all(x, out_sizes, in_sizes, group):
    """``x`` split along dim 0 into ``in_sizes`` chunks, one for each rank
    of the process group ``group``, each rank receiving its chunks
    (``out_sizes`` of them from each rank; ``None``: equal chunks),
    concatenated along dim 0 in rank order: one all-to-all."""
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_to_all_single(
        x.contiguous(), None if out_sizes is None else list(out_sizes),
        None if in_sizes is None else list(in_sizes), group))


def regather(x, mesh_dim: str, ranges, dim: int = -1,
             grad_placements=None):
    """The DTensor ``x``, its dim ``dim`` (the last by default) split over
    the mesh dim ``mesh_dim`` in equal blocks, as this rank's local tensor
    of the columns it needs, ``ranges(r)``: rank ``r``'s needed ``(start,
    stop)`` ranges of that dim, in the order wanted.  One all-to-all
    moves each rank exactly the columns it lacks (and its own), where a
    gather would move it all: the reference's partitioner moves a
    split dim's windows so when it is cut into pieces its blocks do not
    line up with.  ``grad_placements``: those of the local tensor's
    gradient (default ``x``'s own; a weight read by each rank's rows
    takes a partial sum over the batch's mesh dims)."""
    local = x.to_local(grad_placements=grad_placements or x.placements)
    return regather_local(local, x.device_mesh, mesh_dim, ranges, dim)


def regather_local(x, mesh, mesh_dim: str, ranges, dim: int = -1,
                   owned=None):
    """`regather` of the local tensor ``x``, whose dim ``dim`` holds the
    columns ``owned(r)`` on rank ``r`` of the mesh dim ``mesh_dim``
    (default equal contiguous blocks): one all-to-all."""
    m = mesh.mesh_dim_names.index(mesh_dim)
    return _Regather.apply(x, mesh.get_local_rank(m), mesh.size(m), ranges,
                           mesh.get_group(m), dim, owned)


class _RowsToCols(torch.autograd.Function):
    """The all-to-all of `rows_to_cols`: ``x`` (..., c) holds this rank's
    block of its dim ``rows`` (split over a group of ``n`` ranks in equal
    blocks) and every column; each rank sends every other rank its rows
    of the columns that one needs (``ranges(q)``, as many a rank) and
    receives every rank's rows of its own, in rank order.  The backward
    sends each rank's rows' gradients back to it and puts them in their
    columns (zero in the columns no rank reads)."""

    @staticmethod
    def forward(ctx, x, rows, rank, n, ranges, group):
        cols = [i for q in range(n) for a, b in ranges(q)
                for i in range(a, b)]
        w = even_share(len(cols), n, "the columns the ranks need")
        idx = torch.tensor(cols, dtype=torch.long, device=x.device)
        ctx.save_for_backward(idx)
        ctx.rows, ctx.c, ctx.group = rows, x.shape[-1], group
        xt = x.index_select(-1, idx).unflatten(-1, (n, w)).movedim(-2, 0)
        got = all_to_all(xt, None, None, group)   # (rank, ..., rows, ..., w)
        return got.movedim(0, rows).flatten(rows, rows + 1)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        n, rows = ctx.group.size(), ctx.rows
        gt = g.unflatten(rows, (n, -1)).movedim(rows, 0)
        back = all_to_all(gt, None, None, ctx.group)  # (rank, ..., w)
        back = back.movedim(0, -2).flatten(-2, -1)
        out = back.new_zeros((*back.shape[:-1], ctx.c)).index_add_(
            -1, idx, back)
        return out, None, None, None, None, None


def rows_to_cols(x, mesh, mesh_dim: str, ranges, rows: int = 1):
    """The local tensor ``x``, this rank's block of its dim ``rows`` (split
    over the mesh dim ``mesh_dim`` in equal blocks) with every column of
    its last dim, as every row of the columns this rank needs,
    ``ranges(r)``: rank ``r``'s ``(start, stop)`` ranges of the last dim,
    in the order wanted, as many columns a rank (`_RowsToCols`: one
    all-to-all, each rank sent exactly its columns of the others' rows,
    and the gradients back by one more).  A product on each rank's rows
    whose output the next ops read on each rank's columns (zamba2's
    in-projection under ``REPRO_SP_RESIDUAL``)."""
    m = mesh.mesh_dim_names.index(mesh_dim)
    return _RowsToCols.apply(x, rows, mesh.get_local_rank(m), mesh.size(m),
                             ranges, mesh.get_group(m))


class _GatherShare(torch.autograd.Function):
    """A local share all-gathered along ``dim`` over a mesh dim; in the
    backward each rank's gradient of the whole (a partial sum: every
    rank reads all of it) is reduce-scattered back onto the shares."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        ops = torch.ops._c10d_functional
        out = ops.wait_tensor(ops.reduce_scatter_tensor(
            g.movedim(ctx.dim, 0).contiguous(), "sum", ctx.group.size(),
            ctx.group.group_name))
        return out.movedim(0, ctx.dim), None, None


def gather_share(x, dim: int, mesh, mesh_dim: str):
    """The local tensor ``x``, this rank's share of a dim split over the
    mesh dim ``mesh_dim``, all-gathered along ``dim`` (`_GatherShare`:
    a recurrence's state, gathered every step)."""
    group = mesh.get_group(mesh.mesh_dim_names.index(mesh_dim))
    return _GatherShare.apply(x, dim, group)


class _SwapShare(torch.autograd.Function):
    """A local share split along ``src`` over a group, all-gathered there
    and cut to this rank's share of ``dst``; in the backward the share's
    gradient goes back to the split along ``src`` by one all-to-all (each
    rank's gradient covers its share of ``dst`` alone)."""

    @staticmethod
    def forward(ctx, x, src, dst, rank, group):
        n = group.size()
        full = _all_gather(x, src, group)
        w = even_share(full.shape[dst], n, "the swapped dim")
        ctx.src, ctx.dst, ctx.group = src, dst, group
        return full.narrow(dst, rank * w, w)

    @staticmethod
    def backward(ctx, g):
        n, src, dst = ctx.group.size(), ctx.src, ctx.dst
        got = all_to_all(g.movedim(src, 0), None, None, ctx.group)
        got = got.reshape(n, -1, *got.shape[1:])     # (rank, src share, ...)
        pos = dst + 1 if dst < src else dst          # dst, the ranks out
        got = got.movedim(0, pos).flatten(pos, pos + 1)
        return got.movedim(0, src), None, None, None, None


def swap_share(x, src: int, dst: int, mesh, mesh_dim: str):
    """The local tensor ``x``, this rank's share of dim ``src`` split over
    the mesh dim ``mesh_dim``, as this rank's share of dim ``dst`` with
    ``src`` whole (`_SwapShare`): all-gathered along ``src`` in the
    forward, its gradient moved back by an all-to-all, as the
    reference's partitioner moves the mLSTM's chunk output from the
    chunks' rows to the value dims."""
    m = mesh.mesh_dim_names.index(mesh_dim)
    return _SwapShare.apply(x, src, dst, mesh.get_local_rank(m),
                            mesh.get_group(m))


class _SplitProduct(torch.autograd.Function):
    """``product(eq, a, b)`` on local shards, where one operand (``x``)
    holds this rank's share of ``lab`` along mesh dim ``m`` and the other
    (``o``) holds it whole.

    ``whole_forward``: the forward all-gathers the share and runs whole;
    the backward computes ``x``'s gradient from its share (the others'
    rows of ``lab`` are theirs) and ``o``'s from the share too (a partial
    sum over ``m``), unless ``o`` keeps ``lab`` or ``gathered_grad``
    asks: then whole, from the gathered operand.
    ``whole_grad``: the forward runs on the share (``o`` sliced); the
    backward computes ``o``'s gradient whole (``x`` all-gathered for it)
    and ``x``'s from the share."""

    @staticmethod
    def forward(ctx, eq, a, b, lab, in_a, mesh, m, product, mode,
                gathered_grad=False):
        ins, out = eq.split("->")
        la, lb = ins.split(",")
        x, o, lx, lo = (a, b, la, lb) if in_a else (b, a, lb, la)
        rank, n = mesh.get_local_rank(m), x.shape[lx.index(lab)]

        def share(t, labels):
            if lab not in labels:
                return t
            return t.narrow(labels.index(lab), rank * n, n)

        ctx.eq, ctx.lab, ctx.in_a, ctx.mode = eq, lab, in_a, mode
        ctx.mesh, ctx.m, ctx.keep = mesh, m, lab in lo or gathered_grad
        ctx.share = share
        if mode == "whole_forward":
            full = _all_gather(x, lx.index(lab), mesh.get_group(m))
            y = product(eq, full, b) if in_a else product(eq, a, full)
            ctx.save_for_backward(x, o, full if ctx.keep else None)
            return y
        os_ = share(o, lo)
        y = product(eq, x, os_) if in_a else product(eq, os_, x)
        ctx.save_for_backward(x, o, None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, o, full = ctx.saved_tensors
        ins, ly = ctx.eq.split("->")
        la, lb = ins.split(",")
        lx, lo = (la, lb) if ctx.in_a else (lb, la)
        share = ctx.share
        if ctx.mode == "whole_forward":
            dx = torch.einsum(f"{ly},{lo}->{lx}", share(dy, ly),
                              share(o, lo))
            if ctx.keep:
                do = torch.einsum(f"{lx},{ly}->{lo}", full, dy)
            else:
                do = torch.einsum(f"{lx},{ly}->{lo}", x, share(dy, ly))
        else:
            full = _all_gather(x, lx.index(ctx.lab),
                               ctx.mesh.get_group(ctx.m))
            do = torch.einsum(f"{ly},{lx}->{lo}", dy, full)
            dx = torch.einsum(f"{ly},{lo}->{lx}", dy, share(o, lo))
        grads = (dx, do) if ctx.in_a else (do, dx)
        return (None, *grads, None, None, None, None, None, None, None)


class _GatheredOut(torch.autograd.Function):
    """``product(eq, a, b)`` on local tensors, where ``a`` holds this
    rank's share of its label ``lab`` along mesh dim ``m`` (which the
    output keeps) and ``b`` holds it whole: the forward runs on the share
    and all-gathers the output along ``lab``; the backward computes
    ``a``'s gradient whole from the output's whole gradient (then keeps
    the share) and ``b``'s from the share."""

    @staticmethod
    def forward(ctx, eq, a, b, lab, mesh, m, product):
        out = eq.split("->")[1]
        ctx.eq, ctx.lab, ctx.mesh, ctx.m = eq, lab, mesh, m
        ctx.save_for_backward(a, b)
        y = product(eq, a, b)
        return _all_gather(y, out.index(lab), mesh.get_group(m))

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        ins, ly = ctx.eq.split("->")
        la, lb = ins.split(",")
        n = a.shape[la.index(ctx.lab)]
        r = ctx.mesh.get_local_rank(ctx.m)
        share = dy.narrow(ly.index(ctx.lab), r * n, n)
        da = torch.einsum(f"{ly},{lb}->{la}", dy, b).narrow(
            la.index(ctx.lab), r * n, n)
        db = torch.einsum(f"{la},{ly}->{lb}", a, share)
        return None, da, db, None, None, None, None


def gathered_out(eq: str, a, b, mesh_dim: str, product=None):
    """``einsum(eq, a, b)`` for DTensors ``a``, split over ``mesh_dim`` on
    a label the output keeps, and ``b``, whole there (`_GatheredOut`):
    the product on the rank's share, its output gathered whole over
    ``mesh_dim``; in the backward ``a``'s gradient computed whole (each
    rank keeps its share) and ``b``'s on the share (a partial sum).
    Over the other mesh dims as `einsum`."""
    product = product or torch.einsum
    mesh = a.device_mesh
    m = mesh.mesh_dim_names.index(mesh_dim)
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    lab = la[a.placements[m].dim % a.ndim]
    pa, pb, gb, po = [], [], [], []
    for i, (xa, xb) in enumerate(zip(a.placements, b.placements)):
        if i == m:
            pa.append(xa), pb.append(Replicate()), gb.append(Partial())
            po.append(Replicate())
            continue
        if isinstance(xa, Shard) and la[xa.dim % a.ndim] not in lb:
            pa.append(xa), pb.append(Replicate()), gb.append(Partial())
            po.append(Shard(out.index(la[xa.dim % a.ndim])))
            continue
        raise ValueError(f"{eq}: mesh dim {i} lays out {xa}, {xb}")
    al = a.redistribute(mesh, pa).to_local(grad_placements=pa)
    bl = b.redistribute(mesh, pb).to_local(grad_placements=gb)
    with product_scope(eq):
        y = _GatheredOut.apply(eq, al, bl, lab, mesh, m, product)
    return DTensor.from_local(y, mesh, po, run_check=False)


class _ShareGrad(torch.autograd.Function):
    """``product(eq, a, b)`` on local tensors whole over mesh dim ``m``,
    run whole; its backward computes ``a``'s gradient whole and ``b``'s on
    this rank's share of the first of b's dims that the dim's ranks
    divide, zero elsewhere (the ranks' shares sum to the whole)."""

    @staticmethod
    def forward(ctx, eq, a, b, mesh, m, product):
        ctx.eq, ctx.mesh, ctx.m = eq, mesh, m
        ctx.save_for_backward(a, b)
        return product(eq, a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        ins, ly = ctx.eq.split("->")
        la, lb = ins.split(",")
        n, r = ctx.mesh.size(ctx.m), ctx.mesh.get_local_rank(ctx.m)
        i = next(i for i, size in enumerate(b.shape) if size % n == 0)
        lab, w = lb[i], b.shape[i] // n

        def share(t, labels):
            if lab not in labels:
                return t
            return t.narrow(labels.index(lab), r * w, w)

        da = torch.einsum(f"{ly},{lb}->{la}", dy, b)
        db = b.new_zeros(b.shape)
        db.narrow(i, r * w, w).copy_(torch.einsum(
            f"{la},{ly}->{lb}", share(a, la), share(dy, ly)))
        return None, da, db, None, None, None


class _Transpose(torch.autograd.Function):
    """Each rank's tensor sent to the rank whose coordinates along the
    two dims of a square mesh are its own swapped (``(i, j) -> (j,
    i)``), in one all-to-all over the whole group (only the swapped
    rank's chunk is not empty): the reference's collective-permute of a
    shard from one mesh axis to the other.  Its own transpose."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return transpose_local(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return transpose_local(g, ctx.mesh, ctx.dims), None, None


def transpose_local(x, mesh, dims):
    """`_Transpose`'s all-to-all on a local tensor, outside autograd.  The
    two dims must make up the mesh (their flattened group is the whole
    process group)."""
    import torch.distributed as dist
    d0, d1 = dims
    n = mesh.size(d0)
    if mesh.ndim != 2 or mesh.size(d1) != n:
        raise ValueError(f"transpose over {mesh}: needs two dims of one "
                         f"size making up the mesh")
    i, j = mesh.get_local_rank(d0), mesh.get_local_rank(d1)
    sizes = [0] * (n * n)
    sizes[j * n + i] = x.shape[0]
    return all_to_all(x, sizes, sizes, dist.group.WORLD)


def transposable(x, src: int, dst: int) -> bool:
    """True if the DTensor ``x`` is split over mesh dim ``src`` and whole
    over ``dst``, the two dims of a square mesh: `transpose_shard` can
    then move its split onto ``dst``."""
    mesh = x.device_mesh
    pl = list(x.placements)
    return (mesh.ndim == 2 and src != dst
            and mesh.size(src) == mesh.size(dst) > 1
            and isinstance(pl[src], Shard) and pl[dst] == Replicate())


def transpose_shard(x, src: int, dst: int):
    """The DTensor ``x``, split over mesh dim ``src`` and whole over
    ``dst`` (`transposable`), split the same way over ``dst`` and whole
    over ``src``: rank ``(i, j)``'s shard moves to rank ``(j, i)``, one
    all-to-all of the shard's elements, where a gather over ``src`` and
    a slice over ``dst`` would move the whole.  The reference's
    partitioner permutes a shard so (DTensor has no collective-permute).
    Its backward moves the gradient back the same way."""
    mesh = x.device_mesh
    pl = list(x.placements)
    pl[src], pl[dst] = pl[dst], pl[src]
    local = _Transpose.apply(x.to_local(grad_placements=x.placements), mesh,
                             (min(src, dst), max(src, dst)))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def reduce_grad_partial(x):
    """``x`` itself, whose gradient's partial sums are all-reduced in the
    backward pass where they arise: the transpose of `reduce_partial`.
    An activation that products over a split dim consume (the
    projections' input) gets a gradient of partial sums; the reference's
    partitioner reduces it at once, where DTensor would carry it into
    the next product and gather that product's other operand whole.
    The identity on a plain tensor or outside autograd."""
    if not is_dtensor(x) or not (torch.is_grad_enabled() and
                                 x.requires_grad):
        return x
    return _ReduceGrad.apply(x)


def even_share(n: int, parts: int, what: str) -> int:
    """``n // parts``: one rank's share of a dim of ``n`` (``what``)
    split over ``parts`` ranks.  Raises where ``parts`` does not divide
    ``n``: a per-rank plan cut short there would count a truncated
    share and record it without a word."""
    if n % parts:
        raise ValueError(f"{what}: {n} does not split over the {parts} "
                         f"ranks of the model axis")
    return n // parts


def along(x, mesh_dim: str, placement):
    """The DTensor ``x`` redistributed so that its placement over the
    mesh dim named ``mesh_dim`` is ``placement``, its others kept (a
    slice, a gather, an all-to-all or a reduction over that dim alone).
    The identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    pl = list(x.placements)
    pl[x.device_mesh.mesh_dim_names.index(mesh_dim)] = placement
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def shard(x, *names: str | None, shape=None):
    """The reference's ``shard``: ``x`` redistributed to the spec its
    logical ``names`` resolve to under the installed rules, against
    ``shape`` where given (default ``x.shape``).  The identity with no
    rules installed or on a plain tensor."""
    if not is_dtensor(x) or not _rules() or _mesh() is None:
        return x
    want = placements(resolve(names, shape or x.shape), x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
