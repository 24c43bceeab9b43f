"""The JAX package's partitioned compile of toy cells, in a subprocess.

Run as ``python tests/_ref_partition.py '<json list of cells>'`` with
``src/`` on the path; prints one JSON object: a record per cell.  A cell
is ``dict(arch, cfg, kind, seq, batch, mesh, accum=1, serving=False)``:
``arch`` names a smoke config, ``cfg`` overrides its fields, ``mesh`` is
``pod`` or ``multipod``; or ``dict(arch, shape, mesh)``: the full config
at a registered shape (``layers``: cut to that depth).  Either may carry
``env``, environment variables set while the cell is traced (the
reference's A/B knobs).

The reference's own dry-run raises under JAX 0.9 (``jax.make_mesh``
gives Explicit axes, and its first ``shard`` refuses them), so the mesh
is built here with ``Auto`` axes over forced host devices; everything
else is the reference's: ``sharding_rules``, ``rules_for``,
``build_cell``, ``jax.jit(...).lower(...).compile()`` with its
shardings and donation, and ``hlo_cost.analyze`` of the compiled text.
No file of ``src/repro/`` is changed.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs.registry import get_config, get_smoke  # noqa: E402
from repro.configs.shapes import SHAPES, ShapeConfig  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch.mesh import rules_for  # noqa: E402
from repro.models.registry import get_model  # noqa: E402
from repro.parallel.axes import sharding_rules  # noqa: E402
from repro.perfmodel import hlo_cost  # noqa: E402

#: the reference's train accumulation for a full config's cell (a toy
#: cell sets its own, `record`)
FULL_ACCUM = dryrun.DEFAULT_ACCUM

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _auto_mesh(mesh_name: str):
    """The mesh ``mesh_name`` (`MESHES`) with ``Auto`` axes over the first
    of the forced host devices."""
    shape, names = MESHES[mesh_name]
    n = 1
    for x in shape:
        n *= x
    return jax.make_mesh(shape, names, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(shape))


_COLL = re.compile(r"=\s*(.*?)\s+(all-gather|all-reduce|reduce-scatter|"
                   r"all-to-all|collective-permute)(-start)?\(")


def _scales(text: str):
    """(blocks, types, scale): ``scale(comp)`` is how many times the
    computation ``comp`` runs, from the trip counts of the while loops
    around it (as ``hlo_cost.analyze`` reads them) and, for a fusion or
    call, around its caller."""
    hc = hlo_cost
    blocks, types = hc._split_blocks(text), hc._build_type_map(text)
    trips, callers = {}, {}
    for parent, lines in blocks.items():
        for line in lines:
            m = hc._WHILE_RE.search(line)
            if m:
                trip = max([1] + [int(c.group(1)) for c in (
                    hc._CONST_RE.search(cl) for cl in blocks.get(
                        m.group(1), [])) if c])
                trips[m.group(2)] = (parent, trip)
            for callee in re.findall(r"calls=%?([\w.\-]+)", line):
                callers[callee] = parent

    def scale(comp):
        if comp in trips:
            parent, trip = trips[comp]
            return trip * scale(parent)
        return scale(callers[comp]) if comp in callers else 1

    return blocks, types, trips, scale


def fused_dot_flops(text: str) -> float:
    """FLOPs of the dots that ``hlo_cost.analyze`` does not see: those in
    computations it does not walk (the bodies of fusions and calls),
    each with ``analyze``'s own per-dot count, times its runs."""
    blocks, types, trips, scale = _scales(text)
    return sum(hlo_cost._dot_flops(line, types) * scale(comp)
               for comp, lines in blocks.items()
               if comp != "__entry__" and comp not in trips
               for line in lines if " dot(" in line)


def collective_arrays(text: str) -> list:
    """Every array each collective outputs, as ``(kind, dtype, dims,
    runs, op)``: a tuple output's arrays one by one (``hlo_cost`` reads
    only the first array of a tuple, and none when the tuple's text
    carries ``/*index=5*/`` comments, as the all-to-alls of these cells
    do), ``runs`` the times its computation runs, ``op`` the last part
    of the JAX op it partitions (its ``op_name``: ``split``,
    ``dot_general``, ...; empty where it has none)."""
    blocks, _, _, scale = _scales(text)
    out = []
    for comp, lines in blocks.items():
        for line in lines:
            m = _COLL.search(line)
            if m and "-done" not in line:
                op = re.search(r'op_name="([^"]*)"', line)
                op = op.group(1).rsplit("/", 1)[-1] if op else ""
                out += [(m.group(2), t, d, scale(comp), op) for t, d in
                        re.findall(r"(\w+)\[([\d,]*)\]", m.group(1))]
    return out


def full_collective_bytes(arrays: list) -> dict:
    """Each kind's output bytes, times its runs, every array counted."""
    out = {}
    for kind, t, d, runs, _ in arrays:
        n = hlo_cost._first_array_bytes(f"{t}[{d}]") * runs
        out[kind] = out.get(kind, 0) + n
    return out


def _ssd_two_operand(cfg, xh, dt, a, bmat, cmat):
    """The reference's SSD scan with its three three-operand einsums
    written as the port's two-operand ones (and elementwise products),
    `repro_torch.models.mamba2._ssd_scan`'s factorisation; the same
    values."""
    import jax.numpy as jnp
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    da = dt * a[None, None, :]
    xb = (xh * dt[..., None]).astype(jnp.float32)

    def resh(t):
        return t.reshape(b, nc, q, *t.shape[2:])
    da_c, xb_c = resh(da), resh(xb)
    b_c = resh(bmat.astype(jnp.float32))
    c_c = resh(cmat.astype(jnp.float32))
    cum = jnp.cumsum(da_c, axis=2)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    iq = jnp.arange(q)
    mask = iq[:, None] >= iq[None, :]
    l_mat = jnp.where(mask[None, None, :, :, None], jnp.exp(rel), 0.0)
    cb = jnp.einsum("bkin,bkjn->bkij", c_c, b_c)
    y_diag = jnp.einsum("bkijh,bkjhp->bkihp", cb[..., None] * l_mat, xb_c)
    decay_to_end = jnp.exp(cum[:, :, -1:, :] - cum)
    states = jnp.einsum("bkjn,bkjhp->bkhnp", b_c,
                        xb_c * decay_to_end[..., None])
    chunk_decay = jnp.exp(cum[:, :, -1, :])

    def scanb(h_prev, args):
        st, dec = args
        return h_prev * dec[..., None, None] + st, h_prev

    _, h_prevs = jax.lax.scan(
        scanb, jnp.zeros((b, h, n, p), jnp.float32),
        (states.transpose(1, 0, 2, 3, 4), chunk_decay.transpose(1, 0, 2)))
    h_prevs = h_prevs.transpose(1, 0, 2, 3, 4)
    y_off = (jnp.einsum("bkin,bkhnp->bkihp", c_c, h_prevs)
             * jnp.exp(cum)[..., None])
    return (y_diag + y_off).reshape(b, s, h, p)


@functools.lru_cache(maxsize=None)
def split_relayout(mesh_name: str, rows: tuple, d_in: int, n: int, h: int,
                   grad: bool = False) -> tuple:
    """XLA's collective-permutes for the bare re-layouts of zamba2's
    Mamba2 block at the cell's dims: an array of ``rows + (cols,)`` (the
    in-projection's output, its first dim split as the cell's rules split
    ``batch`` and its last over ``model``) cut into z, x, B and C, dt,
    x concatenated with B and C and scaled per channel (the conv's
    ``state``-split weights), cut again into x, B, C, every piece laid out
    by the ``state`` split, compiled on the mesh ``mesh_name``: the forward's
    permutes, or with ``grad`` those of its gradient (the forward again
    and the pieces' gradients put back), each as its elements.  XLA moves
    the windows where a piece's blocks and the source's overlap by
    collective-permutes (its compact halo exchange); compiled so, their
    grouping into permutes is XLA's own."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = _auto_mesh(mesh_name)
    batch = ("pod", "data") if mesh_name == "multipod" else "data"
    lead = (batch,) + (None,) * (len(rows) - 1)
    sh = NamedSharding(mesh, PartitionSpec(*lead, "model"))
    cols, conv = 2 * d_in + 2 * n + h, d_in + 2 * n
    x = jax.ShapeDtypeStruct(rows + (cols,), jnp.float32, sharding=sh)
    w = jax.ShapeDtypeStruct((conv,), jnp.float32, sharding=NamedSharding(
        mesh, PartitionSpec("model")))

    def pieces(a, cw):
        z, xs, bc, dt = jnp.split(a, [d_in, 2 * d_in, 2 * d_in + 2 * n],
                                  axis=-1)
        xbc = jnp.concatenate([xs, bc], axis=-1) * cw
        return tuple(jax.lax.with_sharding_constraint(p, sh) for p in
                     (z, dt, *jnp.split(xbc, [d_in, d_in + n], axis=-1)))

    fn = (jax.grad(lambda a, cw: sum((p * p).sum() for p in pieces(a, cw)))
          if grad else pieces)
    return _permute_sizes(jax.jit(fn).lower(x, w).compile().as_text())


def _permute_sizes(text: str) -> tuple:
    """The elements of each collective-permute of the compiled ``text``,
    once for each of its runs."""
    out = []
    for kind, t, d, runs, _ in collective_arrays(text):
        if kind == "collective-permute":
            size = 1
            for v in (d.split(",") if d else ()):
                size *= int(v)
            out += [size] * runs
    return tuple(out)


@functools.lru_cache(maxsize=None)
def block_relayout(mesh_name: str, rows: tuple, cfg, grad: bool = False
                   ) -> tuple:
    """XLA's collective-permutes for one bare Mamba2 block of ``cfg`` (the
    reference's own ``mamba_fwd`` under the cell's rules) on a residual
    of ``rows + (d,)`` whose rows split over ``model`` (the layout
    ``REPRO_SP_RESIDUAL`` carries into the block: the in-projection's
    output cut into its pieces, the causal conv's halo across the split
    rows), compiled on the mesh ``mesh_name``: the forward's permutes,
    or with ``grad`` those of the gradient of the block under
    ``jax.checkpoint`` (its recompute and backward), each as its
    elements.  A block's re-layouts in isolation, as `split_relayout`'s
    are without the knob."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.models import mamba2
    from repro.parallel.axes import resolve, spec_tree_to_shardings

    mesh = _auto_mesh(mesh_name)
    with sharding_rules(mesh, rules_for(mesh)):
        p = jax.eval_shape(lambda: mamba2.init_mamba(
            cfg, jax.random.PRNGKey(0), 0.02))
        psh = spec_tree_to_shardings(mamba2.mamba_specs(cfg), p)
        x = jax.ShapeDtypeStruct(rows + (cfg.d_model,), cfg.dtype)
        xsh = NamedSharding(mesh, resolve(("batch", "seq", None), x.shape))

        def block(p, x):
            return mamba2.mamba_fwd(cfg, jax.tree_util.tree_map(
                lambda a: a.astype(cfg.dtype) if a.ndim > 1 else a, p), x)

        if grad:
            ck = jax.checkpoint(block)
            fn = jax.grad(lambda p, x: ck(p, x).astype(jnp.float32).sum(),
                          argnums=(0, 1))
            out = (psh, xsh)
        else:
            fn, out = block, xsh
        with mesh:
            return _permute_sizes(jax.jit(
                fn, in_shardings=(psh, xsh), out_shardings=out).lower(
                    p, x).compile().as_text())


def relayouts(cell: dict) -> dict:
    """`split_relayout` at a zamba2 cell's dims (under ``REPRO_SP_RESIDUAL``,
    outside a decode step, `block_relayout`): its forward's and, for a
    train cell, its gradient's permutes; empty for other families."""
    if "shape" in cell:
        cfg, shape = get_config(cell["arch"]), SHAPES[cell["shape"]]
        b, t, kind = shape.global_batch, shape.seq_len, shape.kind
        accum = (dryrun.TRAIN_ACCUM.get(cfg.name, FULL_ACCUM)
                 if kind == "train" else 1)
    else:
        cfg = dataclasses.replace(get_smoke(cell["arch"]), **cell["cfg"])
        b, t, kind = cell["batch"], cell["seq"], cell["kind"]
        accum = cell.get("accum", 1)
    if cfg.family != "hybrid":
        return {}
    rows = (b // accum,) if kind == "decode" else (b // accum, t)
    if kind != "decode" and (cell.get("env") or {}).get("REPRO_SP_RESIDUAL"):
        return {("grad" if grad else "forward"): list(block_relayout(
            cell["mesh"], rows, cfg, grad))
            for grad in ((False, True) if kind == "train" else (False,))}
    dims = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads)
    return {("grad" if grad else "forward"): list(split_relayout(
        cell["mesh"], rows, *dims, grad))
        for grad in ((False, True) if kind == "train" else (False,))}


def lower(cell: dict):
    """The cell's step lowered (traced: one cell at a time, since the
    toy's accumulation and the SSD factorisation are module state).  A
    cell's ``env`` (the reference's A/B knobs, which it reads while
    tracing) is set around its lowering and restored after."""
    if cell.get("env"):
        saved = {k: os.environ.get(k) for k in cell["env"]}
        os.environ.update(cell["env"])
        try:
            return lower(dict(cell, env=None))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if cell.get("ssd") == "two_operand":
        from repro.models import mamba2
        three, mamba2._ssd_scan = mamba2._ssd_scan, _ssd_two_operand
        try:
            return lower(dict(cell, ssd=None))
        finally:
            mamba2._ssd_scan = three
    mesh = _auto_mesh(cell["mesh"])
    if "shape" in cell:
        cfg, shape = get_config(cell["arch"]), SHAPES[cell["shape"]]
        if cell.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=cell["layers"])
        dryrun.DEFAULT_ACCUM = FULL_ACCUM
    else:
        cfg = dataclasses.replace(get_smoke(cell["arch"]), **cell["cfg"])
        shape = ShapeConfig("toy", cell["kind"], cell["seq"], cell["batch"])
        dryrun.DEFAULT_ACCUM = cell.get("accum", 1)     # the toy's accum
    kind = shape.kind
    serving = cell.get("serving", False)
    with sharding_rules(mesh, rules_for(mesh, serving=serving)):
        api = get_model(cfg)
        fn, structs, in_sh, out_sh = dryrun.build_cell(api, shape,
                                                       serving=serving)
        with mesh:
            donate = {"decode": (1,), "train": (0, 1)}.get(kind, ())
            return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*structs)


def record(cell: dict, compiled) -> dict:
    """The cell's record from its compiled step."""
    mem = compiled.memory_analysis()
    text = compiled.as_text()
    parsed = hlo_cost.analyze(text)
    arrays = collective_arrays(text)
    return dict(relayout={} if cell.get("ssd") else relayouts(cell),
                flops=parsed["flops"], fused_dot_flops=fused_dot_flops(text),
                bytes=parsed["bytes"],
                bytes_by_op=parsed["bytes_by_op"], counts=parsed["counts"],
                full_bytes_by_op=full_collective_bytes(arrays),
                arrays=arrays,
                args=float(mem.argument_size_in_bytes),
                temp=float(mem.temp_size_in_bytes))


def _compiled_record(cell: dict, lowered) -> dict:
    """The record of ``cell`` from its lowered step, compiled here; the
    executable is dropped once its record is read (every executable kept
    to the end held the memory of all of them at once)."""
    return record(cell, lowered.compile())


def records(cells: list, workers: int = 6) -> list:
    """Each cell's record: lowered one after another, each compiled and
    read in one of ``workers`` threads as soon as it is lowered (XLA's
    compile runs outside the interpreter's lock)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        futures = [pool.submit(_compiled_record, c, lower(c)) for c in cells]
        return [f.result() for f in futures]


if __name__ == "__main__":
    print(json.dumps(records(json.loads(sys.argv[1]))))
