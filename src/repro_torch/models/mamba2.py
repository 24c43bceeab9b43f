"""Mamba2 (SSD) blocks and the Zamba2 hybrid (zamba2-2.7b)
[arXiv:2405.21060, arXiv:2411.15242].

Mamba2 head-structured state space:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t      (A scalar per head)
    y_t = C_t . h_t + D x_t
The forward uses the SSD *chunked* algorithm: within-chunk quadratic
(decay-masked) term + across-chunk recurrence (a loop over chunks in
place of the reference's ``lax.scan``), so peak memory is (B, H, Q, Q)
per chunk instead of (B, H, S, S).  Decode is the O(1) recurrent update
(state (H, N, P) per layer, fp32).

Zamba2 layout: ``n_layers`` Mamba2 blocks with ONE shared attention+MLP
transformer block applied every ``attn_every`` layers.  The shared block
reads concat(hidden, embedding) folded to d_model by ``w_cat``, its
residual lands on the hidden stream, and each *application* keeps its
own KV cache (params shared, activations not).

On DTensors (the partitioned dry-run) each block runs per rank as the
reference's partitioner runs it (`_mamba_fwd_sharded`,
`_mamba_step_sharded`, `_fold`): the in-projection on each ``model``
rank's columns (``state``), each rank taking the pieces of its output
it reads (one all-to-all), the conv on the rank's channels, the scan on
its heads (the reference's ``state`` pin), C.B^T on its share of the
state dim.  Under ``REPRO_SP_RESIDUAL`` the residual's rows split over
``model`` through the blocks (`_rows_plan`): the in-projection and the
fold run on each rank's rows, C.B^T on each rank's chunks.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.axes import (along, contract, einsum,
                                       even_share, gather_fsdp, gather_share,
                                       is_dtensor, reduce_grad_partial,
                                       reduce_partial, regather,
                                       rows_to_cols, shard)


# ---------------------------------------------------------------------------
# Mamba2 block


def init_mamba(cfg: ModelConfig, gen: torch.Generator, scale: float,
               lead: tuple = ()):
    d, d_in = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    conv_dim = d_in + 2 * n          # x, B, C share the conv
    dev = gen.device

    def fill(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return dict(
        norm=fill((d,), 1.0),
        w_in=cm._normal(gen, (*lead, d, 2 * d_in + 2 * n + h), scale),
        conv_w=cm._normal(gen, (*lead, cfg.conv_kernel, conv_dim), 0.1),
        conv_b=fill((conv_dim,), 0.0),
        a_log=a_log.expand(*lead, h).clone(),
        dt_bias=fill((h,), 0.0),
        d_skip=fill((h,), 1.0),
        norm_y=fill((d_in,), 1.0),
        w_out=cm._normal(gen, (*lead, d_in, d), scale),
    )


def mamba_specs(cfg: ModelConfig):
    return dict(norm=(None,), w_in=("fsdp", "state"),
                conv_w=(None, "state"), conv_b=("state",),
                a_log=(None,), dt_bias=(None,), d_skip=(None,),
                norm_y=("state",), w_out=("state", "fsdp"))


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [d_in, d_in, 2 * n, h], dim=-1)


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` writes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _cb_by_rank(cfg: ModelConfig, mesh, bml, cml):
    """The SSD scan's C.B^T per chunk, (B, nc, q, q), from B and C (local
    tensors, whole on every ``model`` rank): each model rank contracts its
    share of the state dim (`parallel.axes.contract`: a multiply for a
    share of one), the partial sums all-reduced, as the reference's
    partitioner splits it; ``None`` where the state dim does not split."""
    m = mesh.mesh_dim_names.index("model")
    r, nm = mesh.get_local_rank(m), mesh.size(m)
    n = bml.shape[-1]
    if n % nm:
        return None
    q = min(cfg.ssm_chunk, bml.shape[1])
    share = n // nm

    def chunks(tl):
        s = tl.shape[1]
        tl = F.pad(tl, (0, 0, 0, -(-s // q) * q - s))
        return tl.reshape(tl.shape[0], -1, q, n)[..., r * share:
                                                 (r + 1) * share].float()

    cb = contract("bkin,bkjn->bkij", chunks(cml), chunks(bml))
    pl = [Partial() if i == m else Replicate() for i in range(mesh.ndim)]
    cb = DTensor.from_local(cb, mesh, pl, run_check=False)
    return cb.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=pl)


def _cb_by_chunk(cfg: ModelConfig, mesh, bml, cml):
    """The SSD scan's C.B^T per chunk, (B, nc, q, q), from B and C (local
    tensors, whole on every ``model`` rank) where the residual's rows
    split over ``model`` in whole chunks (`_rows_plan`), as the
    reference's partitioner runs it there (`_ChunkCB`)."""
    m = mesh.mesh_dim_names.index("model")
    nm = mesh.size(m)
    s = bml.shape[1]
    q = min(cfg.ssm_chunk, s)
    rows = even_share(s, nm, f"{cfg.name}: the rows")
    if rows % q:
        raise NotImplementedError(
            f"{cfg.name}: {rows} rows a model rank are not whole chunks of "
            f"{q}")
    return _ChunkCB.apply(bml, cml, cfg, rows, q, mesh, cm.recomputing())


class _ChunkCB(torch.autograd.Function):
    """C.B^T on the residual's rows split over ``model``: in the forward
    each model rank contracts the whole state dim over its own rows'
    chunks and the chunks are all-gathered; in a block's recompute the
    value is computed as without the rows' split, on the rank's share of
    the state dim, the partial sums all-reduced (`_cb_by_rank`), the
    reference's partitioner planning the recomputed product afresh (the
    plans' FLOPs differ only where a rank holds one state dim: the
    product on the shares is then an elementwise multiply, which neither
    count counts as a product; elsewhere they differ in the collective
    alone).  The backward (the forward's):the gradient's partial sums (each rank's
    heads) all-reduced, then B's and C's on the rank's own rows' chunks
    (zero on the other ranks' rows, whose gradients those ranks give)."""

    @staticmethod
    def forward(ctx, bml, cml, cfg, rows, q, mesh, recomputed):
        m = mesh.mesh_dim_names.index("model")
        r, nm = mesh.get_local_rank(m), mesh.size(m)
        ctx.save_for_backward(bml, cml)
        ctx.rows, ctx.q, ctx.r, ctx.group = rows, q, r, mesh.get_group(m)
        if recomputed and bml.shape[-1] % nm == 0:
            return _cb_by_rank(cfg, mesh, bml, cml)
        b, _, n = bml.shape
        lo = r * rows

        def mine(tl):
            return tl[:, lo:lo + rows].reshape(b, rows // q, q, n).float()

        cb = torch.einsum("bkin,bkjn->bkij", mine(cml), mine(bml))
        return gather_share(cb, 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        bml, cml = ctx.saved_tensors
        b, s, n = bml.shape
        q, rows = ctx.q, ctx.rows
        lo, hi = ctx.r * rows, (ctx.r + 1) * rows
        ops = torch.ops._c10d_functional
        g = ops.wait_tensor(ops.all_reduce(g.contiguous(), "sum",
                                           ctx.group.group_name))
        gm = g[:, lo // q:hi // q]

        def mine(tl):
            return tl[:, lo:hi].reshape(b, rows // q, q, n).float()

        grads = []
        for eq, other in (("bkij,bkin->bkjn", cml), ("bkij,bkjn->bkin", bml)):
            d = torch.zeros((b, s, n), dtype=bml.dtype, device=g.device)
            d[:, lo:hi] = torch.einsum(eq, gm, mine(other)).reshape(
                b, rows, n)
            grads.append(d)
        return grads[0], grads[1], None, None, None, None, None


def _ssd_scan(cfg: ModelConfig, xh, dt, a, bmat, cmat, cb=None):
    """SSD chunked scan.

    xh   (B,S,H,P)  inputs per head
    dt   (B,S,H)    positive step sizes
    a    (H,)       negative decay rates
    bmat (B,S,N), cmat (B,S,N)  shared across heads (n_groups=1)
    cb   (B,nc,q,q) C.B^T per chunk, where given (`_cb_by_rank`)
    Returns y (B,S,H,P) fp32.
    """
    b, s, h, p = xh.shape
    q = min(cfg.ssm_chunk, s)
    s_pad = -(-s // q) * q
    if s_pad != s:
        # dt=0 padding is inert: decay exp(0)=1, zero input contribution
        def pad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, s_pad - s))
        xh, dt, bmat, cmat = pad(xh), pad(dt), pad(bmat), pad(cmat)
    nc = s_pad // q
    da = dt * a[None, None, :]                        # (B,S,H), negative
    xb = (xh * dt[..., None]).float()                 # dt-weighted input

    def resh(t):
        return t.reshape(b, nc, q, *t.shape[2:])
    da_c, xb_c = resh(da), resh(xb)
    b_c, c_c = resh(bmat.float()), resh(cmat.float())
    cum = da_c.cumsum(2)                              # (B,nc,q,H)

    # within-chunk (diagonal) term: decay-masked quadratic
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,q,q,H)
    iq = torch.arange(q, device=xh.device)
    mask = iq[:, None] >= iq[None, :]
    l_mat = torch.where(mask[None, None, :, :, None], rel.exp(), 0.0)
    if cb is None:
        cb = torch.einsum("bkin,bkjn->bkij", c_c, b_c)   # (B,nc,q,q)
    y_diag = torch.einsum("bkijh,bkjhp->bkihp", cb[..., None] * l_mat, xb_c)

    # chunk boundary states + across-chunk recurrence
    decay_to_end = (cum[:, :, -1:, :] - cum).exp()       # (B,nc,q,H)
    states = torch.einsum("bkjn,bkjhp->bkhnp", b_c,
                          xb_c * decay_to_end[..., None])  # (B,nc,H,N,P)
    chunk_decay = cum[:, :, -1, :].exp()                 # (B,nc,H)
    h_prev = torch.zeros_like(states[:, 0])
    h_prevs = []
    for k in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, k, :, None, None] + states[:, k]
    h_prevs = torch.stack(h_prevs, 1)                    # (B,nc,H,N,P)

    # off-chunk term: contribution of the carried state
    y_off = (torch.einsum("bkin,bkhnp->bkihp", c_c, h_prevs)
             * cum.exp()[..., None])
    return (y_diag + y_off).reshape(b, s_pad, h, p)[:, :s]


def _rms_split(cfg: ModelConfig, y, w):
    """`common.rmsnorm` of the DTensor ``y`` over its last dim, split over
    ``model`` (as the weight ``w``): each rank's sum of squares, reduced
    over ``model``, as the reference's partitioner normalises it."""
    last = y.ndim - 1
    yl = y.to_local()
    yf = yl.float()
    ss = (yf * yf).sum(-1, keepdim=True)
    pl = [Partial() if q == Shard(last) else q for q in y.placements]
    ss = DTensor.from_local(ss, y.device_mesh, pl, run_check=False)
    ss = ss.redistribute(y.device_mesh, [
        Replicate() if isinstance(q, Partial) else q for q in pl])
    ss = ss.to_local(grad_placements=cm.partial_over_model(ss))
    out = yf * torch.rsqrt(ss / y.shape[-1] + cfg.norm_eps)
    wl = cm.local_for(along(w, "model", Shard(0)), y)
    out = (out * wl.float()).to(yl.dtype)
    return DTensor.from_local(out, y.device_mesh, y.placements,
                              run_check=False, shape=y.shape,
                              stride=y.stride())


def _share(local, like, width):
    """The local tensor ``local`` (this model rank's share of a last dim of
    ``width``) as a DTensor split there over ``model``, placed as
    ``like`` on the other mesh dims."""
    mesh = like.device_mesh
    last = local.ndim - 1
    pl = [Shard(last) if n == "model" else q
          for n, q in zip(mesh.mesh_dim_names, like.placements)]
    shape = (*like.shape[:-1], width)
    stride = [1]
    for n in reversed(shape[1:]):
        stride.insert(0, stride[0] * n)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


def _pieces(t, ranges_of, widths):
    """The columns of the DTensor ``t`` (its last dim split over ``model``
    in equal blocks) that this rank needs, ``ranges_of(r)`` (increasing
    ranges), moved by one all-to-all (`parallel.axes.regather`), cut by
    ``widths``; where ``t`` is whole over ``model``, sliced."""
    mi = t.device_mesh.mesh_dim_names.index("model")
    if t.placements[mi] == Replicate():
        tl = t.to_local(grad_placements=cm.partial_over_model(t))
        r = t.device_mesh.get_local_rank(mi)
        got = torch.cat([tl[..., a:b] for a, b in ranges_of(r)], dim=-1)
    else:
        got = regather(t, "model", ranges_of)
    return torch.split(got, widths, dim=-1)


def _in_proj(cfg: ModelConfig, p, z):
    """z @ w_in, each model rank on its columns (the ``state`` split of
    w_in); each rank then takes the pieces it reads (`_pieces`: its share
    of z, of the conv's input channels (x, B, C) and of dt), as the
    reference's partitioner moves only the windows each needs.  Returns
    z, the conv input and dt, each split over ``model``."""
    eq = "bsd,de->bse" if z.ndim == 3 else "bd,de->be"
    w = gather_fsdp(p["w_in"].to(cfg.dtype), ("fsdp", "state"))
    zx = einsum(eq, reduce_grad_partial(z), w, cm._plain_product)
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    nm = zx.device_mesh.size(zx.device_mesh.mesh_dim_names.index("model"))
    ranges, widths = _piece_ranges(cfg, nm)
    zg, xbc, dtp = _pieces(zx, ranges, widths)
    return (_share(zg, zx, d_in), _share(xbc, zx, d_in + 2 * n),
            _share(dtp, zx, h))


def _rows_plan(x) -> bool:
    """Whether ``x`` is the residual's rows split over ``model`` (a 3-D
    DTensor placed ``Shard(1)`` on a ``model`` dim of more than one
    rank), as `forward` lays them under ``REPRO_SP_RESIDUAL``: the
    reference's partitioner carries that knob's pin of the shared block's
    output (`transformer.residual_spec`) back through the layer loop, so
    that the in-projection, the C.B^T product of each chunk and the fold
    run on each rank's rows (`_in_proj_rows`, `_cb_by_chunk`, `_fold`).
    A decode step's 2-D rows, and rows laid otherwise, keep the plan
    without the knob."""
    if not is_dtensor(x) or x.ndim != 3:
        return False
    mesh = x.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return False
    m = cm._model_dim(mesh)
    return mesh.size(m) > 1 and x.placements[m] == Shard(1)


def _piece_ranges(cfg: ModelConfig, nm: int):
    """The in-projection's columns rank ``r`` of ``nm`` model ranks reads:
    its share of z, of the conv's input channels (x, B, C) and of dt,
    and their widths."""
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv = d_in + 2 * n
    zs, cs, hs = (even_share(n_, nm, f"{cfg.name}: {what}") for n_, what in
                  ((d_in, "d_inner"), (conv, "conv channels"),
                   (h, "SSM heads")))

    def ranges(r):
        return [(r * zs, (r + 1) * zs), (d_in + r * cs, d_in + (r + 1) * cs),
                (d_in + conv + r * hs, d_in + conv + (r + 1) * hs)]

    return ranges, [zs, cs, hs]


def _in_proj_rows(cfg: ModelConfig, p, z):
    """z @ w_in on each model rank's rows (`_rows_plan`), w_in gathered
    whole, its output then moved to the pieces each rank reads (its share
    of z, of the conv's input channels and of dt, every row) by one
    all-to-all (`parallel.axes.rows_to_cols`).  Returns z, the conv input
    and dt, each split over ``model`` on its last dim, as `_in_proj`."""
    w = along(gather_fsdp(p["w_in"].to(cfg.dtype), ("fsdp", "state")),
              "model", Replicate())
    zx = einsum("bsd,de->bse", z, w, cm._plain_product)
    mesh = zx.device_mesh
    nm = mesh.size(cm._model_dim(mesh))
    ranges, widths = _piece_ranges(cfg, nm)
    got = rows_to_cols(zx.to_local(grad_placements=zx.placements), mesh,
                       "model", ranges)
    zg, xbc, dtp = torch.split(got, widths, dim=-1)
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return (_share(zg, zx, d_in), _share(xbc, zx, d_in + 2 * n),
            _share(dtp, zx, h))


def _after_conv(cfg: ModelConfig, conv):
    """The conv's output (its channels split over ``model``): each rank
    takes its heads' share of x and B, C whole (`_pieces`)."""
    d_in, n = cfg.d_inner, cfg.ssm_state
    nm = conv.device_mesh.size(conv.device_mesh.mesh_dim_names.index(
        "model"))
    xs_ = even_share(d_in, nm, f"{cfg.name}: d_inner")
    xs, bml, cml = _pieces(conv, lambda r: [(r * xs_, (r + 1) * xs_),
                                            (d_in, d_in + 2 * n)],
                           [xs_, n, n])
    return _share(xs, conv, d_in), bml, cml


def _mamba_fwd_sharded(cfg: ModelConfig, p, x):
    """`mamba_fwd` on DTensors, each rank on its shards as the reference's
    partitioner runs it: the in-projection on each model rank's columns;
    the causal conv on its channels; the SSD scan on its heads (the
    reference's ``state`` pin of ``xh``), B and C whole; the gated norm
    over the heads' split width (its sum of squares reduced); the
    out-projection on its rows of w_out, its partial sums reduced.  Where
    the residual's rows split over ``model`` (`_rows_plan`), the
    in-projection runs on them (`_in_proj_rows`), C.B^T on each rank's
    chunks (`_cb_by_chunk`) and the reduced output is sliced to them."""
    dt_ = cfg.dtype
    h, hp, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    rows = _rows_plan(x)
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    zg, xbc, dtp = (_in_proj_rows if rows else _in_proj)(cfg, p, z)
    xl = xbc.to_local(grad_placements=xbc.placements)
    s = xl.shape[1]
    pad = F.pad(xl, (0, 0, k - 1, 0))
    wl = cm.local_for(p["conv_w"].to(dt_), xbc)
    bl = cm.local_for(p["conv_b"].to(dt_), xbc)
    conv = sum(pad[:, i:i + s] * wl[i] for i in range(k)) + bl
    conv = DTensor.from_local(F.silu(conv), xbc.device_mesh, xbc.placements,
                              run_check=False, shape=xbc.shape,
                              stride=xbc.stride())
    xs, bml, cml = _after_conv(cfg, conv)
    xsl = xs.to_local(grad_placements=xs.placements)
    dt_bias = cm.local_for(along(p["dt_bias"], "model", Shard(0)), xs)
    dtl = _softplus(dtp.to_local(grad_placements=dtp.placements).float()
                    + dt_bias)
    a = -cm.local_for(along(p["a_log"], "model", Shard(0)), xs).exp()
    b_ = xsl.shape[0]
    xh = xsl.reshape(b_, s, -1, hp)
    cb = (_cb_by_chunk if rows else _cb_by_rank)(cfg, xs.device_mesh, bml,
                                                  cml)
    y = _ssd_scan(cfg, xh, dtl, a, bml, cml, cb)
    d_skip = cm.local_for(along(p["d_skip"], "model", Shard(0)), xs)
    y = y + d_skip[None, None, :, None] * xh.float()
    y = DTensor.from_local(y.reshape(b_, s, -1).to(dt_), xs.device_mesh,
                           xs.placements, run_check=False, shape=xs.shape,
                           stride=xs.stride())
    y = _rms_split(cfg, y * F.silu(zg), p["norm_y"])
    w_out = gather_fsdp(p["w_out"].to(dt_), ("state", "fsdp"))
    out = reduce_partial(einsum("bsf,fd->bsd", y, w_out, cm._plain_product))
    if rows:
        out = along(out, "model", Shard(1))      # the rank's rows
    return x + out


def mamba_fwd(cfg: ModelConfig, p, x):
    if is_dtensor(x):
        return _mamba_fwd_sharded(cfg, p, x)
    dt_ = cfg.dtype
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    zg, xs, bc, dtp = _split_proj(cfg, z @ p["w_in"].to(dt_))

    # causal conv over (x, B, C): a sum of k shifted slices, as the
    # reference writes it
    xbc = torch.cat([xs, bc], dim=-1)
    k, s = cfg.conv_kernel, xbc.shape[1]
    xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xbc_pad[:, i:i + s] * p["conv_w"][i].to(dt_)
               for i in range(k)) + p["conv_b"].to(dt_)
    conv = F.silu(conv)
    xs, bmat, cmat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = _softplus(dtp.float() + p["dt_bias"])           # (B,S,H)
    a = -p["a_log"].exp()                                # (H,)
    xh = xs.reshape(*xs.shape[:2], h, cfg.ssm_head_dim)
    y = _ssd_scan(cfg, xh, dt, a, bmat, cmat)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(*y.shape[:2], d_in).to(dt_)
    y = cm.rmsnorm(y * F.silu(zg), p["norm_y"], cfg.norm_eps)
    return x + y @ p["w_out"].to(dt_)


def _mamba_step_sharded(cfg: ModelConfig, p, state, x):
    """`mamba_step` on DTensors, per rank as `_mamba_fwd_sharded`: the
    conv's history and its product on each model rank's channels, the
    state update on its heads (the cache's ``state`` split)."""
    dt_ = cfg.dtype
    hp = cfg.ssm_head_dim
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    zg, xbc, dtp = _in_proj(cfg, p, z)
    hist = torch.cat([state["conv"], xbc.float()[:, None, :]], dim=1)
    conv = einsum("bkc,kc->bc", hist, along(p["conv_w"], "model", Shard(1)))
    conv = F.silu(conv + along(p["conv_b"], "model", Shard(0)))
    xs, bml, cml = _after_conv(cfg, conv)
    dt = _softplus(dtp.to_local().float()
                   + along(p["dt_bias"], "model", Shard(0)).to_local())
    a = -along(p["a_log"], "model", Shard(0)).to_local().exp()
    xh = xs.to_local().reshape(xs.to_local().shape[0], -1, hp)
    dec = (dt * a[None, :]).exp()
    hl = state["h"].to_local()
    hs = (hl * dec[..., None, None]
          + torch.einsum("bn,bhp->bhnp", bml, xh * dt[..., None]))
    y = torch.einsum("bn,bhnp->bhp", cml, hs)
    d_skip = along(p["d_skip"], "model", Shard(0)).to_local()
    y = y + d_skip[None, :, None] * xh
    y = DTensor.from_local(y.reshape(y.shape[0], -1).to(dt_),
                           xs.device_mesh, xs.placements, run_check=False,
                           shape=xs.shape, stride=xs.stride())
    y = _rms_split(cfg, y * F.silu(zg), p["norm_y"])
    w_out = gather_fsdp(p["w_out"].to(dt_), ("state", "fsdp"))
    out = reduce_partial(einsum("bf,fd->bd", y, w_out, cm._plain_product))
    hs = DTensor.from_local(hs, state["h"].device_mesh,
                            state["h"].placements, run_check=False,
                            shape=state["h"].shape,
                            stride=state["h"].stride())
    return dict(h=hs, conv=hist[:, 1:]), x + out


def mamba_step(cfg: ModelConfig, p, state, x):
    """One-token recurrent update.  x (B, d); state ``h`` (B,H,N,P) and
    ``conv`` (B,k-1,conv_dim), fp32.  Returns (new state, x')."""
    if is_dtensor(x):
        return _mamba_step_sharded(cfg, p, state, x)
    dt_ = cfg.dtype
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    zg, xs, bc, dtp = _split_proj(cfg, z @ p["w_in"].to(dt_))
    xbc = torch.cat([xs, bc], dim=-1)                    # (B, conv_dim)
    hist = torch.cat([state["conv"], xbc[:, None, :].float()], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv = F.silu(conv)
    xs, bmat, cmat = torch.split(conv, [d_in, n, n], dim=-1)
    dt = _softplus(dtp.float() + p["dt_bias"])           # (B,H)
    a = -p["a_log"].exp()
    xh = xs.reshape(-1, h, cfg.ssm_head_dim)
    dec = (dt * a[None, :]).exp()                        # (B,H)
    hs = (state["h"] * dec[..., None, None]
          + torch.einsum("bn,bhp->bhnp", bmat, xh * dt[..., None]))
    y = torch.einsum("bn,bhnp->bhp", cmat, hs)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(-1, d_in).to(dt_)
    y = cm.rmsnorm(y * F.silu(zg), p["norm_y"], cfg.norm_eps)
    return dict(h=hs, conv=hist[:, 1:]), x + y @ p["w_out"].to(dt_)


# ---------------------------------------------------------------------------
# Zamba2 hybrid: mamba backbone + shared attention block


def _period(cfg: ModelConfig) -> int:
    """Mamba layers between two shared-block applications (all of them
    for the pure SSM)."""
    per = cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into segments of {per}")
    return per


def init_params(cfg: ModelConfig, gen: torch.Generator):
    scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    p = dict(embed=cm.init_embedding(cfg, gen),
             mamba=init_mamba(cfg, gen, scale, (cfg.n_layers,)))
    if cfg.family == "hybrid":
        p["shared"] = dict(
            w_cat=cm._normal(gen, (2 * cfg.d_model, cfg.d_model), scale),
            block=tt.init_block(cfg, gen))
    return p


def param_specs(cfg: ModelConfig):
    p = dict(embed=cm.embedding_specs(cfg),
             mamba=tt.stacked_specs(mamba_specs(cfg)))
    if cfg.family == "hybrid":
        p["shared"] = dict(w_cat=("fsdp", None), block=tt.block_specs(cfg))
    return p


def _fold(cfg: ModelConfig, p, x, x0):
    """concat(x, x0) @ w_cat.  On DTensors as the reference's partitioner
    runs it: on the pod its ZeRO-3 shard permuted to the ``model`` axis
    (`common.transposed_product`), elsewhere gathered and the product
    whole; on the residual's rows split over ``model`` (`_rows_plan`),
    gathered whole and the product on each rank's rows."""
    xx = torch.cat([x, x0], dim=-1)
    w = p["w_cat"].to(cfg.dtype)
    if not is_dtensor(xx):
        return xx @ w
    eq = "bse,ed->bsd" if xx.ndim == 3 else "be,ed->bd"
    if _rows_plan(xx):
        # on each rank's rows, w_cat gathered whole
        return einsum(eq, xx, gather_fsdp(w, ("fsdp", None)),
                      cm._plain_product)
    y = cm.transposed_product(xx, w, eq)
    if y is not None:
        return y
    return reduce_partial(einsum(eq, xx, gather_fsdp(w, ("fsdp", None)),
                                 cm._plain_product))


def _shared_apply(cfg: ModelConfig, p, x, x0, positions):
    u = _fold(cfg, p, x, x0)
    return x + tt.block_fwd(cfg, p["block"], u, positions) - u  # on x


def forward(cfg: ModelConfig, params, tokens):
    x = cm.embed(cfg, params["embed"], tokens)
    if (cfg.family == "hybrid" and tt.residual_spec()[1] == "seq"
            and is_dtensor(x) and "model" in x.device_mesh.mesh_dim_names
            and x.device_mesh.size(cm._model_dim(x.device_mesh)) > 1):
        # REPRO_SP_RESIDUAL: the residual's rows split over ``model`` from
        # the embedding on (`_rows_plan`)
        x = shard(x, "batch", "seq", None)
    x0 = x
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    per = _period(cfg)
    mp = cm.cast_params(cfg, params["mamba"])
    for i in range(cfg.n_layers):
        lp = tt._layer(mp, i)
        x = cm.recompute(functools.partial(mamba_fwd, cfg, lp), lp, x)
        if cfg.family == "hybrid" and (i + 1) % per == 0:
            x = _shared_apply(cfg, params["shared"], x, x0, positions)
    return cm.logits(cfg, params["embed"], x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    lead = (cfg.n_layers, batch)
    cache = dict(
        mamba=dict(h=zeros(lead + (cfg.ssm_heads, cfg.ssm_state,
                                   cfg.ssm_head_dim)),
                   conv=zeros(lead + (cfg.conv_kernel - 1,
                                      cfg.d_inner + 2 * cfg.ssm_state))),
        length=zeros((batch,), torch.int32))
    if cfg.family == "hybrid":
        shape = (cfg.n_layers // _period(cfg), batch, max_seq,
                 cfg.n_kv_heads, cfg.head_dim)
        cache["shared_kv"] = dict(k=zeros(shape, cfg.dtype),
                                  v=zeros(shape, cfg.dtype))
    return cache


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = True):
    spec = dict(
        mamba=dict(h=(None, "batch", "state", None, None),
                   conv=(None, "batch", None, "state")),
        length=(None,))
    if cfg.family == "hybrid":
        kv = (None, "batch", "kv_seq" if shard_seq else None,
              "kv_heads", None)
        spec["shared_kv"] = dict(k=kv, v=kv)
    return spec


def batch_axes(cfg: ModelConfig):
    """Each cache leaf's batch axis (see `transformer.batch_axes`)."""
    axes = dict(mamba=dict(h=1, conv=1), length=0)
    if cfg.family == "hybrid":
        axes["shared_kv"] = dict(k=1, v=1)
    return axes


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens (B,) -> (logits (B,V), cache').  The
    recurrent states and the shared block's KV caches are updated in
    place and returned in the new cache dict with ``length + 1``."""
    x = cm.embed(cfg, params["embed"], tokens[:, None])[:, 0]
    x0 = x
    lengths = cache["length"]
    per = _period(cfg)
    states = cache["mamba"]
    for i in range(cfg.n_layers):
        st, x = mamba_step(cfg, tt._layer(params["mamba"], i),
                           {k: v[i] for k, v in states.items()}, x)
        for k, v in st.items():
            tt.set_layer(states[k], i, v)
        if cfg.family == "hybrid" and (i + 1) % per == 0:
            p_sh = params["shared"]
            u = _fold(cfg, p_sh, x, x0)[:, None, :]
            kv = {k: v[i // per] for k, v in cache["shared_kv"].items()}
            _, u_out = tt.decode_block(cfg, p_sh["block"], kv, u, lengths)
            x = x + u_out[:, 0] - u[:, 0]
    out = cm.logits(cfg, params["embed"], x[:, None])[:, 0]
    return out, dict(cache, length=lengths + 1)
