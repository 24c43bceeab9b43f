"""xLSTM (xlstm-1.3b): mLSTM + sLSTM blocks [arXiv:2405.04517].

Layout: ``slstm_every``-periodic — each segment is (slstm_every - 1)
mLSTM blocks followed by one sLSTM block (48 layers = 6 segments of
7 mLSTM + 1 sLSTM).

mLSTM (matrix-memory LSTM, exponential gating):
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t . q_t|, 1)
with a log-domain stabiliser m_t that starts at -1e30.  The forward uses
the quadratic parallel form, query-chunked like the chunked attention
(its decay-weighted scores and values rounded to bf16 before their
product, as the reference's are); decode is the O(1) recurrent update
(state (H, dh, dh) per layer, fp32).

sLSTM (scalar memory, recurrent gating) is sequential: a loop over time
(`common.scan`) takes the place of the reference's ``lax.scan``, one
small group of kernels per token; the dry-run counts it by its trip
count, as the reference's cost model counts the scan.

On DTensors (the partitioned dry-run) the blocks run per rank as the
reference's partitioner runs them (`_mlstm_fwd_sharded`,
`_slstm_fwd_sharded` and the two steps; see the section below): the
projections around the mLSTM's query-chunk loop on each model rank's
rows where the rows lie within one chunk, on the whole rows past it
and under ``REPRO_NO_SP`` (`_rows_whole`); on a mesh of one rank the
blocks' plain forward runs.
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
                                       product_scope, reduce_partial,
                                       regather, regather_local, shard,
                                       swap_share)
from repro_torch.tree import map_tree

M_INIT = -1e30            # the stabiliser's initial value


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def _sdims(cfg: ModelConfig):
    """sLSTM operates at d_model width (official block shape)."""
    return cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads


def _segments(cfg: ModelConfig):
    per = cfg.slstm_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into segments of {per}")
    return cfg.n_layers // per, per - 1


# ---------------------------------------------------------------------------
# mLSTM block


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, scale: float,
               lead: tuple = ()):
    """One up-projection d -> 2 d_in, then per-head block-diagonal q/k/v
    over the up-projected half (the official block shape)."""
    d = cfg.d_model
    d_in, h, dh = _dims(cfg)
    bif = torch.tensor([0.0, 3.0], device=gen.device).expand(*lead, h, 2)
    return dict(
        norm=torch.ones((*lead, d), dtype=torch.float32, device=gen.device),
        w_up=cm._normal(gen, (*lead, d, 2 * d_in), scale),
        wq=cm._normal(gen, (*lead, h, dh, dh), scale),
        wk=cm._normal(gen, (*lead, h, dh, dh), scale),
        wv=cm._normal(gen, (*lead, h, dh, dh), scale),
        wif=cm._normal(gen, (*lead, d, h, 2), 0.02),
        bif=bif.clone(),
        wo=cm._normal(gen, (*lead, h, dh, d), scale),
    )


def mlstm_specs(cfg: ModelConfig):
    return dict(norm=(None,), w_up=("fsdp", "state"),
                wq=("heads", None, "state"), wk=("heads", None, "state"),
                wv=("heads", None, "state"),
                wif=("fsdp", None, None), bif=(None, None),
                wo=("heads", "state", "fsdp"))


def _mlstm_parallel(q, k, v, logi, logf, chunk: int = 1024):
    """Stabilised quadratic mLSTM, looped over query chunks.

    q,k,v (B,S,H,dh); logi/logf (B,S,H).  Returns (B,S,H,dh) fp32.
    """
    b, s, h, dh = q.shape
    scale = 1.0 / (dh ** 0.5)
    cumf = logf.cumsum(1)                               # (B,S,H)
    chunk = min(chunk, max(-(-s // 128) * 128, 128))   # no padding waste
    nq = -(-s // chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * chunk - s))
    cumf_p = F.pad(cumf, (0, 0, 0, nq * chunk - s))
    kterm = logi - cumf                                 # log i_j - F_j
    kf = k.float()
    pdt = cm.probs_dtype()
    vb = v.to(pdt).float()
    jpos = torch.arange(s, device=q.device)[None, None, :, None]
    outs = []
    for i in range(nq):
        rows = slice(i * chunk, (i + 1) * chunk)
        qi, cfi = qp[:, rows], cumf_p[:, rows]         # (B,c,H,dh),(B,c,H)
        # logD_ij = F_i + (log i_j - F_j), masked to j <= i_abs
        logd = cfi[:, :, None, :] + kterm[:, None, :, :]   # (B,c,S,H)
        ipos = (i * chunk + torch.arange(chunk, device=q.device))[
            None, :, None, None]
        logd = torch.where(jpos <= ipos, logd, float("-inf"))
        m = logd.amax(2, keepdim=True)                  # (B,c,1,H)
        m = torch.where(torch.isfinite(m), m, 0.0)
        dmat = (logd - m).exp()
        sc = torch.einsum("bchd,bshd->bcsh", qi.float(), kf) * scale
        sd = sc * dmat
        norm = torch.maximum(sd.sum(2).abs(), (-m[:, :, 0, :]).exp())
        out = torch.einsum("bcsh,bshd->bchd",
                           sd.to(pdt).float(), vb)
        outs.append(out / norm[..., None])
    return torch.cat(outs, 1)[:, :s]


def _mlstm_proj(cfg: ModelConfig, p, z):
    """Shared projection path: up-project, per-head q/k/v, gates."""
    dt = cfg.dtype
    _, h, dh = _dims(cfg)
    xa, zg = (z @ p["w_up"].to(dt)).chunk(2, dim=-1)
    xh = xa.reshape(*xa.shape[:-1], h, dh)
    q = torch.einsum("...hk,hkl->...hl", xh, p["wq"].to(dt))
    k = torch.einsum("...hk,hkl->...hl", xh, p["wk"].to(dt))
    v = torch.einsum("...hk,hkl->...hl", xh, p["wv"].to(dt))
    gates = torch.einsum("...d,dhg->...hg", z.float(),
                         p["wif"].float()) + p["bif"]
    logi = gates[..., 0]                                 # log input gate
    logf = F.logsigmoid(gates[..., 1])                   # log forget gate
    return q, k, v, zg, logi, logf


# ---------------------------------------------------------------------------
# the blocks on DTensors (the pod / multipod dry-run)
#
# xlstm-1.3b's 4 heads cannot split the 16-way ``model`` axis, so the
# reference's rules put its tensor parallelism on the value dims
# (``state``) and its mLSTM falls back to splitting each query chunk's
# rows over ``model``; under ``REPRO_NO_SP`` (the fallback off) the
# partitioner splits the scores over the value dims instead
# (`_mlstm_by_value`).  Each function below runs the block per rank with
# the placements the reference's partitioner gives it.


def _whole(t, like):
    """The parameter ``t`` gathered whole (its ZeRO-3 and ``state``
    splits), as the local tensor of a product per rank against ``like``
    (its gradient a partial sum where ``like`` is split)."""
    t = along(gather_fsdp(t, tuple("fsdp" for _ in range(t.ndim))),
              "model", Replicate())
    return cm.local_for(t, like)


def _mlstm_qkv_sharded(cfg: ModelConfig, p, z):
    """The up-projection on each model rank's columns (``state``), its
    output gathered over ``model`` (xh whole), then q/k/v on each rank's
    share of the value dim (``state``); zg whole."""
    dt = cfg.dtype
    _, h, dh = _dims(cfg)
    lead = "bs" if z.ndim == 3 else "b"
    up = einsum(f"{lead}d,de->{lead}e", reduce_grad_partial(z),
                gather_fsdp(p["w_up"].to(dt), ("fsdp", "state")),
                cm._plain_product)
    xa, zg = along(up, "model", Replicate()).chunk(2, dim=-1)
    xh = xa.reshape(*xa.shape[:-1], h, dh)
    q, k, v = (einsum(f"{lead}hk,hkl->{lead}hl", xh, p[w].to(dt))
               for w in ("wq", "wk", "wv"))
    return q, k, v, zg


def _chunks(t, s_pad, c, rows=None):
    """(B, S, ...) -> (B, nq, c, ...) padded to ``s_pad`` rows; with
    ``rows`` = (rank, share), each chunk's rows of that share."""
    t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, s_pad - t.shape[1]))
    t = t.reshape(t.shape[0], s_pad // c, c, *t.shape[2:])
    if rows is None:
        return t
    r, n = rows
    return t[:, :, r * n:(r + 1) * n]


MLSTM_CHUNK = 1024        # the mLSTM's query chunk (`_mlstm_parallel`)


def _chunk_rows(s: int):
    """``(c, nq)``: `_mlstm_parallel`'s query chunk over ``s`` rows and
    the number of chunks."""
    c = min(MLSTM_CHUNK, max(-(-s // 128) * 128, 128))
    return c, -(-s // c)


def _rows_whole(cfg: ModelConfig, s: int, nm: int) -> bool:
    """Whether the projections around the mLSTM's query-chunk loop (and
    the sLSTM's after it) run on the whole rows of ``s`` on ``nm`` model
    ranks: past one chunk (`common._rows_whole`), and wherever the heads
    may split the ``model`` axis (``REPRO_NO_SP``: `_mlstm_by_value`), as
    the reference's partitioner plans them; else on each rank's rows."""
    return cm._rows_whole(s, MLSTM_CHUNK) or (
        cm.heads_tp_available(cfg.n_heads) and nm > 1)


def _chunk_loop(ql, cumf_r, kterm, kf, vb, s, c, row0, scale):
    """`_mlstm_parallel`'s loop on each chunk's query rows ``ql`` (B, nq,
    n, H, dh) from row ``row0`` of the chunk (their cumulative forget
    gates ``cumf_r``) against the whole keys, values and key terms:
    (B, nq, n, H, dh) fp32."""
    pdt = cm.probs_dtype()
    n = ql.shape[2]
    jpos = torch.arange(s, device=ql.device)[None, None, :, None]
    outs = []
    for i in range(ql.shape[1]):
        qi, cfi = ql[:, i], cumf_r[:, i]
        logd = cfi[:, :, None, :] + kterm[:, None, :, :]
        ipos = (i * c + row0 + torch.arange(n, device=ql.device))[
            None, :, None, None]
        logd = torch.where(jpos <= ipos, logd, float("-inf"))
        m = logd.amax(2, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        dmat = (logd - m).exp()
        sc = torch.einsum("bchd,bshd->bcsh", qi.float(), kf) * scale
        sd = sc * dmat
        norm = torch.maximum(sd.sum(2).abs(), (-m[:, :, 0, :]).exp())
        out = torch.einsum("bcsh,bshd->bchd",
                           sd.to(pdt).float(), vb)
        outs.append(out / norm[..., None])
    return torch.stack(outs, 1)


def _bias_local(p, like):
    """The gates' bias as the local tensor to add to the local gates of
    the activation ``like``: its gradient a partial sum over ``model``
    (each model rank runs its own query rows or value block) and over
    the dims ``like`` splits."""
    names = like.device_mesh.mesh_dim_names
    return p["bif"].to_local(grad_placements=[
        Partial() if n == "model" or isinstance(a, Shard) else q
        for n, q, a in zip(names, p["bif"].placements, like.placements)])


def _mlstm_fwd_sharded(cfg: ModelConfig, p, x):
    """`mlstm_fwd` per rank: q/k/v as `_mlstm_qkv_sharded`; the
    reference's sequence-parallel fallback of `_mlstm_parallel` (each
    query chunk's rows split over ``model``, q moved there by an
    all-to-all; k, v (the reference's pin), the gates' cumulative sums
    whole).  Around the loop the plan follows the rows, as the
    reference's partitioner's does (`_rows_whole`): over one
    chunk the gates run on each model rank's rows (their output gathered
    whole), the output projection on the rank's rows with w_o gathered
    whole, the rows gathered back; over more than one chunk the gates
    run on the whole rows on every model rank, the loop's output is
    gathered to the whole rows on each rank's share of the value dims
    (`parallel.axes.swap_share`), and the output projection runs there
    on w_o's own ``state`` split, its partial sums reduced."""
    dt = cfg.dtype
    _, h, dh = _dims(cfg)
    b, s, _ = x.shape
    mesh = x.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    r, nm = mesh.get_local_rank(mi), mesh.size(mi)
    c, nq = _chunk_rows(s)
    whole_rows = _rows_whole(cfg, s, nm)
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, zg = _mlstm_qkv_sharded(cfg, p, z)
    v = shard(v, "batch", None, "heads", None)
    if cm.heads_tp_available(h) and nm > 1:
        return x + _mlstm_by_value(cfg, p, z, q, k, v, zg)
    wif = gather_fsdp(p["wif"].float(), ("fsdp", None, None))

    def whole(t):
        t = along(t, "model", Replicate())
        return t.to_local(grad_placements=cm.partial_over_model(t))

    if whole_rows:
        gates = einsum("bsd,dhg->bshg", z.float(), wif, share_grad="model")
        gw = gates.to_local(grad_placements=cm.partial_over_model(gates)) \
            + _bias_local(p, gates)
    else:
        zr = along(z.float(), "model", Shard(1))
        gates = einsum("bsd,dhg->bshg", zr, wif)
        gl = gates.to_local(grad_placements=gates.placements) + \
            _bias_local(p, gates)
        gw = whole(DTensor.from_local(gl, mesh, gates.placements,
                                      run_check=False, shape=gates.shape,
                                      stride=gates.stride()))
    logi, logf = gw[..., 0], F.logsigmoid(gw[..., 1])
    share = even_share(c, nm, f"{cfg.name}: the mLSTM's chunk rows")
    # q: its value-dim split moved to each chunk's rows (one all-to-all)
    ql = q.to_local(grad_placements=q.placements)
    q5 = DTensor.from_local(_chunks(ql, nq * c, c), mesh,
                            [Shard(4) if p_ == Shard(3) else p_
                             for p_ in q.placements], run_check=False)
    ql = along(q5, "model", Shard(2))
    ql = ql.to_local(grad_placements=ql.placements)
    kf, vb = whole(k).float(), whole(v).to(cm.probs_dtype()).float()
    cumf = logf.cumsum(1)
    kterm = logi - cumf
    cumf_r = _chunks(cumf, nq * c, c, (r, share))
    o = _chunk_loop(ql, cumf_r, kterm, kf, vb, s, c, r * share,
                    1.0 / (dh ** 0.5))                # (B, nq, share, H, dh)
    if whole_rows:
        dhm = even_share(dh, nm, f"{cfg.name}: the mLSTM's value dims")
        o = swap_share(o, 2, 4, mesh, "model")       # (B, nq, c, H, dh/M)
        o = o.reshape(o.shape[0], nq * c, h, dhm)[:, :s]
        g = F.silu(whole(zg)).unflatten(-1, (h, dh))
        g = g[..., r * dhm:(r + 1) * dhm]
        pl = [Shard(3) if i == mi else p_
              for i, p_ in enumerate(x.placements)]
        og = DTensor.from_local(o.to(dt) * g, mesh, pl, run_check=False)
        y = reduce_partial(einsum("bshk,hkd->bsd", og, gather_fsdp(
            p["wo"].to(dt), ("heads", "state", "fsdp")), cm._plain_product))
        return x + y
    g = _chunks(F.silu(whole(zg)), nq * c, c, (r, share))
    o = o.to(dt) * g.reshape(*g.shape[:3], h, -1)
    wo = _whole(p["wo"].to(dt), zr)
    y = torch.einsum("bnchk,hkd->bncd", o, wo)
    pl = [Shard(2) if i == mi else p_ for i, p_ in enumerate(x.placements)]
    y = DTensor.from_local(y, mesh, pl, run_check=False)
    y = along(y, "model", Replicate())
    yl = y.to_local(grad_placements=y.placements)
    yl = yl.reshape(yl.shape[0], nq * c, -1)[:, :s]
    return x + DTensor.from_local(yl, mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())


def _mlstm_by_value(cfg: ModelConfig, p, z, q, k, v, zg):
    """The mLSTM's gates, query-chunk loop and output projection (its
    update of the residual), per rank, where its heads may split the
    ``model`` axis (``REPRO_NO_SP``: no sequence-parallel fallback),
    as the reference's partitioner runs it with q, k and v split over the
    value dims (``state``) and every row whole: the flattened heads'
    value dims cut into ``model`` blocks of ``H*dh/M``, each within one
    head (``hr``); each query chunk's scores summed over the value dims'
    shares (one all-reduce, all heads), the rank's head's decay-weighted
    scores against its block of v gathered whole, the gates of its head
    alone (w_if's head gathered); the output projection on the block,
    w_o's ``state`` split moved to it by one all-to-all
    (`parallel.axes.regather_local`), its partial sums reduced."""
    dt = cfg.dtype
    _, h, dh = _dims(cfg)
    s = z.shape[1]
    mesh = z.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    r, nm = mesh.get_local_rank(mi), mesh.size(mi)
    dhm = even_share(dh, nm, f"{cfg.name}: the mLSTM's value dims")
    blk = even_share(h * dh, nm, f"{cfg.name}: the mLSTM's value blocks")
    if dh % blk:
        raise NotImplementedError(
            f"{cfg.name}: {h} heads on {nm} model ranks: a value block of "
            f"{blk} would span heads")
    hr, c0 = divmod(r * blk, dh)
    c, nq = _chunk_rows(s)
    # the gates of the rank's head, on the whole rows
    wif = p["wif"].float()
    wl = wif.to_local(grad_placements=[
        Partial() if i == mi else q_ for i, q_ in enumerate(wif.placements)])
    wl = wl[:, hr]
    for i, q_ in enumerate(wif.placements):
        if isinstance(q_, Shard) and i != mi:
            wl = gather_share(wl, 0, mesh, mesh.mesh_dim_names[i])
    zf = z.float()
    zl = zf.to_local(grad_placements=cm.partial_over_model(zf))
    gates = torch.einsum("bsd,dg->bsg", zl, wl) + _bias_local(p, z)[hr]
    logi, logf = gates[..., 0], F.logsigmoid(gates[..., 1])
    cumf = logf.cumsum(1)
    kterm = logi - cumf
    cumf = F.pad(cumf, (0, nq * c - s))
    ql = F.pad(q.to_local(grad_placements=q.placements),
               (0, 0, 0, 0, 0, nq * c - s))
    kf = k.to_local(grad_placements=k.placements).float()
    vb = v.to_local(grad_placements=cm.partial_over_model(v)).to(
        cm.probs_dtype()).float()[:, :, hr, c0:c0 + blk]
    pl = [Partial() if i == mi else q_ for i, q_ in enumerate(z.placements)]
    pdt = cm.probs_dtype()
    jpos = torch.arange(s, device=ql.device)[None, None, :]
    scale = 1.0 / (dh ** 0.5)
    outs = []
    for i in range(nq):
        rows = slice(i * c, (i + 1) * c)
        part = torch.einsum("bchd,bshd->bcsh", ql[:, rows].float(), kf)
        sc = reduce_partial(DTensor.from_local(part, mesh, pl,
                                               run_check=False))
        sc = sc.to_local(grad_placements=pl)[..., hr] * scale
        logd = cumf[:, rows, None] + kterm[:, None, :]
        ipos = (i * c + torch.arange(c, device=ql.device))[None, :, None]
        logd = torch.where(jpos <= ipos, logd, float("-inf"))
        m = logd.amax(2, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        sd = sc * (logd - m).exp()
        norm = torch.maximum(sd.sum(2).abs(), (-m[:, :, 0]).exp())
        out = torch.einsum("bcs,bsd->bcd", sd.to(pdt).float(), vb)
        outs.append(out / norm[..., None])
    o = torch.cat(outs, 1)[:, :s]                       # (B, S, blk)
    zw = along(zg, "model", Replicate())
    g = F.silu(zw.to_local(grad_placements=cm.partial_over_model(zw)))
    o = o.to(dt) * g[..., r * blk:(r + 1) * blk]
    wo = gather_fsdp(p["wo"].to(dt), ("heads", "state", "fsdp"))
    wol = wo.to_local(grad_placements=[
        Partial() if isinstance(a, Shard) else q_
        for q_, a in zip(wo.placements, z.placements)]).flatten(0, 1)
    wol = regather_local(
        wol, mesh, "model", lambda q_: [(q_ * blk, (q_ + 1) * blk)], dim=0,
        owned=lambda q_: [i * dh + q_ * dhm + j for i in range(h)
                          for j in range(dhm)])
    with product_scope("bshk,hkd->bsd"):
        y = o @ wol
    return reduce_partial(DTensor.from_local(y, mesh, pl, run_check=False,
                                             shape=z.shape,
                                             stride=z.stride()))


def _mlstm_step_sharded(cfg: ModelConfig, p, state, x):
    """`mlstm_step` per rank: q/k/v as `_mlstm_qkv_sharded`, q and k
    gathered whole; the gates with the input gate's weight permuted to
    the ``model`` axis (`common.transposed_product`); C on each rank's
    share of its value rows (the cache's ``state``); the output
    projection on that share, its partial sums reduced."""
    dt = cfg.dtype
    _, h, dh = _dims(cfg)
    mesh = x.device_mesh
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, zg = _mlstm_qkv_sharded(cfg, p, z)
    gates = cm.transposed_product(z.float(), p["wif"].float(),
                                  "bd,dhg->bhg", torch.einsum)
    if gates is None:
        gates = reduce_partial(einsum(
            "bd,dhg->bhg", z.float(),
            gather_fsdp(p["wif"].float(), ("fsdp", None, None))))
    gates = gates.to_local() + p["bif"].to_local()
    logi, logf = gates[..., 0], F.logsigmoid(gates[..., 1])
    ql = along(q, "model", Replicate()).to_local().float()
    kl = along(k, "model", Replicate()).to_local().float()
    vl = v.to_local().float()
    m_new = torch.maximum(logf + state["m"].to_local(), logi)
    fp = (logf + state["m"].to_local() - m_new).exp()[..., None]
    ip = (logi - m_new).exp()[..., None]
    n = fp * state["n"].to_local() + ip * kl
    C = (fp[..., None] * state["C"].to_local()
         + ip[..., None] * vl[..., :, None] * kl[..., None, :])
    denom = torch.maximum((n * ql).sum(-1).abs(), (-m_new).exp())
    o = torch.einsum("bhvk,bhk->bhv", C, ql / (dh ** 0.5)) \
        / denom[..., None]
    g = along(F.silu(zg).float().reshape(*zg.shape[:-1], h, dh), "model",
              Shard(2)).to_local()
    o = DTensor.from_local((o * g).to(dt), mesh, v.placements,
                           run_check=False, shape=v.shape, stride=v.stride())
    y = reduce_partial(einsum("bhk,hkd->bd", o,
                              gather_fsdp(p["wo"].to(dt),
                                          ("heads", "state", "fsdp"))))

    def like(t, ref):
        return DTensor.from_local(t, mesh, ref.placements, run_check=False,
                                  shape=ref.shape, stride=ref.stride())

    return (dict(C=like(C, state["C"]), n=like(n, state["n"]),
                 m=like(m_new, state["m"])), x + y)


def _on_one_rank(fn, cfg: ModelConfig, p, x):
    """``fn`` (a block's plain forward) on the local tensors of ``x`` and
    ``p``, DTensors on a mesh of one rank (the 1 x 1 host mesh, whose
    ``model`` axis is no mesh dim of its own): the plain plan, as the
    reference's partitioner runs it on one device."""
    local = map_tree(lambda t: t.to_local() if is_dtensor(t) else t, p)
    y = fn(cfg, local, x.to_local())
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _sharded(x) -> bool:
    """Whether ``x`` is a DTensor on a mesh with a ``model`` dim (the
    partitioned plans); on a mesh of one rank the plain plan runs."""
    return is_dtensor(x) and "model" in x.device_mesh.mesh_dim_names


def mlstm_fwd(cfg: ModelConfig, p, x):
    if _sharded(x):
        return _mlstm_fwd_sharded(cfg, p, x)
    if is_dtensor(x) and x.device_mesh.size() == 1:
        return _on_one_rank(mlstm_fwd, cfg, p, x)
    dt = cfg.dtype
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, zg, logi, logf = _mlstm_proj(cfg, p, z)
    o = _mlstm_parallel(q, k, v, logi, logf)
    b, s = o.shape[:2]
    o = o.to(dt) * F.silu(zg).reshape(b, s, cfg.n_heads, -1)
    return x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


def mlstm_step(cfg: ModelConfig, p, state, x):
    """x (B,d) one token; recurrent O(1) update of ``C, n, m``."""
    if is_dtensor(x):
        return _mlstm_step_sharded(cfg, p, state, x)
    dt = cfg.dtype
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, zg, logi, logf = _mlstm_proj(cfg, p, z)
    q, k, v = q.float(), k.float(), v.float()
    dh = q.shape[-1]
    m_new = torch.maximum(logf + state["m"], logi)
    fp = (logf + state["m"] - m_new).exp()[..., None]
    ip = (logi - m_new).exp()[..., None]
    n = fp * state["n"] + ip * k
    C = (fp[..., None] * state["C"]
         + ip[..., None] * v[..., :, None] * k[..., None, :])
    denom = torch.maximum((n * q).sum(-1).abs(), (-m_new).exp())
    o = torch.einsum("bhvk,bhk->bhv", C, q / (dh ** 0.5)) / denom[..., None]
    g = F.silu(zg).float()
    o = o * g.reshape(g.shape[0], cfg.n_heads, -1)
    y = x + torch.einsum("bhk,hkd->bd", o.to(dt), p["wo"].to(dt))
    return dict(C=C, n=n, m=m_new), y


# ---------------------------------------------------------------------------
# sLSTM block


def init_slstm(cfg: ModelConfig, gen: torch.Generator, scale: float,
               lead: tuple = ()):
    d = cfg.d_model
    d_in, h, dh = _sdims(cfg)
    return dict(
        norm=torch.ones((*lead, d), dtype=torch.float32, device=gen.device),
        wx=cm._normal(gen, (*lead, d, 4, d_in), scale),
        # recurrent mixing is block-diagonal per head
        rh=cm._normal(gen, (*lead, h, dh, 4, dh), scale),
        b=cm._zeros(gen, (*lead, 4, d_in)),
        wo=cm._normal(gen, (*lead, d_in, d), scale),
    )


def slstm_specs(cfg: ModelConfig):
    return dict(norm=(None,), wx=("fsdp", None, "state"),
                rh=("heads", None, None, "state"), b=(None, "state"),
                wo=("state", "fsdp"))


def _slstm_cell(cfg: ModelConfig, rh, bias, state, xt):
    """xt (B, 4, d_in) precomputed input contributions; ``rh`` and
    ``bias`` the block's recurrent weights and bias in fp32."""
    _, h_heads, dh = _sdims(cfg)
    b = xt.shape[0]
    hprev = state["h"].reshape(b, h_heads, dh)
    rec = torch.einsum("bhk,hkgl->bhgl", hprev, rh).reshape(b, 4, -1)
    za, ia, fa, oa = (xt + rec + bias).unbind(1)
    z = torch.tanh(za)
    o = torch.sigmoid(oa)
    logi, logf = ia, F.logsigmoid(fa)
    m_new = torch.maximum(logf + state["m"], logi)
    fp = (logf + state["m"] - m_new).exp()
    ip = (logi - m_new).exp()
    c = fp * state["c"] + ip * z
    n = fp * state["n"] + ip
    hnew = o * c / torch.clamp_min(n, 1.0)
    return dict(c=c, n=n, h=hnew, m=m_new), hnew


def _slstm_state(cfg: ModelConfig, lead: tuple, device=None):
    d_in = _sdims(cfg)[0]

    def full(v):
        return torch.full(lead + (d_in,), v, dtype=torch.float32,
                          device=device)
    return dict(c=full(0.0), n=full(0.0), h=full(0.0), m=full(M_INIT))


def _slstm_fwd_sharded(cfg: ModelConfig, p, x):
    """`slstm_fwd` per rank: each step's recurrent product on each model
    rank's share of every gate's width (the recurrent weights' ``state``
    split of each head) with the previous h whole (gathered every step),
    the gating on the share.  The width's split follows the reference's
    reshape of the (heads, 4, dh) recurrent product into 4 gates of the
    width, which is the gates' own layout where there are 4 heads.
    Around the loop the plan follows the rows as the mLSTM's before it
    does (`common._rows_whole` of its chunk): where they lie within one
    chunk, the input projection runs on each model rank's rows (w_x
    gathered whole) and is moved by one all-to-all to the share, and the
    output projection on the rank's rows of the gathered h, the rows
    gathered back; past one chunk both run on the whole rows on the
    share, w_x's and w_o's ``state`` blocks moved to it by one all-to-all
    each (`parallel.axes.regather`), the output's partial sums
    reduced."""
    b, s, _ = x.shape
    d_in, h, dh = _sdims(cfg)
    if h != 4:
        raise NotImplementedError(
            f"{cfg.name}: the partitioned sLSTM needs 4 heads (the 4 "
            f"gates), not {h}")
    mesh = x.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    r, nm = mesh.get_local_rank(mi), mesh.size(mi)
    dh_share = even_share(dh, nm, f"{cfg.name}: the sLSTM's head width")
    whole_rows = _rows_whole(cfg, s, nm)
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)

    def ranges(q):                       # rank q's share of each head
        return [(i * dh + q * dh_share, i * dh + (q + 1) * dh_share)
                for i in range(h)]

    def weight_grad(w):                  # read by each rank's batch rows
        return [Partial() if isinstance(a, Shard) else q
                for q, a in zip(w.placements, x.placements)]

    if whole_rows:
        wx = gather_fsdp(p["wx"].float(), ("fsdp", None, "state"))
        wx = regather(wx, "model", ranges, grad_placements=weight_grad(wx))
        zf = z.float()
        zl = zf.to_local(grad_placements=cm.partial_over_model(zf))
        xg5 = torch.einsum("bsd,dgk->sbgk", zl, wx).unflatten(
            -1, (h, dh_share))                       # (S,B,4,H,dh/M)
    else:
        share = even_share(s, nm, f"{cfg.name}: the sLSTM's rows")
        zr = along(z.float(), "model", Shard(1))
        xg = einsum("bsd,dgk->sbgk", zr, along(gather_fsdp(
            p["wx"].float(), ("fsdp", None, "state")), "model",
            Replicate()))
        xl = xg.to_local(grad_placements=xg.placements)
        xg5 = DTensor.from_local(xl.reshape(*xl.shape[:3], h, dh), mesh,
                                 xg.placements, run_check=False)
        xg5 = along(xg5, "model", Shard(4))
        xg5 = xg5.to_local(grad_placements=xg5.placements)
    rh = cm.local_for(p["rh"].float(), x)                # (H,dh,4,dh/M)
    bias = along(along(p["b"].float(), "model", Replicate()).reshape(
        4, h, dh), "model", Shard(2))
    bias = cm.local_for(bias, x)
    lead = (xg5.shape[1], h, dh_share)
    state = {k: torch.full(lead, v, dtype=torch.float32, device=xg5.device)
             for k, v in dict(c=0.0, n=0.0, m=M_INIT).items()}
    hw = torch.zeros(xg5.shape[1], h, dh, device=xg5.device)

    def step(carry, xt):
        state, hw = carry
        rec = contract("bhk,hkgl->bhgl", hw, rh)
        za, ia, fa, oa = (xt + rec + bias).unbind(1)
        zt, ot = torch.tanh(za), torch.sigmoid(oa)
        logi, logf = ia, F.logsigmoid(fa)
        m_new = torch.maximum(logf + state["m"], logi)
        fp = (logf + state["m"] - m_new).exp()
        ip = (logi - m_new).exp()
        c = fp * state["c"] + ip * zt
        n = fp * state["n"] + ip
        hnew = ot * c / torch.clamp_min(n, 1.0)
        hw = gather_share(hnew, 2, mesh, "model")
        return (dict(c=c, n=n, m=m_new), hw), hnew if whole_rows else hw

    _, hs = cm.scan("slstm", step, (state, hw), xg5)
    if whole_rows:
        hs = torch.stack(hs, 1).flatten(2).to(cfg.dtype)  # (B,S,H*dh/M)
        wo = gather_fsdp(p["wo"].to(cfg.dtype), ("state", "fsdp"))
        wo = regather(wo, "model", ranges, dim=0,
                      grad_placements=weight_grad(wo))
        pl = [Partial() if i == mi else q for i, q in enumerate(x.placements)]
        y = DTensor.from_local(hs @ wo, mesh, pl, run_check=False,
                               shape=x.shape, stride=x.stride())
        return x + reduce_partial(y)
    hs = torch.stack(hs, 1)[:, r * share:(r + 1) * share]
    hs = hs.reshape(*hs.shape[:2], d_in).to(cfg.dtype)
    wo = _whole(p["wo"].to(cfg.dtype), zr)
    y = DTensor.from_local(hs @ wo, mesh, zr.placements, run_check=False)
    y = along(y, "model", Replicate())
    return x + DTensor.from_local(y.to_local(grad_placements=y.placements),
                                  mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())


def slstm_fwd(cfg: ModelConfig, p, x):
    """Sequential over time (inherent to sLSTM).  x (B,S,d)."""
    if _sharded(x):
        return _slstm_fwd_sharded(cfg, p, x)
    if is_dtensor(x) and x.device_mesh.size() == 1:
        return _on_one_rank(slstm_fwd, cfg, p, x)
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = torch.einsum("bsd,dgk->sbgk", z.float(), p["wx"].float())
    rh, bias = p["rh"].float(), p["b"].float()
    state = _slstm_state(cfg, (x.shape[0],), x.device)
    _, hs = cm.scan("slstm", functools.partial(_slstm_cell, cfg, rh, bias),
                    state, xg)
    hs = torch.stack(hs, 1).to(cfg.dtype)                # (B,S,d_in)
    return x + hs @ p["wo"].to(cfg.dtype)


def _slstm_step_sharded(cfg: ModelConfig, p, state, x):
    """`slstm_step` per rank: the input projection on each model rank's
    share of the width (w_x's ``state`` split, as the cache's), the
    recurrent product on the recurrent weights' share with h gathered
    whole, the product gathered and cut to the width's share for the
    gating, the output projection on that share, its partial sums
    reduced."""
    d_in, h, dh = _sdims(cfg)
    mesh = x.device_mesh
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = einsum("bd,dgk->bgk", reduce_grad_partial(z).float(),
                gather_fsdp(p["wx"].float(), ("fsdp", None, "state")))
    hw = along(state["h"], "model", Replicate()).to_local()
    rec = torch.einsum("bhk,hkgl->bhgl", hw.reshape(-1, h, dh),
                       p["rh"].float().to_local())
    pl = [Shard(3) if q == Shard(1) else q for q in state["h"].placements]
    rec = along(DTensor.from_local(rec, mesh, pl, run_check=False),
                "model", Replicate()).to_local()
    rec = DTensor.from_local(rec.reshape(rec.shape[0], 4, -1), mesh,
                             [q if q != Shard(3) else Replicate()
                              for q in pl], run_check=False)
    rec = along(rec, "model", Shard(2)).to_local()
    local = {k: v.to_local() for k, v in state.items()}
    xt = xg.to_local()
    za, ia, fa, oa = (xt + rec + along(p["b"].float(), "model", Shard(1))
                      .to_local()).unbind(1)
    zt, ot = torch.tanh(za), torch.sigmoid(oa)
    logi, logf = ia, F.logsigmoid(fa)
    m_new = torch.maximum(logf + local["m"], logi)
    fp = (logf + local["m"] - m_new).exp()
    ip = (logi - m_new).exp()
    c = fp * local["c"] + ip * zt
    n = fp * local["n"] + ip
    hnew = ot * c / torch.clamp_min(n, 1.0)
    new = {k: DTensor.from_local(v, mesh, state[k].placements,
                                 run_check=False, shape=state[k].shape,
                                 stride=state[k].stride())
           for k, v in dict(c=c, n=n, h=hnew, m=m_new).items()}
    y = reduce_partial(einsum("bk,kd->bd", new["h"].to(cfg.dtype),
                              gather_fsdp(p["wo"].to(cfg.dtype),
                                          ("state", "fsdp")),
                              cm._plain_product))
    return new, x + y


def slstm_step(cfg: ModelConfig, p, state, x):
    if is_dtensor(x):
        return _slstm_step_sharded(cfg, p, state, x)
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = torch.einsum("bd,dgk->bgk", z.float(), p["wx"].float())
    state, h = _slstm_cell(cfg, p["rh"].float(), p["b"].float(), state, xg)
    return state, x + (h.to(cfg.dtype) @ p["wo"].to(cfg.dtype))


# ---------------------------------------------------------------------------
# full model


def init_params(cfg: ModelConfig, gen: torch.Generator):
    n_seg, n_m = _segments(cfg)
    scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    return dict(embed=cm.init_embedding(cfg, gen),
                mlstm=init_mlstm(cfg, gen, scale, (n_seg * n_m,)),
                slstm=init_slstm(cfg, gen, scale, (n_seg,)))


def param_specs(cfg: ModelConfig):
    return dict(embed=cm.embedding_specs(cfg),
                mlstm=tt.stacked_specs(mlstm_specs(cfg)),
                slstm=tt.stacked_specs(slstm_specs(cfg)))


def forward(cfg: ModelConfig, params, tokens):
    n_seg, n_m = _segments(cfg)
    x = cm.embed(cfg, params["embed"], tokens)
    mparams = cm.cast_params(cfg, params["mlstm"])
    for seg in range(n_seg):
        for i in range(seg * n_m, (seg + 1) * n_m):
            lp = tt._layer(mparams, i)
            x = cm.recompute(functools.partial(mlstm_fwd, cfg, lp), lp, x)
        x = slstm_fwd(cfg, tt._layer(params["slstm"], seg), x)
    return cm.logits(cfg, params["embed"], x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int = 0, device=None):
    """Recurrent state, O(1) in sequence length (``max_seq`` unused)."""
    n_seg, n_m = _segments(cfg)
    _, h, dh = _dims(cfg)
    lead = (n_seg * n_m, batch)
    return dict(
        mlstm=dict(C=torch.zeros(lead + (h, dh, dh), device=device),
                   n=torch.zeros(lead + (h, dh), device=device),
                   m=torch.full(lead + (h,), M_INIT, device=device)),
        slstm=_slstm_state(cfg, (n_seg, batch), device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = True):
    return dict(
        mlstm=dict(C=(None, "batch", "heads", "state", None),
                   n=(None, "batch", "heads", None),
                   m=(None, "batch", "heads")),
        slstm=dict(c=(None, "batch", "state"), n=(None, "batch", "state"),
                   h=(None, "batch", "state"), m=(None, "batch", "state")),
        length=(None,))


def batch_axes(cfg: ModelConfig):
    """Each cache leaf's batch axis (see `transformer.batch_axes`)."""
    return dict(mlstm=dict.fromkeys(("C", "n", "m"), 1),
                slstm=dict.fromkeys(("c", "n", "h", "m"), 1), length=0)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens (B,) -> (logits (B,V), cache'), the
    states updated in place."""
    n_seg, n_m = _segments(cfg)
    x = cm.embed(cfg, params["embed"], tokens[:, None])[:, 0]

    def step(fn, p, states, i, x):
        st, x = fn(cfg, tt._layer(p, i), {k: v[i] for k, v in
                                         states.items()}, x)
        for k, v in st.items():
            tt.set_layer(states[k], i, v)
        return x

    for seg in range(n_seg):
        for i in range(seg * n_m, (seg + 1) * n_m):
            x = step(mlstm_step, params["mlstm"], cache["mlstm"], i, x)
        x = step(slstm_step, params["slstm"], cache["slstm"], seg, x)
    out = cm.logits(cfg, params["embed"], x[:, None])[:, 0]
    return out, dict(cache, length=cache["length"] + 1)
