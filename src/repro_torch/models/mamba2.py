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
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig


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


def _ssd_scan(cfg: ModelConfig, xh, dt, a, bmat, cmat):
    """SSD chunked scan.

    xh   (B,S,H,P)  inputs per head
    dt   (B,S,H)    positive step sizes
    a    (H,)       negative decay rates
    bmat (B,S,N), cmat (B,S,N)  shared across heads (n_groups=1)
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
    cb = torch.einsum("bkin,bkjn->bkij", c_c, b_c)       # (B,nc,q,q)
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


def mamba_fwd(cfg: ModelConfig, p, x):
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


def mamba_step(cfg: ModelConfig, p, state, x):
    """One-token recurrent update.  x (B, d); state ``h`` (B,H,N,P) and
    ``conv`` (B,k-1,conv_dim), fp32.  Returns (new state, x')."""
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


def _shared_apply(cfg: ModelConfig, p, x, x0, positions):
    u = torch.cat([x, x0], dim=-1) @ p["w_cat"].to(cfg.dtype)
    return x + tt.block_fwd(cfg, p["block"], u, positions) - u  # on x


def forward(cfg: ModelConfig, params, tokens):
    x = cm.embed(cfg, params["embed"], tokens)
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
            states[k][i] = v
        if cfg.family == "hybrid" and (i + 1) % per == 0:
            p_sh = params["shared"]
            u = (torch.cat([x, x0], dim=-1)
                 @ p_sh["w_cat"].to(cfg.dtype))[:, None, :]
            kv = {k: v[i // per] for k, v in cache["shared_kv"].items()}
            _, u_out = tt.decode_block(cfg, p_sh["block"], kv, u, lengths)
            x = x + u_out[:, 0] - u[:, 0]
    out = cm.logits(cfg, params["embed"], x[:, None])[:, 0]
    return out, dict(cache, length=lengths + 1)
