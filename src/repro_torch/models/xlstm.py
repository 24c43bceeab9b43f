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

sLSTM (scalar memory, recurrent gating) is sequential: a Python loop over
time takes the place of the reference's ``lax.scan``, one small group of
kernels per token.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig

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
    vb = v.to(cm.PROBS_DTYPE).float()
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
                           sd.to(cm.PROBS_DTYPE).float(), vb)
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


def mlstm_fwd(cfg: ModelConfig, p, x):
    dt = cfg.dtype
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, zg, logi, logf = _mlstm_proj(cfg, p, z)
    o = _mlstm_parallel(q, k, v, logi, logf)
    b, s = o.shape[:2]
    o = o.to(dt) * F.silu(zg).reshape(b, s, cfg.n_heads, -1)
    return x + torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


def mlstm_step(cfg: ModelConfig, p, state, x):
    """x (B,d) one token; recurrent O(1) update of ``C, n, m``."""
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


def slstm_fwd(cfg: ModelConfig, p, x):
    """Sequential over time (inherent to sLSTM).  x (B,S,d)."""
    b, s, _ = x.shape
    z = cm.rmsnorm(x, p["norm"], cfg.norm_eps)
    xg = torch.einsum("bsd,dgk->sbgk", z.float(), p["wx"].float())
    rh, bias = p["rh"].float(), p["b"].float()
    state = _slstm_state(cfg, (b,), x.device)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(cfg, rh, bias, state, xg[t])
        hs.append(h)
    hs = torch.stack(hs, 1).to(cfg.dtype)                # (B,S,d_in)
    return x + hs @ p["wo"].to(cfg.dtype)


def slstm_step(cfg: ModelConfig, p, state, x):
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
            states[k][i] = v
        return x

    for seg in range(n_seg):
        for i in range(seg * n_m, (seg + 1) * n_m):
            x = step(mlstm_step, params["mlstm"], cache["mlstm"], i, x)
        x = step(slstm_step, params["slstm"], cache["slstm"], seg, x)
    out = cm.logits(cfg, params["embed"], x[:, None])[:, 0]
    return out, dict(cache, length=cache["length"] + 1)
