"""Llama-3.2-Vision-style VLM backbone (llama-3.2-vision-11b).

``n_layers`` decoder layers of which every ``cross_attn_every``-th is a
*gated cross-attention* layer over precomputed image patch embeddings
(the vision frontend is a stub, as in the reference).  Per segment:
(cross_attn_every - 1) self-attention blocks, then one gated cross block
(Flamingo-style tanh gates, 0 at init: the identity).

The gates are fp32 scalars.  The reference multiplies them as 0-d
arrays, which JAX promotes like any other array, so in bf16 its residual
stream leaves the first gated block in fp32 and every later layer
computes in fp32; PyTorch treats a 0-d tensor as a scalar, and the port
keeps the stream in ``cfg.dtype`` (the config's compute type).

Serving: self layers keep a KV cache; `fill_cross_cache` computes each
cross layer's image K/V (``xk``, ``xv``) once, and every decode step
reads them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.axes import shard


#: the parameters `decode_step` never reads: the cross blocks' K/V
#: weights (the cache holds their products)
DECODE_UNREAD = ("cross/attn/wk", "cross/attn/wv")


def _segments(cfg: ModelConfig):
    per = cfg.cross_attn_every
    if per < 2 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into segments of {per} (at least 2)")
    return cfg.n_layers // per, per - 1


def init_params(cfg: ModelConfig, gen: torch.Generator):
    n_seg, n_self = _segments(cfg)
    cross = tt.init_block(cfg, gen, (n_seg,))
    cross["gate_attn"] = cm._zeros(gen, (n_seg,))
    cross["gate_mlp"] = cm._zeros(gen, (n_seg,))
    return dict(embed=cm.init_embedding(cfg, gen),
                layers=tt.init_block(cfg, gen, (n_seg * n_self,)),
                cross=cross)


def param_specs(cfg: ModelConfig):
    cross = dict(tt.block_specs(cfg), gate_attn=(), gate_mlp=())
    return dict(embed=cm.embedding_specs(cfg),
                layers=tt.stacked_specs(tt.block_specs(cfg)),
                cross=tt.stacked_specs(cross))


def _cross_apply(cfg: ModelConfig, p, x, attend):
    """Gated cross-attention block; ``attend(q)`` the attention over the
    image K/V.  A residual whose rows the self blocks leave split over
    ``model`` (``REPRO_SP_RESIDUAL``) keeps them split: each norm on the
    rank's rows, the normed rows gathered for the query projection and
    the FFN, and the rank's rows of their outputs added, as
    `transformer.block_fwd` runs it."""
    rows = cm._rows_split(x)

    def whole(t):
        return shard(t, "batch", None, None) if rows else t

    def back(t):
        return shard(t, "batch", "seq", None) if rows else t

    h = whole(cm.rmsnorm(x, p["norm1"], cfg.norm_eps))
    o = attend(shard(cm.cross_q(cfg, p["attn"], h), "batch", None, "heads",
                     None))
    x = x + torch.tanh(p["gate_attn"]) * back(cm.attn_out(cfg, p["attn"], o))
    h = whole(cm.rmsnorm(x, p["norm2"], cfg.norm_eps))
    return x + torch.tanh(p["gate_mlp"]) * back(cm.mlp(cfg, p["mlp"], h))


def forward(cfg: ModelConfig, params, tokens, ctx):
    """tokens (B,S); ctx (B, n_ctx, d) precomputed patch embeddings."""
    n_seg, n_self = _segments(cfg)
    x = cm.embed(cfg, params["embed"], tokens)
    ctx = shard(ctx.to(cfg.dtype), "batch", None, None)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    layers = cm.cast_params(cfg, params["layers"])
    for seg in range(n_seg):
        for i in range(seg * n_self, (seg + 1) * n_self):
            lp = tt._layer(layers, i)
            x = cm.recompute(functools.partial(
                tt.block_fwd, cfg, lp, positions=positions), lp, x)
        pc = tt._layer(params["cross"], seg)
        x = _cross_apply(cfg, pc, x, functools.partial(
            cm.cross_attention, cfg, pc["attn"], ctx=ctx))
    return cm.logits(cfg, params["embed"], x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    n_seg, n_self = _segments(cfg)
    shape = (n_seg * n_self, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    xshape = (n_seg, batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)
    return dict(k=zeros(shape), v=zeros(shape), xk=zeros(xshape),
                xv=zeros(xshape),
                length=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = True):
    kv = (None, "batch", "kv_seq" if shard_seq else None, "kv_heads", None)
    return dict(k=kv, v=kv, xk=kv, xv=kv, length=(None,))


def batch_axes(cfg: ModelConfig):
    """Each cache leaf's batch axis (see `transformer.batch_axes`);
    ``None`` for ``xk``/``xv``: filled once by `fill_cross_cache`, kept
    across admissions."""
    return dict(tt.batch_axes(cfg), xk=None, xv=None)


def fill_cross_cache(cfg: ModelConfig, params, cache, ctx):
    """Write each segment's image K/V into ``xk``/``xv`` in place;
    returns the cache."""
    ctx = ctx.to(cfg.dtype)
    for seg in range(_segments(cfg)[0]):
        k, v = cm.cross_kv(cfg, tt._layer(params["cross"], seg)["attn"], ctx)
        cache["xk"][seg] = k
        cache["xv"][seg] = v
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens (B,) -> (logits (B,V), cache'); K/V
    updated in place, ``xk``/``xv`` read only."""
    n_seg, n_self = _segments(cfg)
    x = cm.embed(cfg, params["embed"], tokens[:, None])
    lengths = cache["length"]
    for seg in range(n_seg):
        for i in range(seg * n_self, (seg + 1) * n_self):
            kv = dict(k=cache["k"][i], v=cache["v"][i])
            _, x = tt.decode_block(cfg, tt._layer(params["layers"], i), kv,
                                   x, lengths)
        x = _cross_apply(cfg, tt._layer(params["cross"], seg), x,
                         functools.partial(cm.attention, cfg,
                                           k=cache["xk"][seg],
                                           v=cache["xv"][seg], causal=False))
    out = cm.logits(cfg, params["embed"], x)[:, 0]
    return out, dict(cache, length=lengths + 1)
