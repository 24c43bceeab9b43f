"""Whisper-large-v3-style encoder-decoder backbone (audio).

The conv frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, n_frames, d), which the encoder reads
directly.  Encoder: bidirectional self-attention blocks with the GELU
FFN.  Decoder: causal self-attention + cross-attention over the encoder
states + GELU FFN, every layer.

Serving: `fill_cross_cache` encodes the frames once and stores every
decoder layer's cross K/V (``xk``, ``xv``); `decode_step` then runs the
self-attention over its KV cache and the cross-attention over them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.axes import shard


#: the parameters `decode_step` never reads: the encoder, and every
#: decoder layer's cross K/V weights (the cache holds their products)
DECODE_UNREAD = ("enc", "enc_norm", "dec/xattn/wk", "dec/xattn/wv")


def _gelu_mlp(cfg: ModelConfig):
    return functools.partial(cm.init_mlp, cfg, kind="gelu")


def init_params(cfg: ModelConfig, gen: torch.Generator):
    scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    lead = (cfg.n_layers,)
    ones = torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                      device=gen.device)
    return dict(
        embed=cm.init_embedding(cfg, gen),
        enc=tt.init_block(cfg, gen, (cfg.n_encoder_layers,), _gelu_mlp(cfg)),
        enc_norm=ones[0].clone(),
        dec=dict(norm1=ones, attn=cm.init_attn(cfg, gen, scale, lead),
                 norm_x=ones.clone(),
                 xattn=cm.init_attn(cfg, gen, scale, lead),
                 norm2=ones.clone(),
                 mlp=_gelu_mlp(cfg)(gen, scale, lead)),
    )


def param_specs(cfg: ModelConfig):
    dec = dict(norm1=(None,), attn=cm.attn_specs(cfg), norm_x=(None,),
               xattn=cm.attn_specs(cfg), norm2=(None,),
               mlp=cm.mlp_specs("gelu"))
    return dict(embed=cm.embedding_specs(cfg),
                enc=tt.stacked_specs(tt.block_specs(cfg,
                                                    cm.mlp_specs("gelu"))),
                enc_norm=(None,),
                dec=tt.stacked_specs(dec))


def encode(cfg: ModelConfig, params, frames):
    """frames (B, T_enc, d) stub embeddings -> encoder states."""
    x = shard(frames.to(cfg.dtype), "batch", None, None)
    positions = torch.arange(frames.shape[1], device=x.device)[None, :]
    enc = cm.cast_params(cfg, params["enc"])
    for i in range(cfg.n_encoder_layers):
        lp = tt._layer(enc, i)
        x = cm.recompute(functools.partial(_enc_block, cfg, lp, positions),
                         lp, x)
    return cm.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _enc_block(cfg: ModelConfig, lp, positions, x):
    h = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    x = x + cm.self_attention(cfg, lp["attn"], h, positions, causal=False)
    h = cm.rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return shard(x + cm.mlp(cfg, lp["mlp"], h, kind="gelu"),
                 "batch", None, None)


def _cross(cfg: ModelConfig, lp, x, attend):
    """The decoder block's cross-attention sub-layer, residual added;
    ``attend(q)`` the attention over the encoder states' K/V."""
    h = cm.rmsnorm(x, lp["norm_x"], cfg.norm_eps)
    o = attend(cm.cross_q(cfg, lp["xattn"], h))
    return cm.add_attn_out(cfg, lp["xattn"], x, o)


def forward(cfg: ModelConfig, params, tokens, frames):
    """Teacher-forced: tokens (B,S) + frames (B,T_enc,d) -> logits."""
    enc = encode(cfg, params, frames)
    x = cm.embed(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    dec = cm.cast_params(cfg, params["dec"])
    for i in range(cfg.n_layers):
        lp = tt._layer(dec, i)
        x = cm.recompute(functools.partial(_dec_block, cfg, lp, positions),
                         lp, x, enc)
    return cm.logits(cfg, params["embed"], x)


def _dec_block(cfg: ModelConfig, lp, positions, x, enc):
    """A decoder block over the encoder states ``enc`` (teacher-forced).
    With heads too few to split the ``model`` axis (the sequence-parallel
    attention) over rows of one attention chunk, the residual's rows
    split over ``model`` from the block's start to its FFN, which gathers
    them: the reference pins nothing between the residual and the cross
    query's chunked attention (its ``seq`` pin), so its partitioner
    carries that split back onto the residual (`common.add_attn_out`
    then projects each rank's rows)."""
    if not cm.heads_tp_available(cfg.n_heads) and \
            not cm._rows_whole(x.shape[1]):
        x = shard(x, "batch", "seq", None)
    h = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv(cfg, lp["attn"], h, positions)
    x = cm.add_attn_out(cfg, lp["attn"], x,
                        cm.attention(cfg, q, k, v, causal=True))
    x = _cross(cfg, lp, x, functools.partial(
        cm.cross_attention, cfg, lp["xattn"], ctx=enc))
    h = shard(cm.rmsnorm(x, lp["norm2"], cfg.norm_eps), "batch", None, None)
    return shard(x + cm.mlp(cfg, lp["mlp"], h, kind="gelu"),
                 "batch", None, None)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    cache = tt.init_cache(cfg, batch, max_seq, device=device)
    xshape = (cfg.n_layers, batch, cfg.n_ctx_tokens, cfg.n_kv_heads,
              cfg.head_dim)
    cache["xk"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
    cache["xv"] = torch.zeros(xshape, dtype=cfg.dtype, device=device)
    return cache


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = True):
    kv = (None, "batch", "kv_seq" if shard_seq else None, "kv_heads", None)
    return dict(k=kv, v=kv, xk=kv, xv=kv, length=(None,))


def batch_axes(cfg: ModelConfig):
    """Each cache leaf's batch axis (see `transformer.batch_axes`);
    ``None`` for ``xk``/``xv``: filled once by `fill_cross_cache`, kept
    across admissions."""
    return dict(tt.batch_axes(cfg), xk=None, xv=None)


def fill_cross_cache(cfg: ModelConfig, params, cache, frames):
    """Encode ``frames`` and write every decoder layer's cross K/V into
    the cache's ``xk``/``xv`` in place; returns the cache."""
    enc = encode(cfg, params, frames)
    for i in range(cfg.n_layers):
        ek, ev = cm.cross_kv(cfg, tt._layer(params["dec"], i)["xattn"], enc)
        cache["xk"][i] = ek
        cache["xv"][i] = ev
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens (B,) -> (logits (B,V), cache'); K/V
    updated in place, ``xk``/``xv`` read only."""
    x = cm.embed(cfg, params["embed"], tokens[:, None])
    lengths = cache["length"]
    for i in range(cfg.n_layers):
        lp = tt._layer(params["dec"], i)
        x = tt.decode_attn(cfg, lp, dict(k=cache["k"][i], v=cache["v"][i]),
                           x, lengths)
        x = _cross(cfg, lp, x, functools.partial(
            cm.attention, cfg, k=cache["xk"][i], v=cache["xv"][i],
            causal=False))
        h = cm.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        x = x + cm.mlp(cfg, lp["mlp"], h, kind="gelu")
    out = cm.logits(cfg, params["embed"], x)[:, 0]
    return out, dict(cache, length=lengths + 1)
