"""Decoder-only GQA transformer (tinyllama / minitron / qwen2 / deepseek
families) and the block machinery the MoE, VLM, audio and hybrid
families reuse.

Layers are stacked along a leading L axis, as in the reference, and a
Python loop over that axis takes the place of ``lax.scan``; each block
runs under `common.recompute` (the reference's ``jax.checkpoint``).  The KV
cache keeps the reference's layout ``k, v: (L, B, T, Hkv, D)`` plus
``length: (B,)`` int32.  ``mlp_init`` / ``mlp_fn`` swap the FFN (the
MoE family's experts), as the reference's hooks do.
"""
from __future__ import annotations

import functools
import os

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.axes import is_dtensor, shard


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked param tree (views, no copy)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def set_layer(stack, i: int, value):
    """``stack[i] = value`` in place; on DTensors each rank writes its
    local shard (``value`` laid out as ``stack[i]``)."""
    if is_dtensor(stack):
        stack.to_local()[i] = value.to_local().to(stack.dtype)
    else:
        stack[i] = value


# ---------------------------------------------------------------------------
# params


def init_block(cfg: ModelConfig, gen: torch.Generator, lead: tuple = (),
               mlp_init=None):
    """One decoder block's weights, with ``lead`` stacking axes in front.
    ``mlp_init(gen, scale, lead)`` draws the FFN (default: SwiGLU)."""
    scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    mlp_init = mlp_init or functools.partial(cm.init_mlp, cfg)
    ones = torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                      device=gen.device)
    return dict(norm1=ones, attn=cm.init_attn(cfg, gen, scale, lead),
                norm2=ones.clone(), mlp=mlp_init(gen, scale, lead))


def block_specs(cfg: ModelConfig, mlp_spec=None):
    """Spec tree of one block; `stacked_specs` adds the layer axis."""
    return dict(norm1=(None,), attn=cm.attn_specs(cfg), norm2=(None,),
                mlp=mlp_spec or cm.mlp_specs())


def stacked_specs(spec_tree):
    """Prepend the (unsharded) layer axis to every leaf of a spec tree."""
    if isinstance(spec_tree, dict):
        return {k: stacked_specs(v) for k, v in spec_tree.items()}
    return (None,) + spec_tree


def init_params(cfg: ModelConfig, gen: torch.Generator, mlp_init=None):
    """Random weights with the reference's shapes and scales, drawn from
    ``gen`` on its device (not the reference's bits: parity tests carry
    the reference's weights across with `registry.params_from_numpy`)."""
    return dict(embed=cm.init_embedding(cfg, gen),
                layers=init_block(cfg, gen, (cfg.n_layers,), mlp_init))


def param_specs(cfg: ModelConfig, mlp_spec=None):
    """Logical axis names of every parameter (``mlp_spec``: the MoE
    family's experts in place of the SwiGLU)."""
    return dict(embed=cm.embedding_specs(cfg),
                layers=stacked_specs(block_specs(cfg, mlp_spec)))


# ---------------------------------------------------------------------------
# forward (prefill)


def _mlp_fn(cfg: ModelConfig, mlp_fn):
    return mlp_fn or functools.partial(cm.mlp, cfg)


def residual_spec() -> tuple:
    """The logical names `block_fwd` pins its output (the residual) to:
    ``("batch", "seq", None)`` where ``REPRO_SP_RESIDUAL`` is set
    non-empty (Megatron-style sequence parallelism: the residual's rows
    split over ``model``, the norms on each rank's rows), else
    ``("batch", None, None)``; the reference's ``_residual_spec``, an A/B
    knob read at each call."""
    if os.environ.get("REPRO_SP_RESIDUAL"):
        return ("batch", "seq", None)
    return ("batch", None, None)


def block_fwd(cfg: ModelConfig, p, x, positions, mlp_fn=None):
    spec = residual_spec()
    if spec[1] == "seq" and is_dtensor(x):
        return _block_fwd_seq(cfg, p, x, positions, mlp_fn)
    h = cm.rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + cm.self_attention(cfg, p["attn"], h, positions)
    h = cm.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return shard(x + _mlp_fn(cfg, mlp_fn)(p["mlp"], h), *spec)


def _block_fwd_seq(cfg: ModelConfig, p, x, positions, mlp_fn=None):
    """`block_fwd` under ``REPRO_SP_RESIDUAL`` on DTensors: the residual's
    rows split over ``seq`` (the ``model`` axis) through the block, each
    norm on the rank's rows; the attention and the FFN, which read whole
    rows, take the normed rows all-gathered over ``model`` (one gather
    before each; GQA's K/V projections on the rank's rows,
    `common.attn_qkv`), run as without the knob (their partial sums
    all-reduced), and the rank keeps its rows of each output, a local
    slice, before the residual add.  The backward: each gather's, a
    slice of the normed rows' gradient (all-reduced where the
    projections leave partial sums); each slice's, an all-gather of the
    rows' gradient."""
    rows = ("batch", "seq", None)
    whole = ("batch", None, None)
    x = shard(x, *rows)
    h = cm.rmsnorm(x, p["norm1"], cfg.norm_eps)      # gathered in attn_qkv
    x = x + shard(cm.self_attention(cfg, p["attn"], h, positions), *rows)
    h = shard(cm.rmsnorm(x, p["norm2"], cfg.norm_eps), *whole)
    return x + shard(_mlp_fn(cfg, mlp_fn)(p["mlp"], h), *rows)


def remat_policy() -> str:
    """The layer loop's recompute policy: ``"dots"`` where
    ``REPRO_REMAT_POLICY`` is ``dots`` (save the products without batch
    dims), else ``"full"``; the reference's ``_remat``, an A/B knob read
    at each `forward` call.  Only this family's loop reads it, as in the
    reference."""
    return "dots" if os.environ.get("REPRO_REMAT_POLICY") == "dots" \
        else "full"


def forward(cfg: ModelConfig, params, tokens, mlp_fn=None):
    """tokens (B, S) -> logits (B, S, V).

    The layer weights are cast to the compute dtype before the layer
    loop, norm weights included, as the reference does.
    """
    x = cm.embed(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    layers = cm.cast_params(cfg, params["layers"])
    policy = remat_policy()
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = cm.recompute(functools.partial(
            block_fwd, cfg, lp, positions=positions, mlp_fn=mlp_fn), lp, x,
            policy=policy)
    return cm.logits(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# KV cache serving


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dt, device=device),
                v=torch.zeros(shape, dtype=dt, device=device),
                length=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))


def cache_specs(cfg: ModelConfig, *, shard_seq: bool = True):
    """KV sharded (batch, seq, kv-heads) by the dedup rules: the seq dim
    takes whatever mesh axes the batch dim leaves free."""
    kv = (None, "batch", "kv_seq" if shard_seq else None, "kv_heads", None)
    return dict(k=kv, v=kv, length=(None,))


def batch_axes(cfg: ModelConfig):
    """Each cache leaf's batch axis, along which `serve.engine` resets a
    slot (``None``: a leaf the slot keeps, see `vlm.batch_axes`)."""
    return dict(k=1, v=1, length=0)


def attention_over_cache(cfg: ModelConfig, q, ck, cv, lengths):
    """Decode attention: q (B,Sq,Hq,D) over cache (B,T,Hkv,D).

    Grouped GQA (no repeated KV), fp32 softmax over the first
    ``lengths[b]`` cache rows of each sequence.  On DTensors it runs per
    rank (`_attention_over_cache_by_rank`).
    """
    if is_dtensor(ck):
        return _attention_over_cache_by_rank(cfg, q, ck, cv, lengths)
    b, sq, hq, d = q.shape
    t, hkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhgd,bthd->bqhgt", qg.float(), ck.float()) * scale
    if cfg.attn_logit_softcap > 0.0:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bqhgt,bthd->bqhgd", p, cv.float())
    o = o / p.sum(-1)[..., None]
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _attention_over_cache_by_rank(cfg: ModelConfig, q, ck, cv, lengths):
    """`attention_over_cache` on DTensors, each rank on its shards, as
    the reference's partitioner runs it (flash-decoding split-KV): q
    (one token) is brought to the cache's layout, split where its batch
    and heads are and whole over the dims that split the cache's
    sequence; each rank scores its slice of the rows, and the softmax's
    max, denominator and weighted sum are all-reduced over those dims
    (two all-reduces of partial sums after one of partial maxima)."""
    mesh, cpl = ck.device_mesh, list(ck.placements)
    seq = [i for i, p in enumerate(cpl) if p == Shard(1)]
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cpl]
    ql = q.redistribute(mesh, q_pl).to_local()
    lens = lengths.redistribute(mesh, [
        p if p == Shard(0) else Replicate() for p in cpl]).to_local()
    _, offset = compute_local_shape_and_global_offset(ck.shape, mesh, cpl)
    kl, vl = ck.to_local(), cv.to_local()
    b, sq, hq, d = ql.shape
    t, hkv = kl.shape[1], kl.shape[2]
    qg = ql.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bthd->bqhgt", qg.float(), kl.float()) \
        * (1.0 / (d ** 0.5))
    if cfg.attn_logit_softcap > 0.0:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    rows = offset[1] + torch.arange(t, device=kl.device)
    valid = (rows[None, :] < lens[:, None])[:, None, None, None, :]
    s = torch.where(valid, s, float("-inf"))

    def reduce(x, op):
        out = [Partial(op) if i in seq else p for i, p in enumerate(q_pl)]
        return DTensor.from_local(x, mesh, out, run_check=False).redistribute(
            mesh, q_pl).to_local()

    m = reduce(s.amax(-1, keepdim=True), "max")
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    o = reduce(torch.einsum("bqhgt,bthd->bqhgd", p, vl.float()), "sum")
    o = o / reduce(p.sum(-1), "sum")[..., None]
    return DTensor.from_local(o.reshape(b, sq, hq, d).to(ql.dtype), mesh,
                              q_pl, run_check=False)


def write_at(cache, new, lengths):
    """Write ``new`` (B,1,Hkv,D) into ``cache`` (B,T,Hkv,D) in place at
    row ``lengths[b]`` of each sequence.  Like the reference's
    ``dynamic_update_slice``, the row is clamped to ``[0, T-1]``: a full
    sequence overwrites its last row instead of raising."""
    if is_dtensor(cache):
        return _write_at_local(cache, new, lengths)
    rows = lengths.long().clamp(0, cache.shape[1] - 1)
    cache[torch.arange(cache.shape[0], device=cache.device), rows] = (
        new[:, 0].to(cache.dtype))


def _write_at_local(cache, new, lengths):
    """`write_at` on a DTensor cache, each rank on its shard, as the
    reference's partitioner runs a ``dynamic_update_slice`` into a
    sharded dim: ``new`` and ``lengths`` are brought to the cache's
    layout on the dims they share, and each rank writes the rows that
    fall in its slice of T (the others keep their values).  On a mesh
    of one device this is `write_at`'s write."""
    mesh, pl = cache.device_mesh, list(cache.placements)
    new_l = new.redistribute(mesh, [
        Replicate() if pl_i == Shard(1) else pl_i for pl_i in pl]).to_local()
    len_l = lengths.redistribute(mesh, [
        pl_i if pl_i == Shard(0) else Replicate() for pl_i in pl]).to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    local = cache.to_local()
    t = local.shape[1]
    rows = len_l.long().clamp(0, cache.shape[1] - 1) - offset[1]
    inside = ((rows >= 0) & (rows < t))[:, None, None]
    rows = rows.clamp(0, t - 1)
    b = torch.arange(local.shape[0], device=local.device)
    local[b, rows] = torch.where(inside, new_l[:, 0].to(local.dtype),
                                 local[b, rows])


def decode_attn(cfg: ModelConfig, p, kv, x, lengths):
    """A block's self-attention for one new token, residual added.
    x (B,1,d); kv dict of (B,T,Hkv,D) views: the token's K/V are
    written in place at ``lengths``."""
    h = cm.rmsnorm(x, p["norm1"], cfg.norm_eps)
    q, k_new, v_new = cm.attn_qkv(cfg, p["attn"], h, lengths[:, None])
    write_at(kv["k"], k_new, lengths)
    write_at(kv["v"], v_new, lengths)
    # pin the cache's layout, as the reference does: left free, the
    # head-sharded attention output's layout would propagate into it
    kv = {n: shard(c, "batch", "kv_seq", "kv_heads", None)
          for n, c in kv.items()}
    o = attention_over_cache(cfg, q, kv["k"], kv["v"], lengths + 1)
    return x + cm.attn_out(cfg, p["attn"], o)


def decode_block(cfg: ModelConfig, p, kv, x, lengths, mlp_fn=None):
    """One block, one new token.  x (B,1,d); kv dict of (B,T,Hkv,D)
    views, updated in place."""
    x = decode_attn(cfg, p, kv, x, lengths)
    h = cm.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return kv, x + _mlp_fn(cfg, mlp_fn)(p["mlp"], h)


def decode_step(cfg: ModelConfig, params, cache, tokens, mlp_fn=None):
    """One decode step.  tokens (B,) -> (logits (B,V), cache').

    The cache's K/V tensors are updated in place and returned in the new
    cache dict together with ``length + 1``.
    """
    x = cm.embed(cfg, params["embed"], tokens[:, None])
    lengths = cache["length"]
    for i in range(cfg.n_layers):
        kv = dict(k=cache["k"][i], v=cache["v"][i])
        _, x = decode_block(cfg, _layer(params["layers"], i), kv, x,
                            lengths, mlp_fn)
    out = cm.logits(cfg, params["embed"], x)[:, 0]
    return out, dict(k=cache["k"], v=cache["v"], length=lengths + 1)


def prefill(cfg: ModelConfig, params, tokens, max_seq: int | None = None,
            mlp_fn=None):
    """Prefill: forward + populate a KV cache.  tokens (B, S)."""
    b, s = tokens.shape
    t = max_seq or s
    x = cm.embed(cfg, params["embed"], tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, t, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = cm.attn_qkv(cfg, lp["attn"], h, positions)
        o = cm.attention(cfg, q, k, v, causal=True)
        x = x + cm.attn_out(cfg, lp["attn"], o)
        h = cm.rmsnorm(x, lp["norm2"], cfg.norm_eps)
        x = shard(x + _mlp_fn(cfg, mlp_fn)(lp["mlp"], h),
                  "batch", None, None)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["length"].fill_(s)
    return cm.logits(cfg, params["embed"], x), cache
