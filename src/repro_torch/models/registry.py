"""Family dispatch: one model API over all six families.

    api = get_model(cfg)
    params = api.init(seed, device=None)          # the card unless asked
    logits = api.forward(params, batch)           # batch dict, see below
    cache  = api.init_cache(batch_size, max_seq, device=None)
    cache  = api.fill_ctx(params, cache, ctx)     # vlm and audio only
    logits, cache = api.decode(params, cache, tokens)

Batch dict keys: ``tokens`` always; ``ctx`` for vlm (patch embeddings)
and audio (frame embeddings), (B, n_ctx_tokens, d_model).
``api.batch_axes()`` gives each cache leaf's batch axis (the engine
resets a slot along it), ``None`` for the cross K/V a slot keeps.
``api.init(seed, device="meta")`` gives the parameter tree's shapes
without allocating it (`count_params` of a full config).
``api.decode_unread`` names the parameter subtrees ``decode`` never
reads (the context families' encoder and cross K/V weights: the cache
holds their products).
``api.param_specs()`` / ``api.cache_specs(shard_seq=True)`` give the
logical axis names of every parameter and cache leaf, one tuple per
leaf, one name per dim (`parallel.axes` resolves them on a mesh).

`params_from_numpy` carries a reference parameter tree (nested dict of
arrays, layers stacked on a leading axis) across leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]               # (seed, device=None) -> params
    forward: Callable[..., Any]            # (params, batch) -> logits
    init_cache: Callable[..., Any]         # (batch, max_seq, device=None)
    decode: Callable[..., Any]             # (params, cache, tokens)
    batch_axes: Callable[[], Any]          # () -> batch axis per leaf
    param_specs: Callable[[], Any]         # () -> spec tree
    cache_specs: Callable[..., Any]        # (shard_seq=...) -> spec tree
    fill_ctx: Callable[..., Any] | None = None   # (params, cache, ctx)
    needs_ctx: bool = False
    #: "/"-joined paths of the parameter subtrees ``decode`` never reads
    decode_unread: tuple = ()


def _generator(seed, device):
    """A generator seeded with ``seed`` on ``device`` (the card unless
    asked; ``"meta"``: shapes only); a `torch.Generator` passed as
    ``seed`` draws on its own device, which ``device``, if given, must
    name."""
    if isinstance(seed, torch.Generator):
        if device is not None and torch.device(device).type != \
                seed.device.type:
            raise ValueError(f"generator is on {seed.device}, not {device}")
        return seed
    dev = resolve_device(device)
    if dev.type == "meta":
        return cm.ShapesOnly()
    return torch.Generator(device=dev).manual_seed(int(seed))


def _module(cfg: ModelConfig):
    fam = cfg.family
    if fam in ("dense", "moe"):
        from repro_torch.models import transformer as m
    elif fam == "ssm" and cfg.d_ff == 0 and cfg.slstm_every:
        from repro_torch.models import xlstm as m
    elif fam in ("ssm", "hybrid"):
        from repro_torch.models import mamba2 as m
    elif fam == "vlm":
        from repro_torch.models import vlm as m
    elif fam == "audio":
        from repro_torch.models import whisper as m
    else:
        raise ValueError(f"unknown family {fam!r}")
    return m


def get_model(cfg: ModelConfig) -> ModelApi:
    m = _module(cfg)
    init, hooks, specs = m.init_params, {}, m.param_specs
    if cfg.family == "moe":
        from repro_torch.models import moe
        init = functools.partial(
            m.init_params, mlp_init=functools.partial(moe.init_moe, cfg))
        hooks = dict(mlp_fn=functools.partial(moe.moe_mlp_y, cfg))
        specs = functools.partial(m.param_specs, mlp_spec=moe.moe_specs(cfg))
    needs_ctx = cfg.family in ("vlm", "audio")
    if needs_ctx:
        def forward(p, b):
            return m.forward(cfg, p, b["tokens"], b["ctx"])
    else:
        def forward(p, b):
            return m.forward(cfg, p, b["tokens"], **hooks)
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, device=None: init(cfg, _generator(seed, device)),
        forward=forward,
        init_cache=lambda bs, ms, device=None: m.init_cache(
            cfg, bs, ms, device=resolve_device(device)),
        decode=lambda p, c, t: m.decode_step(cfg, p, c, t, **hooks),
        batch_axes=lambda: m.batch_axes(cfg),
        param_specs=lambda: specs(cfg),
        cache_specs=lambda **kw: m.cache_specs(cfg, **kw),
        fill_ctx=(lambda p, c, ctx: m.fill_cross_cache(cfg, p, c, ctx))
        if needs_ctx else None,
        needs_ctx=needs_ctx,
        decode_unread=getattr(m, "DECODE_UNREAD", ()))


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree as the port's params on ``device``.

    ``tree`` is a nested dict of arrays (numpy, or anything
    ``np.asarray`` reads), as the reference's ``init_params`` returns it
    for ``cfg``'s family; every leaf keeps its shape, dtype and values.
    Raises ValueError where the tree's keys or shapes are not the ones
    the family's init gives.
    """
    want = get_model(cfg).init(0, device="meta")
    dev = resolve_device(device)

    def conv(x, w, path):
        if isinstance(w, dict):
            if not isinstance(x, dict) or set(x) != set(w):
                got = sorted(x) if isinstance(x, dict) else type(x).__name__
                raise ValueError(f"{cfg.name}: {path or 'params'} holds "
                                 f"{got}, expected {sorted(w)}")
            return {k: conv(v, w[k], f"{path}/{k}") for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.shape != tuple(w.shape):
            raise ValueError(f"{cfg.name}: {path} has shape {a.shape}, "
                             f"expected {tuple(w.shape)}")
        return torch.from_numpy(a).to(dev)

    return conv(tree, want, "")


def count_params(params) -> int:
    return sum(v.numel() for v in leaves(params))
