"""Family dispatch: one model API per family (the dense family so far).

    api = get_model(cfg)
    params = api.init(seed, device=None)          # the card unless asked
    logits = api.forward(params, batch)           # batch = {"tokens": ...}
    cache  = api.init_cache(batch_size, max_seq, device=None)
    logits, cache = api.decode(params, cache, tokens)

`params_from_numpy` carries a reference parameter tree (nested dict of
arrays, layers stacked on a leading ``L`` axis) across leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.models.common import ModelConfig

#: families whose modules are still to port (ROADMAP Queue 1 item 11)
NOT_PORTED = ("moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]               # (seed, device=None) -> params
    forward: Callable[..., Any]            # (params, batch) -> logits
    init_cache: Callable[..., Any]         # (batch, max_seq, device=None)
    decode: Callable[..., Any]             # (params, cache, tokens)


def _generator(seed, device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (the card unless
    asked); a `torch.Generator` passed as ``seed`` draws on its own
    device, which ``device``, if given, must name."""
    if isinstance(seed, torch.Generator):
        if device is not None and torch.device(device).type != \
                seed.device.type:
            raise ValueError(f"generator is on {seed.device}, not {device}")
        return seed
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam == "dense":
        from repro_torch.models import transformer as m
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, device=None: m.init_params(
                cfg, _generator(seed, device)),
            forward=lambda p, b: m.forward(cfg, p, b["tokens"]),
            init_cache=lambda bs, ms, device=None: m.init_cache(
                cfg, bs, ms, device=resolve_device(device)),
            decode=lambda p, c, t: m.decode_step(cfg, p, c, t))
    if fam in NOT_PORTED:
        raise NotImplementedError(
            f"family {fam!r} ({cfg.name}) is not ported to PyTorch yet: "
            f"see ROADMAP Queue 1 item 11")
    raise ValueError(f"unknown family {fam!r}")


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree as the port's params on ``device``.

    ``tree`` is a nested dict of arrays (numpy, or anything
    ``np.asarray`` reads), as the reference's ``init_params`` returns
    it; every leaf keeps its shape, dtype and values.
    """
    get_model(cfg)                       # the family must be ported
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def count_params(params) -> int:
    return sum(v.numel() for v in _leaves(params))
