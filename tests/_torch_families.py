"""Shared by the port's family tests: the reference's small ``FAMS``
configs (``tests/test_models.py``) for both packages, reference weights
carried across as numpy, and batches made with numpy from a seed.

``loud`` redraws every leaf of the reference's init (norms ~ 1 +- 0.2,
embeddings ~ N(0,1), everything else ~ N(0, 0.1^2): gates, biases and
the SSM parameters included), so that each block, not the embedding,
shapes the logits and the gated cross blocks are not the identity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.registry import get_model as ref_get_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model, params_from_numpy
from test_models import FAMS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(fam, dtype="float32", **kw):
    """The ``FAMS[fam]`` config for the reference and for the port."""
    jd, td = DTYPES[dtype]
    ref = dataclasses.replace(FAMS[fam], dtype=jd, **kw)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    return ref, ModelConfig(**{**fields, "dtype": td})


def ref_tree(rcfg, loud=True, seed=1):
    tree = jax.tree_util.tree_map(
        np.asarray, ref_get_model(rcfg).init(jax.random.PRNGKey(0)))
    if not loud:
        return tree
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        std = 1.0 if "tok" in name else 0.1
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def both(cfg, tree):
    """The tree as the reference's params and as the port's (CPU)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(cfg, tree, device="cpu"))


def apis(rcfg, cfg):
    return ref_get_model(rcfg), get_model(cfg)


def batch(cfg, b=2, s=9, seed=0):
    """numpy batch: ``tokens`` and, for the ctx families, ``ctx``."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if cfg.family in ("vlm", "audio"):
        out["ctx"] = rng.standard_normal(
            (b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


def to_ref(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:              # numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), atol=tol, rtol=tol)


def close_tree(got, want, tol, path=""):
    """Every leaf of the port's tree within ``tol`` of the reference's
    (integers exactly); the same keys on both sides."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], tol, f"{path}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), atol=tol,
                                   rtol=tol, err_msg=path)


def random_cache(rcfg, b=2, max_seq=16, lengths=(5, 3), seed=4):
    """The reference's ``init_cache`` layout with every float leaf drawn
    (the stabilisers ``m`` around 0, the rest N(0, 0.5^2)) and the given
    lengths, as numpy."""
    rng = np.random.default_rng(seed)
    cache = jax.tree_util.tree_map(
        np.asarray, ref_get_model(rcfg).init_cache(b, max_seq))

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['length']"):
            return np.asarray(lengths, np.int32)
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, cache)
