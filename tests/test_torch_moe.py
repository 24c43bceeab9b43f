"""The port's MoE family (``models/moe.py`` on the transformer's FFN
hook) against the reference, on the CPU, at the reference's small
``FAMS["moe"]`` shape (``tests/test_models.py``) and grok-1's SMOKE.

Tolerances, fp32 unless stated: the flash route (its plain version) and
the cache paths 1e-5; the chunked route 1e-3 (it rounds probabilities to
bf16, see ``tests/test_torch_models.py``); bf16 compute 2e-2; decode
against the forward 6e-3, the reference's invariant.  The routing
(``dispatch``, ``combine``) is held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_families import (apis, batch, both, close, close_tree, configs,
                             random_cache, ref_tree, to_port, to_ref)
from repro.configs import registry as ref_cfgs
from repro.models import moe as rmoe
from repro.models import transformer as rt
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs import registry as cfgs
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.models.registry import get_model, params_from_numpy

torch.set_num_threads(1)


@pytest.mark.parametrize("flash,tol", [(True, 1e-5), (False, 1e-3)])
def test_forward_matches_reference_fp32(flash, tol):
    rcfg, cfg = configs("moe", use_flash_kernel=flash)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    b = batch(cfg, s=40)
    want = rapi.forward(jp, to_ref(b))
    got = api.forward(tp, to_port(b))
    assert got.shape == (2, 40, cfg.vocab) and got.dtype == torch.float32
    close(got, want, tol)


def test_forward_matches_reference_bf16():
    rcfg, cfg = configs("moe", "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    b = batch(cfg, s=40)
    got = api.forward(tp, to_port(b))
    assert got.dtype == torch.bfloat16
    close(got, rapi.forward(jp, to_ref(b)), 2e-2)


def test_decode_step_matches_reference():
    """One step from the same (drawn) cache: logits, every cache leaf
    and ``length``."""
    rcfg, cfg = configs("moe", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    cache = random_cache(rcfg)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, to_ref(cache), jnp.asarray(nxt))
    pl, pc = api.decode(tp, to_port(cache), torch.from_numpy(nxt))
    close(pl, rl, 1e-5)
    close_tree(pc, rc, 1e-5)


def test_decode_step_matches_reference_bf16():
    rcfg, cfg = configs("moe", "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    cache = random_cache(rcfg)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, to_ref(cache), jnp.asarray(nxt))
    pl, pc = api.decode(tp, to_port(cache), torch.from_numpy(nxt))
    assert pl.dtype == torch.bfloat16 and pc["k"].dtype == torch.bfloat16
    close(pl, rl, 2e-2)
    close_tree(pc, rc, 2e-2)


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_then_decode_match_reference(flash):
    rcfg, cfg = configs("moe", use_flash_kernel=flash)
    jp, tp = both(cfg, ref_tree(rcfg))
    tok = batch(cfg, s=12)["tokens"]
    mlp_fn = lambda p, x: rmoe.moe_mlp_y(rcfg, p, x)      # noqa: E731
    rl, rc = rt.prefill(rcfg, jp, jnp.asarray(tok), 20, mlp_fn=mlp_fn)
    pl, pc = tt.prefill(cfg, tp, torch.from_numpy(tok), 20,
                        mlp_fn=lambda p, x: moe.moe_mlp_y(cfg, p, x))
    tol = 1e-5 if flash else 1e-3
    close(pl, rl, tol)
    close_tree(pc, rc, tol)
    rl, rc = ref_get_model(rcfg).decode(jp, rc, jnp.asarray([3, 7]))
    pl, pc = get_model(cfg).decode(tp, pc, torch.tensor([3, 7]))
    close(pl, rl, tol)
    close_tree(pc, rc, tol)


@pytest.mark.parametrize("flash", [True, False])
def test_decode_matches_forward(flash):
    """Step-by-step decode equals the forward (the reference's
    invariant, at its tolerance)."""
    _, cfg = configs("moe", use_flash_kernel=flash)
    api = get_model(cfg)
    tp = api.init(0, device="cpu")
    tok = to_port(batch(cfg))["tokens"]
    full = api.forward(tp, dict(tokens=tok))
    cache = api.init_cache(2, 16, device="cpu")
    for t in range(tok.shape[1]):
        dlg, cache = api.decode(tp, cache, tok[:, t])
    close(dlg, full[:, -1].numpy(), 6e-3)


# -- the routing --------------------------------------------------------------

class _Spy:
    """Stands in for ``jax.numpy`` inside the reference's moe module and
    records the einsums' operands and results by equation."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, eq, *ops, **kw):
        out = jnp.einsum(eq, *ops, **kw)
        self.seen[eq] = (ops, out)
        return out


@pytest.mark.parametrize("cf,s", [(2.0, 16), (0.5, 16), (1.0, 1)])
def test_dispatch_and_combine_are_bit_identical(monkeypatch, cf, s):
    """The reference's gates through the port's `route`: ``dispatch``
    and ``combine`` equal bit for bit, with capacity to spare (cf 2),
    overflowing it (cf 0.5: tokens dropped) and at one token a group (a
    decode step: C = k)."""
    rcfg, cfg = configs("moe", capacity_factor=cf)
    tree = ref_tree(rcfg, loud=cf < 1)
    rp = to_ref(jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["mlp"]))
    x = np.random.default_rng(3).standard_normal((2, s, 32)).astype(
        np.float32)
    spy = _Spy()
    monkeypatch.setattr(rmoe, "jnp", spy)
    rmoe.moe_mlp(rcfg, rp, jnp.asarray(x))
    monkeypatch.undo()
    logit = spy.seen["bngd,de->bnge"][1]
    gates = np.asarray(jax.nn.softmax(logit, axis=-1))
    r_dispatch = np.asarray(spy.seen["bngec,bngd->bnecd"][0][0])
    r_combine = np.asarray(spy.seen["bngec,bnecd->bngd"][0][0])
    c = moe.capacity(cfg, s)
    assert c == rmoe._capacity(rcfg, s) and r_dispatch.shape[-1] == c
    dispatch, combine = moe.route(cfg, torch.from_numpy(gates.copy()), c)
    assert dispatch.dtype == torch.float32 and combine.dtype == torch.float32
    np.testing.assert_array_equal(dispatch.numpy(), r_dispatch)
    np.testing.assert_array_equal(combine.numpy(), r_combine)
    kept = dispatch.sum((-1, -2))
    if cf < 1:
        assert (kept < cfg.top_k).any()          # overflow: dropped slots
    else:
        assert (kept == cfg.top_k).all() and (s > 1 or c == cfg.top_k)
    assert (dispatch.sum(2) <= 1).all()          # one token per slot


def test_route_keeps_dispatch_in_the_compute_dtype():
    _, cfg = configs("moe", "bfloat16")
    gates = torch.softmax(torch.randn(1, 1, 8, cfg.n_experts,
                                      generator=torch.Generator()
                                      .manual_seed(0)), -1)
    dispatch, combine = moe.route(cfg, gates, 4)
    assert dispatch.dtype == torch.bfloat16 and combine.dtype == torch.float32


def test_moe_matches_bruteforce_top2():
    """The reference's brute-force check on the port: top-2 of the
    softmax gates, renormalised, over every expert's FFN, plus the dense
    residual; the aux loss near 1 for a balanced router."""
    _, cfg = configs("moe")
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(cfg, gen, 0.02)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y, aux = moe.moe_mlp(cfg, p, x)
    gates = torch.softmax(x @ p["router"], -1)
    v, i = gates.topk(2, -1)
    v = v / v.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = F.silu(x @ p["we_gate"][e]) * (x @ p["we_up"][e])
        w = (i[..., 0] == e) * v[..., 0] + (i[..., 1] == e) * v[..., 1]
        out = out + w[..., None] * (h @ p["we_down"][e])
    out = out + cm.mlp(cfg, p["dense"], x)
    torch.testing.assert_close(y, out, atol=1e-5, rtol=1e-5)
    assert float(aux) > 0.9


def test_aux_loss_matches_reference():
    rcfg, cfg = configs("moe")
    tree = ref_tree(rcfg)
    mlp = jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["mlp"])
    x = np.random.default_rng(5).standard_normal((2, 16, 32)).astype(
        np.float32)
    ry, raux = rmoe.moe_mlp(rcfg, to_ref(mlp), jnp.asarray(x))
    py, paux = moe.moe_mlp(cfg, to_port(mlp), torch.from_numpy(x))
    close(py, ry, 1e-5)
    close(paux, raux, 1e-6)


# -- grok-1: the softcap ------------------------------------------------------

def test_flash_route_refuses_the_softcap():
    """The flash kernel takes no logit softcap: asking for both raises
    (the reference's flash route drops the softcap silently)."""
    cfg = dataclasses.replace(cfgs.get_smoke("grok-1-314b"),
                              dtype=torch.float32, use_flash_kernel=True)
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    with pytest.raises(ValueError, match="softcap"):
        api.forward(params, dict(tokens=torch.zeros((1, 4), dtype=torch.long)))
    q = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError, match="softcap"):
        cm.attention(cfg, q, q, q, causal=True)


def test_grok_smoke_chunked_route_applies_the_softcap():
    """grok-1's SMOKE config in fp32 on the chunked route (the softcap
    applied) against the reference: the forward, and a decode step over
    the cache (``attention_over_cache`` applies it too)."""
    rcfg = dataclasses.replace(ref_cfgs.get_smoke("grok-1-314b"),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(cfgs.get_smoke("grok-1-314b"),
                              dtype=torch.float32)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    b = batch(cfg, s=24)
    close(api.forward(tp, to_port(b)), rapi.forward(jp, to_ref(b)), 1e-3)
    cache = random_cache(rcfg)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, to_ref(cache), jnp.asarray(nxt))
    pl, pc = api.decode(tp, to_port(cache), torch.from_numpy(nxt))
    close(pl, rl, 1e-5)
    close_tree(pc, rc, 1e-5)


def test_params_from_numpy_checks_the_tree():
    rcfg, cfg = configs("moe")
    tree = ref_tree(rcfg, loud=False)
    port = params_from_numpy(cfg, tree, device="cpu")
    np.testing.assert_array_equal(port["layers"]["mlp"]["we_up"].numpy(),
                                  tree["layers"]["mlp"]["we_up"])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"]["mlp"]["we_up"] = bad["layers"]["mlp"]["we_up"][:, :1]
    with pytest.raises(ValueError, match="we_up"):
        params_from_numpy(cfg, bad, device="cpu")
    del bad["layers"]["mlp"]["we_up"]
    with pytest.raises(ValueError, match="expected"):
        params_from_numpy(cfg, bad, device="cpu")
