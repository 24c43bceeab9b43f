"""One train step of every model family, the port against the reference,
on the CPU (a file of its own so that ``--dist loadfile`` spreads it).

At ``tests/test_models.py``'s ``FAMS`` shapes in fp32, from the
reference's weights redrawn loud and carried across
(``tests/_torch_families.py``), one ``build_train_step`` at ``accum=2``
in each package on the same numpy batch: the loss within 1e-5 relative,
the pre-clip norm and every gradient leaf (from ``jax.grad`` and from
autograd) within 1e-4 relative + 1e-6 absolute, the new params within
1e-5 where the reference's gradient exceeds 1e-5 in magnitude and
elsewhere within 2 lr (Adam's first step is sign-like).  The chunked
attention, which training takes, rounds probabilities to bf16 in both
packages (the mLSTM its decay-weighted scores), and a one-ulp
difference in ``exp`` can round one the other way: on that default
route each gradient element is held to 1e-4 relative + 1e-6 absolute
plus 2e-3 of its leaf's largest magnitude (a rounded probability feeds
terms on the leaf's scale; 6.3e-4 measured at most), and the new params
to 1e-5 where the gradient's sign is certain.  With the probabilities
in fp32 in both packages (``REPRO_FP32_PROBS``, which both read at
each call) every element holds 1e-4 + 1e-6.  The
MoE routing of these weights has no near-tie, so no routing rule beyond
the forward's is needed.

Recompute (`models.common.recompute`, the reference's
``jax.checkpoint``): each family's forward under autograd runs one
checkpointed call per block the reference checkpoints and none without
autograd, and its logits and gradients are bit-equal to a run with the
recompute turned off.  Then one bf16 step of one small config per
family (``get_smoke``), finite metrics and moved params, as
``tests/test_smoke_archs.py::test_smoke_train_step`` asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import apis, both, configs, ref_tree
from _torch_families import batch as fam_batch
from repro.train import optimizer as ropt
from repro.train import step as rstep
from repro_torch.configs import registry as cfgs
from repro_torch.models import common as cm
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from repro_torch.tree import leaves, map_tree
from test_models import FAMS

torch.set_num_threads(1)

LR = 1e-3
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
PARAM_ATOL, GRAD_SMALL = 1e-5, 1e-5
#: the chunked route rounds probabilities to bf16 in both packages: a
#: one-ulp difference in ``exp`` can move one across a rounding boundary
#: (a 2^-8 step of itself), which is why its forward is held to 1e-3
#: (tests/test_torch_models.py).  The gradient terms such a probability
#: feeds scale with its leaf, not with each element: 6.3e-4 of the
#: leaf's largest magnitude at most over these families
FLIP_SCALE = 2e-3
#: blocks each family's forward checkpoints, as the reference does
#: (`jax.checkpoint` around the transformer, mamba, mLSTM, vision
#: self-attention, whisper encoder and decoder blocks)
RECOMPUTED = {"dense": 3, "moe": 2, "xlstm": 2, "mamba": 2, "hybrid": 4,
              "vlm": 2, "audio": 2 + 3}
#: one small config per family, bf16
SMOKE_ARCHS = ["tinyllama-1.1b", "grok-1-314b", "xlstm-1.3b", "zamba2-2.7b",
               "llama-3.2-vision-11b", "whisper-large-v3"]


def train_batch(cfg, b=4, s=12, seed=0):
    out = fam_batch(cfg, b=b, s=s, seed=seed)
    out["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def capture():
    seen = []

    def hook(grads):
        seen.append(grads)
        return grads
    return seen, hook


def grad_bound(want, exact_probs):
    """Per element: GRAD_RTOL + GRAD_ATOL, and with the probabilities
    rounded to bf16 FLIP_SCALE of the leaf's largest magnitude more."""
    bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL
    return bound if exact_probs else bound + FLIP_SCALE * np.abs(want).max()


@pytest.mark.parametrize("probs", ["bfloat16", "float32"])
@pytest.mark.parametrize("fam", sorted(FAMS))
def test_train_step_matches_reference(fam, probs, monkeypatch):
    if probs == "float32":
        monkeypatch.setenv("REPRO_FP32_PROBS", "1")        # both packages
    _hold_step(fam, probs)


@pytest.mark.parametrize("fam", ["dense", "moe"])
def test_train_step_under_dots_matches_reference(fam, monkeypatch):
    """``REPRO_REMAT_POLICY=dots`` in both packages (the reference's
    ``checkpoint_dots_with_no_batch_dims`` around its layer scan, the
    port's selective recompute around its layer loop): the same step at
    the same tolerances."""
    monkeypatch.setenv("REPRO_REMAT_POLICY", "dots")
    _hold_step(fam, "bfloat16")


def _hold_step(fam, probs):
    rcfg, cfg = configs(fam)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    b = train_batch(cfg)
    rc = ropt.AdamWConfig(lr=LR, warmup_steps=0)
    pc = opt.AdamWConfig(lr=LR, warmup_steps=0)
    pseen, phook = capture()

    def ref_step(params, state, batch):
        seen, hook = capture()
        out = rstep.build_train_step(rapi, rc, accum=2,
                                     compress_grads=hook)(params, state,
                                                          batch)
        return out + (seen[0],)

    rnew, _, rmet, rgrads = jax.jit(ref_step)(
        jp, ropt.init_state(rc, jp), {k: jnp.asarray(v) for k, v in
                                      b.items()})
    rseen = [rgrads]
    pnew, _, pmet = tstep.build_train_step(
        api, pc, accum=2, compress_grads=phook)(
        tp, opt.init_state(pc, tp), {k: torch.from_numpy(v) for k, v in
                                     b.items()})
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=GRAD_RTOL)
    gp, gr = flat(pseen[0]), flat(rseen[0])
    assert set(gp) == set(gr)
    bounds = {}
    for k in gr:
        bounds[k] = grad_bound(gr[k], probs == "float32")
        diff = np.abs(gp[k] - gr[k])
        assert (diff <= bounds[k]).all(), (k, diff.max(), probs)
    want = flat(rnew)
    for k, got in flat(pnew).items():
        diff = np.abs(got - want[k])
        # where the gradient's sign is certain
        big = np.abs(gr[k]) > np.maximum(GRAD_SMALL, bounds[k])
        assert (diff[big] <= PARAM_ATOL).all(), (k, diff[big].max())
        assert (diff <= 2 * LR).all(), (k, diff.max())


def _forward_and_grads(api, params, batch):
    tracked = map_tree(lambda p: p.detach().requires_grad_(True), params)
    logits = api.forward(tracked, batch)
    grads = torch.autograd.grad(logits.square().mean(),
                                list(leaves(tracked)), allow_unused=True)
    return logits.detach(), grads


@pytest.mark.parametrize("fam", sorted(FAMS))
def test_recompute_leaves_forward_and_grads_bit_equal(fam, monkeypatch):
    _, cfg = configs(fam)
    api = get_model(cfg)
    _, tp = both(cfg, ref_tree(configs(fam)[0]))
    b = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    calls = []
    real = cm.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cm, "checkpoint", counting)
    logits, grads = _forward_and_grads(api, tp, b)
    assert len(calls) == RECOMPUTED[fam]
    with torch.no_grad():
        plain = api.forward(tp, b)
    assert len(calls) == RECOMPUTED[fam]         # none without autograd
    assert torch.equal(logits, plain)
    monkeypatch.setattr(cm, "recompute",
                        lambda fn, params, *args, **kw: fn(*args))
    logits_off, grads_off = _forward_and_grads(api, tp, b)
    assert len(calls) == RECOMPUTED[fam]
    assert torch.equal(logits, logits_off)
    for g, g_off in zip(grads, grads_off):
        assert (g is None) == (g_off is None)
        assert g is None or torch.equal(g, g_off)


@pytest.mark.parametrize("fam", ["dense", "moe"])
def test_dots_policy_bit_equal_to_full_recompute(fam, monkeypatch):
    """Under ``REPRO_REMAT_POLICY=dots`` the layer loop saves the outputs
    of its products without batch dims (one per projection: no
    recompute of them, `models.common._save_dots`) and recomputes the
    rest: the logits and every gradient bit-equal to full recompute, and
    fewer products run by exactly the forward FLOPs of the products full
    recompute reruns: q, k, v, the output projection, the FFN's gate and
    up (and the router); neither reruns the FFN's down projection, whose
    output the backward does not read (the recompute stops at the last
    tensor it needs, as XLA's drops what no gradient reads)."""
    from torch.utils.flop_counter import FlopCounterMode
    _, cfg = configs(fam)
    api = get_model(cfg)
    _, tp = both(cfg, ref_tree(configs(fam)[0]))
    b = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    runs = {}
    for policy in ("full", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        with FlopCounterMode(display=False) as fc:
            logits, grads = _forward_and_grads(api, tp, b)
        runs[policy] = logits, grads, fc.get_total_flops()
    (lf, gf, ff), (ld, gd, fd) = runs["full"], runs["dots"]
    assert torch.equal(lf, ld)
    for g, g_d in zip(gf, gd):
        assert (g is None) == (g_d is None)
        assert g is None or torch.equal(g, g_d)
    rows = b["tokens"].numel()
    d, hd = cfg.d_model, cfg.head_dim
    proj = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    ffn = 2 * d * cfg.d_ff
    if fam == "moe":          # the router; the dense residual's FFN above
        ffn += d * cfg.n_experts
    assert ff - fd == 2 * rows * (proj + ffn) * cfg.n_layers


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_train_step_bf16(arch):
    cfg = cfgs.get_smoke(arch)
    assert cfg.dtype == torch.bfloat16
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3)
    step = tstep.build_train_step(api, ocfg, accum=2)
    rng = np.random.default_rng(1)
    batch = dict(
        tokens=torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))),
        labels=torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))))
    if api.needs_ctx:
        batch["ctx"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32))
    new_params, state, metrics = step(params, opt.init_state(ocfg, params),
                                      batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(state["step"]) == 1
    moved = max(float((a - b).abs().max()) for a, b in
                zip(leaves(params), leaves(new_params)))
    assert moved > 0
    assert all(p.dtype == torch.float32 for p in leaves(new_params))
