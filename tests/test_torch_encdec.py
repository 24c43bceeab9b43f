"""The port's ctx families against the reference, on the CPU: the
Whisper encoder-decoder (``models/whisper.py``) and the Llama-3.2-Vision
backbone with gated cross-attention (``models/vlm.py``), at the
reference's small ``FAMS`` shapes (``tests/test_models.py``), ctx drawn
with numpy.

Tolerances, fp32 unless stated: the flash route (its plain version),
`fill_ctx` and the decode paths 1e-5; the chunked route 1e-3 (bf16
probabilities, see ``tests/test_torch_models.py``); bf16 compute 2e-2;
decode against the forward 6e-3 (the reference's invariant).  The drawn
weights give the vision model's cross gates nonzero values, so its cross
blocks are not the identity they are at init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (apis, batch, both, close, close_tree, configs,
                             random_cache, ref_tree, to_port, to_ref)
from repro.models import whisper as rwhisper
from repro_torch.models import whisper
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

FAMS = ["audio", "vlm"]


@pytest.mark.parametrize("flash,tol", [(True, 1e-5), (False, 1e-3)])
@pytest.mark.parametrize("fam", FAMS)
def test_forward_matches_reference_fp32(fam, flash, tol):
    rcfg, cfg = configs(fam, use_flash_kernel=flash)
    rapi, api = apis(rcfg, cfg)
    assert api.needs_ctx and rapi.needs_ctx
    jp, tp = both(cfg, ref_tree(rcfg))
    b = batch(cfg, s=13)
    want = rapi.forward(jp, to_ref(b))
    got = api.forward(tp, to_port(b))
    assert got.shape == (2, 13, cfg.vocab) and got.dtype == torch.float32
    close(got, want, tol)


@pytest.mark.parametrize("fam", FAMS)
def test_forward_matches_reference_bf16(fam):
    rcfg, cfg = configs(fam, "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    b = batch(cfg, s=13)
    got = api.forward(tp, to_port(b))
    assert got.dtype == torch.bfloat16
    close(got, rapi.forward(jp, to_ref(b)), 2e-2)


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_matches_reference(flash):
    """Whisper's encoder: non-causal self-attention over the frames."""
    rcfg, cfg = configs("audio", use_flash_kernel=flash)
    jp, tp = both(cfg, ref_tree(rcfg))
    frames = batch(cfg)["ctx"]
    close(whisper.encode(cfg, tp, torch.from_numpy(frames)),
          rwhisper.encode(rcfg, jp, jnp.asarray(frames)),
          1e-5 if flash else 1e-3)


@pytest.mark.parametrize("fam", FAMS)
def test_fill_ctx_matches_reference(fam):
    """`fill_ctx` writes every layer's (segment's) cross K/V and leaves
    the rest of the cache as `init_cache` made it."""
    rcfg, cfg = configs(fam, use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    ctx = batch(cfg)["ctx"]
    want = rapi.fill_ctx(jp, rapi.init_cache(2, 16), jnp.asarray(ctx))
    got = api.fill_ctx(tp, api.init_cache(2, 16, device="cpu"),
                       torch.from_numpy(ctx))
    close_tree(got, want, 1e-5)
    assert got["xk"].abs().sum() > 0 and got["xk"].dtype == torch.float32


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("fam", FAMS)
def test_decode_step_matches_reference(fam, flash):
    """One step from the same cache: drawn self-attention K/V and
    lengths, cross K/V from `fill_ctx`; logits, every leaf, ``length``.
    The cross-attention at Sq = 1 takes the route the flag names."""
    rcfg, cfg = configs(fam, use_flash_kernel=flash)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    ctx = batch(cfg)["ctx"]
    cache = random_cache(rcfg)
    rc = rapi.fill_ctx(jp, to_ref(cache), jnp.asarray(ctx))
    pc = api.fill_ctx(tp, to_port(cache), torch.from_numpy(ctx))
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, rc, jnp.asarray(nxt))
    pl, pc = api.decode(tp, pc, torch.from_numpy(nxt))
    tol = 1e-5 if flash else 1e-3
    close(pl, rl, tol)
    close_tree(pc, rc, tol)


@pytest.mark.parametrize("fam", FAMS)
def test_decode_step_matches_reference_bf16(fam):
    """bf16 compute: `fill_ctx` and one step from the same cache."""
    rcfg, cfg = configs(fam, "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    ctx = batch(cfg)["ctx"]
    cache = random_cache(rcfg)
    rc = rapi.fill_ctx(jp, to_ref(cache), jnp.asarray(ctx))
    pc = api.fill_ctx(tp, to_port(cache), torch.from_numpy(ctx))
    close_tree(pc, rc, 2e-2)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, rc, jnp.asarray(nxt))
    pl, pc = api.decode(tp, pc, torch.from_numpy(nxt))
    assert pl.dtype == torch.bfloat16 and pc["xk"].dtype == torch.bfloat16
    close(pl, rl, 2e-2)
    close_tree(pc, rc, 2e-2)


@pytest.mark.parametrize("part", ["forward", "decode"])
def test_vlm_bf16_with_open_gates_matches_reference(part):
    """bf16 with the cross gates at 0.5 (as ``chip_smoke.py`` opens
    them): the reference's stream turns fp32 after the first gated block
    (its fp32 gates promote it), the port's stays bf16.  The cost of that
    choice, held to the bf16 tolerance 2e-2: the forward's logits, and
    one decode step's logits and self-attention K/V (measured: about
    half of the tolerance)."""
    rcfg, cfg = configs("vlm", "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    tree = ref_tree(rcfg)
    for k in ("gate_attn", "gate_mlp"):
        tree["cross"][k] = np.full_like(tree["cross"][k], 0.5)
    jp, tp = both(cfg, tree)
    b = batch(cfg, s=13)
    if part == "forward":
        want = rapi.forward(jp, to_ref(b))
        assert want.dtype == jnp.float32          # promoted by the gates
        got = api.forward(tp, to_port(b))
        assert got.dtype == torch.bfloat16
        close(got, want, 2e-2)
        return
    cache = random_cache(rcfg)
    rc = rapi.fill_ctx(jp, to_ref(cache), jnp.asarray(b["ctx"]))
    pc = api.fill_ctx(tp, to_port(cache), torch.from_numpy(b["ctx"]))
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, rc, jnp.asarray(nxt))
    pl, pc = api.decode(tp, pc, torch.from_numpy(nxt))
    close(pl, rl, 2e-2)
    close_tree(pc, rc, 2e-2)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("fam", FAMS)
def test_decode_matches_forward(fam, flash):
    """Step-by-step decode after `fill_ctx` equals the forward (the
    reference's invariant, at its tolerance), gates drawn nonzero."""
    rcfg, cfg = configs(fam, use_flash_kernel=flash)
    api = get_model(cfg)
    tp = both(cfg, ref_tree(rcfg, seed=2))[1]
    b = to_port(batch(cfg))
    full = api.forward(tp, b)
    cache = api.fill_ctx(tp, api.init_cache(2, 16, device="cpu"), b["ctx"])
    for t in range(b["tokens"].shape[1]):
        dlg, cache = api.decode(tp, cache, b["tokens"][:, t])
    close(dlg, full[:, -1].numpy(), 6e-3)


def test_vlm_gates_start_closed():
    """The port's init: tanh gates at 0, so each cross block is the
    identity, as in the reference."""
    _, cfg = configs("vlm")
    api = get_model(cfg)
    tp = api.init(0, device="cpu")
    assert not tp["cross"]["gate_attn"].any()
    assert not tp["cross"]["gate_mlp"].any()
    b = to_port(batch(cfg))
    zero = dict(b, ctx=torch.zeros_like(b["ctx"]))
    torch.testing.assert_close(api.forward(tp, b), api.forward(tp, zero),
                               atol=0, rtol=0)
