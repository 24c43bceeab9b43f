"""The port's recurrent families against the reference, on the CPU: the
Mamba2 SSM (``models/mamba2.py``), the Zamba2 hybrid (Mamba2 + a shared
attention block) and xLSTM (``models/xlstm.py``), at the reference's
small ``FAMS`` shapes (``tests/test_models.py``).

Tolerances, fp32 unless stated: Mamba2's forward, the hybrid's on the
flash route (its plain version) and every decode path 1e-5; xLSTM's
forward and the hybrid's chunked route 1e-3 (both round score-sized
terms to bf16 before a product, as the reference does, so a one-ulp
difference in ``exp`` can move one term by a bf16 step); bf16 compute
2e-2; decode against the forward 6e-3 (the reference's invariant); the
reference's own checks (mLSTM parallel == recurrent, SSD chunk-size
invariance) at its 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (apis, batch, both, close, close_tree, configs,
                             random_cache, ref_tree, to_port, to_ref)
from repro.models import mamba2 as rmamba
from repro.models import xlstm as rxlstm
from repro_torch.models import mamba2, xlstm
from repro_torch.models.registry import get_model

torch.set_num_threads(1)

FWD_TOL = {("mamba", True): 1e-5, ("mamba", False): 1e-5,
           ("hybrid", True): 1e-5, ("hybrid", False): 1e-3,
           ("xlstm", True): 1e-3, ("xlstm", False): 1e-3}


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_forward_matches_reference_fp32(fam, flash):
    rcfg, cfg = configs(fam, use_flash_kernel=flash)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    b = batch(cfg, s=21)                  # not a multiple of the chunk
    want = rapi.forward(jp, to_ref(b))
    got = api.forward(tp, to_port(b))
    assert got.shape == (2, 21, cfg.vocab) and got.dtype == torch.float32
    close(got, want, FWD_TOL[fam, flash])


@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_forward_matches_reference_bf16(fam):
    rcfg, cfg = configs(fam, "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    b = batch(cfg, s=21)
    got = api.forward(tp, to_port(b))
    assert got.dtype == torch.bfloat16
    close(got, rapi.forward(jp, to_ref(b)), 2e-2)


@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_decode_step_matches_reference(fam):
    """One step from the same drawn state: logits, every cache leaf
    (the fp32 recurrent states, the hybrid's per-application KV) and
    ``length``."""
    rcfg, cfg = configs(fam)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg))
    cache = random_cache(rcfg)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, to_ref(cache), jnp.asarray(nxt))
    pl, pc = api.decode(tp, to_port(cache), torch.from_numpy(nxt))
    close(pl, rl, 1e-5)
    close_tree(pc, rc, 1e-5)


@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_decode_step_matches_reference_bf16(fam):
    """bf16 compute from the same drawn state (the recurrent states
    stay fp32, the hybrid's KV is bf16)."""
    rcfg, cfg = configs(fam, "bfloat16", use_flash_kernel=True)
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, ref_tree(rcfg, loud=False))
    cache = random_cache(rcfg)
    nxt = np.array([5, 40], np.int32)
    rl, rc = rapi.decode(jp, to_ref(cache), jnp.asarray(nxt))
    pl, pc = api.decode(tp, to_port(cache), torch.from_numpy(nxt))
    assert pl.dtype == torch.bfloat16
    close(pl, rl, 2e-2)
    close_tree(pc, rc, 2e-2)


@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_fresh_cache_equals_reference(fam):
    rcfg, cfg = configs(fam)
    rapi, api = apis(rcfg, cfg)
    close_tree(api.init_cache(2, 16, device="cpu"),
               jax.tree_util.tree_map(np.asarray, rapi.init_cache(2, 16)), 0)


@pytest.mark.parametrize("fam", ["mamba", "hybrid", "xlstm"])
def test_decode_matches_forward(fam):
    """Step-by-step decode equals the forward (the reference's
    invariant, at its tolerance), from a fresh state."""
    _, cfg = configs(fam, use_flash_kernel=True)
    api = get_model(cfg)
    tp = api.init(0, device="cpu")
    tok = to_port(batch(cfg))["tokens"]
    full = api.forward(tp, dict(tokens=tok))
    cache = api.init_cache(2, 16, device="cpu")
    for t in range(tok.shape[1]):
        dlg, cache = api.decode(tp, cache, tok[:, t])
    close(dlg, full[:, -1].numpy(), 6e-3)


def test_mlstm_parallel_equals_recurrent():
    """The reference's check on the port: the chunked parallel mLSTM
    equals the recurrent update, token by token."""
    _, cfg = configs("xlstm")
    gen = torch.Generator().manual_seed(3)
    p = xlstm.init_mlstm(cfg, gen, 0.02)
    x = torch.randn((2, 11, cfg.d_model), generator=gen)
    y_par = xlstm.mlstm_fwd(cfg, p, x)
    st = {k: v[0] for k, v in xlstm.init_cache(cfg, 2)["mlstm"].items()}
    ys = []
    for t in range(11):
        st, yt = xlstm.mlstm_step(cfg, p, st, x[:, t])
        ys.append(yt)
    torch.testing.assert_close(y_par, torch.stack(ys, 1), atol=2e-5,
                               rtol=2e-5)


def test_ssd_chunked_scan_invariant_to_chunk_size():
    """SSD gives the same result for any chunk length (the reference's
    check on the port)."""
    _, cfg = configs("mamba")
    gen = torch.Generator().manual_seed(5)
    p = mamba2.init_mamba(cfg, gen, 0.02)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    outs = [mamba2.mamba_fwd(dataclasses.replace(cfg, ssm_chunk=q), p, x)
            for q in (2, 4, 8, 16)]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,q", [(16, 4), (13, 4), (7, 16)])
def test_ssd_scan_matches_reference(s, q):
    """`_ssd_scan` on the same inputs as the reference's, padded when
    the chunk does not divide the sequence (dt = 0 padding is inert)."""
    rcfg, cfg = configs("mamba", ssm_chunk=q)
    rng = np.random.default_rng(s)
    xh = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    dt = np.abs(rng.standard_normal((2, s, 4))).astype(np.float32)
    a = -np.exp(rng.standard_normal(4)).astype(np.float32)
    bm = rng.standard_normal((2, s, 8)).astype(np.float32)
    cmat = rng.standard_normal((2, s, 8)).astype(np.float32)
    want = rmamba._ssd_scan(rcfg, *map(jnp.asarray, (xh, dt, a, bm, cmat)))
    got = mamba2._ssd_scan(cfg, *map(torch.from_numpy, (xh, dt, a, bm, cmat)))
    close(got, want, 1e-5)


def test_mlstm_and_slstm_blocks_match_reference():
    rcfg, cfg = configs("xlstm")
    tree = ref_tree(rcfg)
    x = np.random.default_rng(6).standard_normal((2, 13, 32)).astype(
        np.float32)
    for name, rf, pf in (("mlstm", rxlstm.mlstm_fwd, xlstm.mlstm_fwd),
                         ("slstm", rxlstm.slstm_fwd, xlstm.slstm_fwd)):
        lp = jax.tree_util.tree_map(lambda a: a[0], tree[name])
        close(pf(cfg, to_port(lp), torch.from_numpy(x)),
              rf(rcfg, to_ref(lp), jnp.asarray(x)), 1e-3 if
              name == "mlstm" else 1e-5)
