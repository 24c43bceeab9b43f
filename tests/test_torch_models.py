"""The port's dense LM substrate against the reference, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
(`params_from_numpy` carries the reference's tree across).  Weights are
drawn larger than the reference's init so that attention and the FFN,
not the embedding, shape the logits.

Tolerances, fp32 unless stated:
* primitives, the flash route and the cache paths: 1e-5 (sums in
  another order than XLA's);
* the chunked route: 1e-3.  It rounds probabilities to bf16, and a
  one-ulp fp32 difference in ``exp`` can move a probability across a
  bf16 rounding boundary (a 2^-8 relative step in one weight);
* bf16 compute: 2e-2, as ``tests/test_kernels.py`` holds bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_cfgs
from repro.models import common as rcm
from repro.models import transformer as rt
from repro.models.common import ModelConfig as RefConfig
from repro.models.registry import count_params as ref_count_params
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs import registry as cfgs
from repro_torch.models import common as cm
from repro_torch.models import transformer as tt
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import (count_params, get_model,
                                         params_from_numpy)

torch.set_num_threads(1)

DENSE = dict(name="t-dense", family="dense", n_layers=3, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab=97)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype="float32", **kw):
    """The same dense config for the reference and for the port."""
    fields = {**DENSE, **kw}
    jd, td = DTYPES[dtype]
    return RefConfig(**fields, dtype=jd), ModelConfig(**fields, dtype=td)


def ref_params(rcfg, seed=1, loud=True):
    """The reference's init tree as numpy; ``loud`` redraws every leaf
    (norms ~ 1 +- 0.2, embeddings ~ N(0,1), matrices ~ N(0, 0.1^2),
    biases ~ N(0, 0.1^2))."""
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


def both(rcfg, cfg, tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(cfg, tree, device="cpu"))


def tokens(vocab, b=2, s=40, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), atol=tol, rtol=tol)


# -- configs -----------------------------------------------------------------

def _fields(c):
    d = dataclasses.asdict(c)
    d["dtype"] = str(d["dtype"]).split(".")[-1].replace("'>", "")
    return d


@pytest.mark.parametrize("arch", list(ref_cfgs.ARCHS))
def test_arch_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke"):
        ref, port = getattr(ref_cfgs, get)(arch), getattr(cfgs, get)(arch)
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert _fields(port) == _fields(ref), (arch, get)
        assert (port.head_dim, port.q_per_kv, port.d_inner) == (
            ref.head_dim, ref.q_per_kv, ref.d_inner)
    assert cfgs.skip_shapes(arch) == ref_cfgs.skip_shapes(arch)


def test_config_registry_equals_the_reference():
    assert list(cfgs.ARCHS) == list(ref_cfgs.ARCHS)
    assert cfgs.cells() == ref_cfgs.cells()
    assert cfgs.cells(include_skipped=True) == ref_cfgs.cells(True)
    assert {k: dataclasses.asdict(v) for k, v in cfgs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_cfgs.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        cfgs.get_config("gpt-5")


# -- primitives --------------------------------------------------------------

def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    close(cm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          rcm.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-5)
    pos = np.array([[0, 1, 2, 3, 50, 900, 4095]])
    c, s = cm.rope_table(torch.from_numpy(pos), 16, 1e4)
    rc, rs = rcm.rope_table(jnp.asarray(pos), 16, 1e4)
    close(c, rc, 1e-5)
    close(s, rs, 1e-5)
    close(cm.apply_rope(torch.from_numpy(x), c, s),
          rcm.apply_rope(jnp.asarray(x), rc, rs), 1e-5)


@pytest.mark.parametrize("s,t,causal,softcap", [
    (40, 40, True, 0.0), (9, 40, True, 0.0), (40, 24, True, 0.0),
    (300, 300, True, 0.0), (40, 40, False, 0.0), (40, 40, True, 30.0)])
def test_chunked_attention_matches(s, t, causal, softcap):
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((2, s, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    want = rcm._chunked_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, chunk=128, softcap=softcap)
    got = cm._chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, chunk=128, softcap=softcap)
    close(got, want, 1e-3)


def test_attention_dispatch_routes_match():
    """Both routes of `attention` against the reference's, same flag."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 33, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 33, 2, 16)).astype(np.float32)
    for flash, tol in ((True, 1e-5), (False, 1e-3)):
        rcfg, cfg = configs(use_flash_kernel=flash)
        want = rcm.attention(rcfg, *map(jnp.asarray, (q, k, k)), causal=True)
        got = cm.attention(cfg, *map(torch.from_numpy, (q, k, k)),
                           causal=True)
        close(got, want, tol)


def test_mlp_embed_logits_match():
    for tie in (False, True):
        rcfg, cfg = configs(tie_embeddings=tie)
        jp, tp = both(rcfg, cfg, ref_params(rcfg))
        x = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(
            np.float32)
        lp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
        close(cm.mlp(cfg, tt._layer(tp["layers"], 0)["mlp"],
                     torch.from_numpy(x)),
              rcm.mlp(rcfg, lp["mlp"], jnp.asarray(x)), 1e-5)
        tok = tokens(97, s=6)
        close(cm.embed(cfg, tp["embed"], torch.from_numpy(tok)),
              rcm.embed(rcfg, jp["embed"], jnp.asarray(tok)), 0)
        close(cm.logits(cfg, tp["embed"], torch.from_numpy(x)),
              rcm.logits(rcfg, jp["embed"], jnp.asarray(x)), 1e-5)


# -- the dense model ----------------------------------------------------------

@pytest.mark.parametrize("flash,bias", [(True, False), (True, True),
                                        (False, False), (False, True)])
def test_forward_matches_reference_fp32(flash, bias):
    rcfg, cfg = configs(use_flash_kernel=flash, qkv_bias=bias)
    jp, tp = both(rcfg, cfg, ref_params(rcfg))
    tok = tokens(97)
    want = rt.forward(rcfg, jp, jnp.asarray(tok))
    got = get_model(cfg).forward(tp, dict(tokens=torch.from_numpy(tok)))
    assert got.shape == (2, 40, 97) and got.dtype == torch.float32
    close(got, want, 1e-5 if flash else 1e-3)


@pytest.mark.parametrize("flash", [True, False])
def test_forward_matches_reference_bf16(flash):
    rcfg, cfg = configs("bfloat16", use_flash_kernel=flash, qkv_bias=True)
    jp, tp = both(rcfg, cfg, ref_params(rcfg, loud=False))
    tok = tokens(97)
    want = rt.forward(rcfg, jp, jnp.asarray(tok))
    got = tt.forward(cfg, tp, torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    close(got, want, 2e-2)


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_then_decode_match_reference(flash):
    rcfg, cfg = configs(use_flash_kernel=flash, qkv_bias=True)
    jp, tp = both(rcfg, cfg, ref_params(rcfg))
    tok = tokens(97, s=12)
    tol = 1e-5 if flash else 1e-3
    rl, rc = rt.prefill(rcfg, jp, jnp.asarray(tok), max_seq=20)
    pl, pc = tt.prefill(cfg, tp, torch.from_numpy(tok), max_seq=20)
    close(pl, rl, tol)
    for name in ("k", "v"):
        assert tuple(pc[name].shape) == rc[name].shape == (3, 2, 20, 2, 16)
        close(pc[name], rc[name], tol)
    assert pc["length"].tolist() == [12, 12]
    nxt = np.array([5, 60], np.int32)
    rl, rc = rt.decode_step(rcfg, jp, rc, jnp.asarray(nxt))
    pl, pc = tt.decode_step(cfg, tp, pc, torch.from_numpy(nxt))
    close(pl, rl, tol)
    close(pc["k"], rc["k"], tol)
    assert pc["length"].tolist() == np.asarray(rc["length"]).tolist()


@pytest.mark.parametrize("flash", [True, False])
def test_decode_matches_forward(flash):
    """Step-by-step decode equals the parallel forward pass (the
    reference's invariant, at its tolerance: the chunked forward rounds
    probabilities to bf16, decode keeps fp32)."""
    _, cfg = configs(use_flash_kernel=flash, qkv_bias=True)
    api = get_model(cfg)
    tp = api.init(0, device="cpu")
    tok = torch.from_numpy(tokens(97, s=9))
    full = api.forward(tp, dict(tokens=tok))
    cache = api.init_cache(2, 16, device="cpu")
    for t in range(tok.shape[1]):
        dlg, cache = api.decode(tp, cache, tok[:, t])
    close(dlg, full[:, -1].numpy(), 6e-3)
    pl, pc = tt.prefill(cfg, tp, tok[:, :-1], 16)
    dlg2, _ = api.decode(tp, pc, tok[:, -1])
    close(dlg2, full[:, -1].numpy(), 6e-3)


def test_cache_write_clamps_at_max_seq():
    """A full sequence (length == max_seq) overwrites its last cache row,
    as the reference's ``dynamic_update_slice`` clamps its start."""
    rcfg, cfg = configs()
    jp, tp = both(rcfg, cfg, ref_params(rcfg))
    rng = np.random.default_rng(9)
    shape = (3, 2, 8, 2, 16)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    length = np.array([8, 5], np.int32)          # row 0 full, row 1 not
    rc = dict(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(length))
    pc = dict(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()),
              length=torch.from_numpy(length.copy()))
    nxt = np.array([3, 4], np.int32)
    rl, rc = rt.decode_step(rcfg, jp, rc, jnp.asarray(nxt))
    pl, pc = tt.decode_step(cfg, tp, pc, torch.from_numpy(nxt))
    close(pl, rl, 1e-5)
    close(pc["k"], rc["k"], 1e-5)
    close(pc["v"], rc["v"], 1e-5)
    assert pc["length"].tolist() == [9, 6]
    k1 = pc["k"].numpy()
    assert not np.array_equal(k1[:, 0, 7], k0[:, 0, 7])   # clamped row
    np.testing.assert_array_equal(k1[:, 0, :7], k0[:, 0, :7])
    assert not np.array_equal(k1[:, 1, 5], k0[:, 1, 5])
    np.testing.assert_array_equal(k1[:, 1, 6:], k0[:, 1, 6:])


# -- registry ----------------------------------------------------------------

def test_init_has_the_reference_shapes_and_scales():
    rcfg, cfg = configs(qkv_bias=True)
    ref = ref_params(rcfg, loud=False)
    port = get_model(cfg).init(torch.Generator().manual_seed(3),
                               device="cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_p = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(port)[0]}
    assert len(flat_r) == len(flat_p)
    for path, a in flat_r:
        b = flat_p[jax.tree_util.keystr(path)]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        assert abs(float(b.std()) - float(a.std())) <= 0.1 * float(a.std())
        assert abs(float(b.mean()) - float(a.mean())) <= 0.01
    assert count_params(port) == ref_count_params(ref)
    again = get_model(cfg).init(3, device="cpu")
    assert all(torch.equal(flat_p[jax.tree_util.keystr(p)], v) for p, v in
               jax.tree_util.tree_flatten_with_path(again)[0])


def test_entry_points_default_to_the_card():
    rcfg, cfg = configs()
    api = get_model(cfg)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, ref_params(rcfg, loud=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(2, 8)


def test_params_from_numpy_carries_every_leaf_exactly():
    rcfg, cfg = configs(qkv_bias=True)
    tree = ref_params(rcfg)
    port = params_from_numpy(cfg, tree, device="cpu")
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(port)[0]}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(flat[jax.tree_util.keystr(path)]
                                      .numpy(), a)
    assert count_params(port) == ref_count_params(tree)


def _smoke_batch(cfg, needs_ctx, b=2, s=16):
    rng = np.random.default_rng(1)
    out = dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if needs_ctx:
        out["ctx"] = rng.standard_normal(
            (b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", list(ref_cfgs.ARCHS))
def test_every_family_is_served(arch):
    """Every architecture's SMOKE config: a forward of the expected
    shape, finite, and ``needs_ctx`` as the reference's."""
    cfg = cfgs.get_smoke(arch)
    api = get_model(cfg)
    assert api.needs_ctx == ref_get_model(ref_cfgs.get_smoke(arch)).needs_ctx
    assert (api.fill_ctx is not None) == api.needs_ctx
    batch = {k: torch.from_numpy(v) for k, v in
             _smoke_batch(cfg, api.needs_ctx).items()}
    logits = api.forward(api.init(0, device="cpu"), batch)
    assert logits.shape == (2, 16, cfg.vocab)
    assert logits.dtype == torch.bfloat16
    assert bool(logits.isfinite().all()), f"NaNs in {arch} logits"


@pytest.mark.parametrize("arch", list(ref_cfgs.ARCHS))
def test_full_config_param_count_equals_the_reference(arch):
    """The FULL config's parameter tree from a shape-only init (meta
    tensors, nothing allocated): leaf for leaf the shapes of the
    reference's ``jax.eval_shape`` tree, and so its count."""
    ref_struct = jax.eval_shape(ref_get_model(ref_cfgs.get_config(arch)).init,
                                jax.random.PRNGKey(0))
    port = get_model(cfgs.get_config(arch)).init(0, device="meta")
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(port)[0]}
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_struct)[0]
    assert len(flat) == len(ref_flat)
    for path, a in ref_flat:
        b = flat[jax.tree_util.keystr(path)]
        assert b.device.type == "meta" and tuple(b.shape) == a.shape, path
    assert count_params(port) == ref_count_params(ref_struct)


def _bf16_decode_gap(api, params, batch, conv, to_np, cache,
                     decode=None):
    """Largest |decode - forward| over 16 steps, over the largest
    forward logit."""
    b = conv(batch)
    full = to_np(api.forward(params, b))
    if api.needs_ctx:
        cache = api.fill_ctx(params, cache, b["ctx"])
    gap = 0.0
    for t in range(b["tokens"].shape[1]):
        dec, cache = (decode or api.decode)(params, cache, b["tokens"][:, t])
        gap = max(gap, float(np.abs(to_np(dec) - full[:, t]).max()
                             / np.abs(full[:, t]).max()))
    return gap


# the small FAMS widths at a published depth: zamba2-2.7b's 54 layers
# (the shared block every 6) and xlstm-1.3b's 48 (an sLSTM every 8)
DEEP = {"hybrid-54": dict(n_layers=54, attn_every=6),
        "xlstm-48": dict(n_layers=48, slstm_every=8)}


@pytest.mark.parametrize("fam", ["dense", "moe", "xlstm", "mamba", "hybrid",
                                 "vlm", "audio", *DEEP])
def test_bf16_decode_departs_from_the_forward_as_the_reference_does(fam):
    """In bf16 the decode step rounds at other places than the forward
    (fp32 recurrent states and convolution, attention over the cache),
    so the two part by a few bf16 steps, more with depth.  The reference
    parts as far: the port's gap, on the same weights, within twice the
    reference's, also at a published depth."""
    from _torch_families import apis, batch, both, configs, to_port, to_ref
    from _torch_families import ref_tree as fam_tree

    rcfg, cfg = configs(fam.split("-")[0], "bfloat16",
                        use_flash_kernel=fam != "moe", **DEEP.get(fam, {}))
    rapi, api = apis(rcfg, cfg)
    jp, tp = both(cfg, fam_tree(rcfg))
    b = batch(cfg, s=16)
    ref_gap = _bf16_decode_gap(
        rapi, jp, b, to_ref, lambda a: np.asarray(a.astype(jnp.float32)),
        rapi.init_cache(2, 32), jax.jit(rapi.decode))
    gap = _bf16_decode_gap(api, tp, b, to_port, lambda a: a.float().numpy(),
                           api.init_cache(2, 32, device="cpu"))
    assert 0 < ref_gap and gap <= 2 * ref_gap, (gap, ref_gap)
