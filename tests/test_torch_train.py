"""The port's training path against the reference, on the CPU.

Every test of ``tests/test_train.py`` runs on the port
(``repro_torch.{data,parallel,train}``), and the same numpy inputs go
through both packages: the synthetic batches, the schedule, AdamW, the
int8 round trip, the loss, one train step at ``accum`` 1 and 2 from the
reference's init (carried across by `params_from_numpy`), the
compressed step, three ``Trainer.fit`` steps, checkpoints written by
one package and restored by the other, and ``launch.train``.

Tolerances (fp32): batches and int8 codes equal; the schedule within
1e-7; ``apply_updates`` 1e-6 relative; ``compress_decompress`` 1e-6;
the loss 1e-6 (alone) and 1e-5 relative (through a model); gradients
1e-4 relative + 1e-6 absolute (the chunked attention rounds
probabilities to bf16, as the reference does); new params within 1e-5
where the reference's gradient exceeds 1e-5 in magnitude, elsewhere
within 2 lr (Adam's first step is sign-like, and a gradient near zero
can take either sign); Trainer losses 1e-4 relative.  The compressed
step quantizes to steps of ``amax / 127``: a gradient within ~1e-6 of
a rounding boundary may take the next code in one package, so its
decompressed gradients are held to one quantization step (another
code on at most 5 elements in a thousand; the scales themselves differ
by the gradients' ~1e-6), and its new params to the rule above where
both packages' decompressed gradients have the same sign.
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _proptest import float_arrays, forall
from repro.data import synthetic as rsyn
from repro.models.common import ModelConfig as RefConfig
from repro.models.registry import get_model as ref_get_model
from repro.parallel import compression as rcomp
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro.train import step as rstep
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.data.synthetic import DataConfig, Stream, batch_at
from repro_torch.launch import train as launch_train
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.parallel import compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TINY = ModelConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab=128, dtype=torch.float32)
REF_TINY = RefConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=128, dtype=jnp.float32)
DATA = DataConfig(vocab=128, seq_len=64, global_batch=8, structure=0.9)
REF_DATA = rsyn.DataConfig(vocab=128, seq_len=64, global_batch=8,
                           structure=0.9)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL, GRAD_SMALL = 1e-5, 1e-5


def quiet(_):
    pass


def np_tree(tree):
    """A tree (JAX arrays or tensors) as numpy, keys as they are."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.dtype == \
            torch.bfloat16 else tree.detach().numpy()
    return np.asarray(tree, dtype=np.float32) if np.asarray(tree).dtype == \
        jnp.bfloat16 else np.asarray(tree)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def ref_init(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_get_model(REF_TINY).init(jax.random.PRNGKey(seed)))


# -- optimizer (tests/test_train.py) -----------------------------------------

def test_adamw_decreases_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                          total_steps=100)
    params = dict(w=torch.ones((4, 4)) * 3.0)
    state = opt.init_state(cfg, params)
    for _ in range(60):
        grads = dict(w=2 * params["w"])            # d/dw ||w||^2
        params, state, _ = opt.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clipping_bounds_update():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=0, grad_clip=1e-3,
                          weight_decay=0.0)
    params = dict(w=torch.zeros((8,)))
    state = opt.init_state(cfg, params)
    grads = dict(w=torch.full((8,), 1e6))
    _, _, metrics = opt.apply_updates(cfg, params, grads, state)
    assert float(metrics["grad_norm"]) > 1e5     # reported pre-clip


def test_schedule_warmup_and_decay():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(opt.schedule(cfg, torch.tensor(s))) for s in
           (1, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=0.02)


def test_bf16_state_dtype():
    cfg = opt.AdamWConfig(state_dtype=torch.bfloat16)
    params = dict(w=torch.ones((4,)))
    state = opt.init_state(cfg, params)
    assert state["m"]["w"].dtype == torch.bfloat16
    grads = dict(w=torch.ones((4,)))
    _, state, _ = opt.apply_updates(cfg, params, grads, state)
    assert state["v"]["w"].dtype == torch.bfloat16


# -- optimizer against the reference -----------------------------------------

def test_schedule_matches_reference():
    for warm, total in ((10, 100), (0, 50), (7, 7)):
        kw = dict(lr=1.0, warmup_steps=warm, total_steps=total,
                  min_lr_frac=0.1)
        rc, pc = ropt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
        for s in (0, 1, 3, 7, 10, 33, 50, 99, 100, 140):
            want = float(ropt.schedule(rc, jnp.asarray(s, jnp.int32)))
            got = float(opt.schedule(pc, torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= 1e-7, (warm, total, s, got, want)


def _opt_tree(rng, scale=1.0):
    """Matrices and vectors, nested, keys not in sorted order."""
    return dict(
        z=dict(w=scale * rng.standard_normal((6, 5)).astype(np.float32),
               b=scale * rng.standard_normal((5,)).astype(np.float32)),
        a=dict(w=scale * rng.standard_normal((3, 4, 2)).astype(np.float32)),
        norm=scale * rng.standard_normal((7,)).astype(np.float32))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(state_dtype):
    """Three AdamW steps from a drawn state (step 3 of a 2-step warmup
    into the cosine), the gradients clipped: params, moments, lr and the
    pre-clip norm."""
    rng = np.random.default_rng(3)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[state_dtype]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0)
    rc = ropt.AdamWConfig(**kw, state_dtype=jd)
    pc = opt.AdamWConfig(**kw, state_dtype=td)
    params = _opt_tree(rng)
    m = _opt_tree(rng, 0.1)
    v = _map(np.abs, _opt_tree(rng, 0.01))
    rp = _map(jnp.asarray, params)
    rs = dict(m=_map(lambda x: jnp.asarray(x, jd), m),
              v=_map(lambda x: jnp.asarray(x, jd), v),
              step=jnp.asarray(3, jnp.int32))
    pp = _map(torch.from_numpy, params)
    ps = dict(m=_map(lambda x: torch.from_numpy(
                  np.array(jnp.asarray(x, jd), np.float32)).to(td), m),
              v=_map(lambda x: torch.from_numpy(
                  np.array(jnp.asarray(x, jd), np.float32)).to(td), v),
              step=torch.tensor(3, dtype=torch.int32))
    for i in range(3):
        grads = _opt_tree(rng, 2.0)
        rp, rs, rmet = ropt.apply_updates(rc, rp, _map(jnp.asarray, grads),
                                          rs)
        pp, ps, pmet = opt.apply_updates(pc, pp, _map(torch.from_numpy,
                                                      grads), ps)
        assert int(ps["step"]) == int(rs["step"]) == 4 + i
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[k]), float(rmet[k]),
                                       rtol=1e-6)
        assert float(pmet["grad_norm"]) > kw["grad_clip"]     # clipped
        for name, got, want in (("params", pp, rp), ("m", ps["m"], rs["m"]),
                                ("v", ps["v"], rs["v"])):
            for key, g in flat(got).items():
                w = flat(want)[key]
                assert g.dtype == (torch.float32 if name == "params"
                                   else td), (name, key)
                np.testing.assert_allclose(np_tree(g), np_tree(w),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"{name} {key} step {i}")


# -- checkpoint (tests/test_train.py) -----------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = dict(a=torch.arange(6).reshape(2, 3),
                 nested=dict(b=torch.ones((4,), dtype=torch.bfloat16)),
                 lst=[torch.zeros(2), torch.ones(3)],
                 step=torch.tensor(7))
    ckpt.save(str(tmp_path), 7, state)
    restored, step = ckpt.restore(str(tmp_path), state)
    assert step == 7
    assert torch.equal(restored["a"], state["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert (restored["lst"][1] == 1).all()


def test_checkpoint_latest_and_prune(tmp_path):
    for s in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), s, dict(x=torch.tensor(s)))
    assert ckpt.latest_step(str(tmp_path)) == 40
    ckpt.prune(str(tmp_path), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert len(steps) == 2
    restored, _ = ckpt.restore(str(tmp_path), dict(x=torch.tensor(0)))
    assert int(restored["x"]) == 40


def test_checkpoint_atomicity(tmp_path):
    """A .tmp directory must never be visible as a checkpoint."""
    ckpt.save(str(tmp_path), 1, dict(x=torch.tensor(1)))
    os.makedirs(tmp_path / "step_00000002.tmp" / "arrays")
    assert ckpt.latest_step(str(tmp_path)) == 1


# -- checkpoint: durability, prune, and across the packages -------------------

def test_save_fsyncs_every_array_file_and_directory(tmp_path, monkeypatch):
    synced = []
    real = os.fsync

    def spy(fd):
        synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        return real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    state = dict(w=torch.ones((2, 3)), opt=dict(m=torch.zeros(3),
                                                 step=torch.tensor(1)))
    final = ckpt.save(str(tmp_path), 5, state)
    root = os.path.realpath(tmp_path)
    arrays = [os.path.join(root, "step_00000005.tmp", "arrays",
                           f"{k}.npy") for k in ("opt.m", "opt.step", "w")]
    for path in arrays + [
            os.path.join(root, "step_00000005.tmp", "manifest.json"),
            os.path.join(root, "step_00000005.tmp", "arrays"),
            os.path.join(root, "step_00000005.tmp"),
            os.path.join(root, "LATEST.tmp")]:
        assert path in synced, (path, synced)
    # the parent after the rename of the step and after LATEST's
    assert synced.count(root) == 2
    assert synced.index(root) > synced.index(
        os.path.join(root, "step_00000005.tmp"))
    assert len(synced) == len(arrays) + 6
    assert os.path.isdir(final)


def test_prune_refuses_keep_below_one(tmp_path):
    for s in (1, 2):
        ckpt.save(str(tmp_path), s, dict(x=torch.tensor(s)))
    for keep in (0, -1):
        with pytest.raises(ValueError, match="at least one"):
            ckpt.prune(str(tmp_path), keep=keep)
    assert ckpt.latest_step(str(tmp_path)) == 2
    ckpt.prune(str(tmp_path), keep=1)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000002"]


def _cross_state(rng):
    return dict(params=dict(w=rng.standard_normal((3, 4)).astype(np.float32),
                            emb=dict(tok=rng.standard_normal((5, 2))
                                     .astype(np.float32))),
                half=rng.standard_normal((6,)).astype(np.float32),
                count=np.asarray(11, np.int32))


def test_port_checkpoint_restores_in_reference(tmp_path):
    state = _cross_state(np.random.default_rng(0))
    port = dict(params=_map(torch.from_numpy, state["params"]),
                half=torch.from_numpy(state["half"]).to(torch.bfloat16),
                count=torch.tensor(11, dtype=torch.int32))
    ckpt.save(str(tmp_path), 9, port)
    template = dict(params=_map(jnp.zeros_like, state["params"]),
                    half=jnp.zeros((6,), jnp.bfloat16),
                    count=jnp.asarray(0, jnp.int32))
    got, step = rckpt.restore(str(tmp_path), template)
    assert step == 9 and rckpt.latest_step(str(tmp_path)) == 9
    assert got["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["half"], np.float32),
        port["half"].float().numpy())
    for k, w in flat(state["params"]).items():
        np.testing.assert_array_equal(np.asarray(flat(got["params"])[k]), w)
    assert int(got["count"]) == 11


def test_reference_checkpoint_restores_in_port(tmp_path):
    state = _cross_state(np.random.default_rng(1))
    ref = dict(params=_map(jnp.asarray, state["params"]),
               half=jnp.asarray(state["half"], jnp.bfloat16),
               count=jnp.asarray(11, jnp.int32))
    rckpt.save(str(tmp_path), 4, ref)
    template = dict(params=_map(lambda a: torch.zeros(a.shape),
                                state["params"]),
                    half=torch.zeros((6,), dtype=torch.bfloat16),
                    count=torch.tensor(0, dtype=torch.int32))
    got, step = ckpt.restore(str(tmp_path), template)
    assert step == 4 and got["half"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["half"].float().numpy(),
                                  np.asarray(ref["half"], np.float32))
    for k, w in flat(state["params"]).items():
        np.testing.assert_array_equal(flat(got["params"])[k].numpy(), w)
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 11


def test_trainer_resumes_from_reference_trainer(tmp_path):
    """A reference Trainer's checkpoint (params, moments, step) resumes
    a port Trainer with every leaf equal."""
    rt = RefTrainer(ref_get_model(REF_TINY),
                    ropt.AdamWConfig(lr=1e-3, warmup_steps=2),
                    RefTrainerConfig(total_steps=2, ckpt_every=2,
                                     ckpt_dir=str(tmp_path),
                                     log_every=1000), log_fn=quiet)
    rt.fit(rsyn.Stream(REF_DATA))
    pt = Trainer(get_model(TINY), opt.AdamWConfig(lr=1e-3, warmup_steps=2),
                 TrainerConfig(total_steps=3, ckpt_every=0,
                               ckpt_dir=str(tmp_path), log_every=1000),
                 device="cpu", log_fn=quiet)
    assert pt.maybe_resume() and pt.step_idx == 2
    want, got = flat(np_tree(rt.state())), flat(np_tree(pt.state()))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s = Stream(DATA)
    s.seek(2)
    assert pt.fit(s)["final_step"] == 3


# -- trainer end-to-end (tests/test_train.py) ----------------------------------

def test_trainer_learns_and_resumes(tmp_path):
    api = get_model(TINY)
    t = Trainer(api, opt.AdamWConfig(lr=1e-3, warmup_steps=5),
                TrainerConfig(total_steps=30, ckpt_every=15,
                              ckpt_dir=str(tmp_path), log_every=1000),
                device="cpu", log_fn=quiet)
    res = t.fit(Stream(DATA))
    assert res["losses"][-1] < res["losses"][0]
    t2 = Trainer(api, opt.AdamWConfig(lr=1e-3, warmup_steps=5),
                 TrainerConfig(total_steps=35, ckpt_every=0,
                               ckpt_dir=str(tmp_path), log_every=1000),
                 device="cpu", log_fn=quiet)
    assert t2.maybe_resume()
    assert t2.step_idx == 30
    s = Stream(DATA)
    s.seek(30)
    res2 = t2.fit(s)
    assert res2["final_step"] == 35


def test_preemption_checkpoint(tmp_path):
    """SIGTERM mid-run -> checkpoint written, clean exit."""
    api = get_model(TINY)
    t = Trainer(api, opt.AdamWConfig(lr=1e-3),
                TrainerConfig(total_steps=1000, ckpt_every=0,
                              ckpt_dir=str(tmp_path), log_every=10 ** 6),
                device="cpu", log_fn=quiet)

    class Batches:
        def __iter__(self):
            self.it = iter(Stream(DATA))
            self.n = 0
            return self

        def __next__(self):
            self.n += 1
            if self.n == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return next(self.it)

    res = t.fit(iter(Batches()))
    assert res["final_step"] < 1000
    assert ckpt.latest_step(str(tmp_path)) == res["final_step"]


def test_straggler_watchdog():
    dog = ft.StragglerWatchdog(timeout_factor=2.0, max_flags=2)
    for _ in range(10):
        assert not dog.observe(1.0)
    assert not dog.observe(5.0)     # first flag
    assert dog.observe(5.0)         # second consecutive -> restart


def test_elastic_mesh_planning():
    assert ft.plan_elastic_mesh(256, 16) == (16, 16)
    assert ft.plan_elastic_mesh(240, 16) == (15, 16)
    assert ft.plan_elastic_mesh(255, 16) == (15, 16)
    with pytest.raises(RuntimeError):
        ft.plan_elastic_mesh(8, 16)
    assert ft.plan_elastic_mesh(512, 16, pod_size=256) == (2, 16, 16)


def test_trainer_fit_matches_reference():
    """Three steps of each package's Trainer from the same weights on
    the same stream: per-step losses within 1e-4 relative."""
    rt = RefTrainer(ref_get_model(REF_TINY),
                    ropt.AdamWConfig(lr=1e-3, warmup_steps=2),
                    RefTrainerConfig(total_steps=3, ckpt_every=0,
                                     log_every=1000), log_fn=quiet)
    pt = Trainer(get_model(TINY), opt.AdamWConfig(lr=1e-3, warmup_steps=2),
                 TrainerConfig(total_steps=3, ckpt_every=0, log_every=1000),
                 device="cpu", log_fn=quiet)
    pt.params = params_from_numpy(
        TINY, jax.tree_util.tree_map(np.asarray, rt.params), device="cpu")
    want = rt.fit(rsyn.Stream(REF_DATA))["losses"]
    got = pt.fit(Stream(DATA))["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


# -- the train step against the reference -------------------------------------

def _capture():
    seen = []

    def hook(grads):
        seen.append(grads)
        return grads
    return seen, hook


def _assert_params_rule(new_p, new_r, grad_r, lr, agree=None):
    """New params within PARAM_ATOL where the reference's gradient
    exceeds GRAD_SMALL (and, where given, ``agree`` holds), elsewhere
    within 2 lr."""
    gr = flat(np_tree(grad_r))
    want = flat(np_tree(new_r))
    for key, got in flat(np_tree(new_p)).items():
        big = np.abs(gr[key]) > GRAD_SMALL
        if agree is not None:
            big &= agree[key]
        diff = np.abs(got - want[key])
        assert (diff[big] <= PARAM_ATOL).all(), (key, diff[big].max())
        assert (diff <= 2 * lr).all(), (key, diff.max())


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    tree = ref_init()
    lr = 1e-3
    rc = ropt.AdamWConfig(lr=lr, warmup_steps=0)
    pc = opt.AdamWConfig(lr=lr, warmup_steps=0)
    b = batch_at(DATA, 0)
    rseen, rhook = _capture()
    pseen, phook = _capture()
    rapi = ref_get_model(REF_TINY)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rnew, rstate, rmet = rstep.build_train_step(
        rapi, rc, accum=accum, compress_grads=rhook)(
        rp, ropt.init_state(rc, rp), {k: jnp.asarray(v) for k, v in
                                      b.items()})
    pp = params_from_numpy(TINY, tree, device="cpu")
    pnew, pstate, pmet = tstep.build_train_step(
        get_model(TINY), pc, accum=accum, compress_grads=phook)(
        pp, opt.init_state(pc, pp), {k: torch.from_numpy(v) for k, v in
                                     b.items()})
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pmet["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=GRAD_RTOL)
    gp, gr = flat(np_tree(pseen[0])), flat(np_tree(rseen[0]))
    assert set(gp) == set(gr)
    for k in gr:
        np.testing.assert_allclose(gp[k], gr[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    _assert_params_rule(pnew, rnew, rseen[0], lr)
    assert int(pstate["step"]) == int(rstate["step"]) == 1


def test_compressed_step_matches_reference():
    """One step with the int8 round trip at accum 1 (the reference's
    compressed Trainer step ignores accum): loss, the decompressed
    gradients within one quantization step, and the new params."""
    tree = ref_init()
    lr = 1e-3
    rc = ropt.AdamWConfig(lr=lr, warmup_steps=0)
    pc = opt.AdamWConfig(lr=lr, warmup_steps=0)
    b = batch_at(DATA, 1)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = params_from_numpy(TINY, tree, device="cpu")
    ref_ef = [rcomp.init_error_feedback(rp)]
    port_ef = [compression.init_error_feedback(pp)]
    raw = {}

    def rhook(g):
        raw["ref"] = g
        out, ref_ef[0] = rcomp.compress_decompress(g, ref_ef[0])
        raw["ref_deq"] = out
        return out

    def phook(g):
        out, port_ef[0] = compression.compress_decompress(g, port_ef[0])
        raw["port_deq"] = out
        return out

    rnew, _, rmet = rstep.build_train_step(
        ref_get_model(REF_TINY), rc, compress_grads=rhook)(
        rp, ropt.init_state(rc, rp), {k: jnp.asarray(v) for k, v in
                                      b.items()})
    pnew, _, pmet = tstep.build_train_step(
        get_model(TINY), pc, compress_grads=phook)(
        pp, opt.init_state(pc, pp), {k: torch.from_numpy(v) for k, v in
                                     b.items()})
    np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]),
                               rtol=LOSS_RTOL)
    dp, dr = flat(np_tree(raw["port_deq"])), flat(np_tree(raw["ref_deq"]))
    agree, n_diff, n_all = {}, 0, 0
    for k in dr:
        step = np.abs(dr[k]).max() / 127.0
        diff = np.abs(dp[k] - dr[k])
        assert (diff <= step * (1 + 1e-3) + 1e-12).all(), k
        n_diff += int((diff > step / 2).sum())        # another code
        n_all += diff.size
        agree[k] = np.sign(dp[k]) == np.sign(dr[k])
    assert n_diff <= 5e-3 * n_all, (n_diff, n_all)
    _assert_params_rule(pnew, rnew, raw["ref"], lr, agree)


# -- the loss -------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(2)
    logits = (4 * rng.standard_normal((3, 7, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    want = float(rstep.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels), z_loss=z_loss))
    got = float(tstep.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), z_loss=z_loss))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- gradient compression (tests/test_train.py) ---------------------------------

@forall(n_cases=20, g=float_arrays((32, 16), scale=3.0))
def test_compression_error_feedback_unbiased(g):
    """Over repeated steps with the same gradient, the accumulated
    applied update converges to the true gradient direction (error
    feedback property)."""
    grads = dict(w=torch.from_numpy(np.asarray(g, np.float32)))
    ef = compression.init_error_feedback(grads)
    total = torch.zeros_like(grads["w"])
    n = 24
    for _ in range(n):
        deq, ef = compression.compress_decompress(grads, ef)
        total = total + deq["w"]
    np.testing.assert_allclose((total / n).numpy(), grads["w"].numpy(),
                               atol=np.abs(g).max() / 100 + 1e-5)


def test_quantize_int8_range():
    x = torch.tensor([-300.0, 0.0, 150.0, 300.0])
    q, s = compression.quantize_int8(x)
    assert q.dtype == torch.int8
    deq = compression.dequantize_int8(q, s)
    np.testing.assert_allclose(deq.numpy(), x.numpy(), atol=float(s) + 1e-6)


# -- gradient compression against the reference ----------------------------------

@pytest.mark.parametrize("case", ["random", "halves", "zeros", "tiny"])
def test_quantize_int8_matches_reference(case):
    rng = np.random.default_rng(4)
    x = {"random": 3 * rng.standard_normal((17, 9)),
         # amax 127: scale 1, so x / scale lands on the halves exactly
         "halves": np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.0, -127.0]),
         "zeros": np.zeros((5,)),
         "tiny": 1e-30 * rng.standard_normal((11,))}[case].astype(np.float32)
    rq, rs = rcomp.quantize_int8(jnp.asarray(x))
    pq, ps = compression.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert np.float32(float(ps)) == np.float32(float(rs))
    np.testing.assert_array_equal(
        compression.dequantize_int8(pq, ps).numpy(),
        np.asarray(rcomp.dequantize_int8(rq, rs)))


def test_compress_decompress_matches_reference():
    """Five rounds with error feedback on a nested tree."""
    rng = np.random.default_rng(5)
    rtree = _map(jnp.asarray, _opt_tree(rng))
    ptree = _map(torch.from_numpy, np_tree(rtree))
    ref_ef, port_ef = rcomp.init_error_feedback(rtree), \
        compression.init_error_feedback(ptree)
    for i in range(5):
        g = _opt_tree(rng, 1.0 + i)
        rout, ref_ef = rcomp.compress_decompress(_map(jnp.asarray, g),
                                                 ref_ef)
        pout, port_ef = compression.compress_decompress(
            _map(torch.from_numpy, g), port_ef)
        for name, got, want in (("deq", pout, rout),
                                ("ef", port_ef, ref_ef)):
            for k, w in flat(np_tree(want)).items():
                np.testing.assert_allclose(flat(np_tree(got))[k], w,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name} {k} round {i}")


# -- data pipeline (tests/test_train.py) -----------------------------------------

def test_data_deterministic_and_seekable():
    b1 = batch_at(DATA, 17)
    b2 = batch_at(DATA, 17)
    assert (b1["tokens"] == b2["tokens"]).all()
    s = Stream(DATA, start=17)
    b3 = next(s)
    assert (b1["tokens"] == b3["tokens"]).all()


def test_data_host_sharding_consistent():
    full = batch_at(DATA, 3)
    lo = batch_at(DATA, 3, host_slice=slice(0, 4))
    hi = batch_at(DATA, 3, host_slice=slice(4, 8))
    assert (np.concatenate([lo["tokens"], hi["tokens"]])
            == full["tokens"]).all()


def test_data_labels_shifted():
    b = batch_at(DATA, 0)
    assert b["tokens"].shape == (8, 64)
    # structure: labels mostly follow the permutation of tokens
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


@pytest.mark.parametrize("index,host_slice", [
    (0, None), (17, None), (123456, None), (3, slice(0, 4)),
    (3, slice(4, 8)), (9, slice(2, 7))])
def test_synthetic_batches_equal_reference(index, host_slice):
    for pc, rc in ((DATA, REF_DATA),
                   (DataConfig(vocab=32000, seq_len=33, global_batch=8,
                               seed=5),
                    rsyn.DataConfig(vocab=32000, seq_len=33, global_batch=8,
                                    seed=5))):
        got = batch_at(pc, index, host_slice)
        want = rsyn.batch_at(rc, index, host_slice)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    s, rs = Stream(DATA, host_slice, start=index), rsyn.Stream(
        REF_DATA, host_slice, start=index)
    for _ in range(2):
        np.testing.assert_array_equal(next(s)["tokens"],
                                      next(rs)["tokens"])


# -- the launcher -----------------------------------------------------------------

def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "10",
            "--batch", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    res = launch_train.main(args)
    assert res["final_step"] == 10 and len(res["losses"]) == 10
    assert np.isfinite(res["losses"]).all()
    out = capsys.readouterr().out
    assert "tinyllama" in out and "finished at step 10" in out
    assert ckpt.latest_step(str(tmp_path)) == 10    # ckpt_every = 10
    # a resumed run picks up at step 10 and seeks the stream there
    res = launch_train.main(args[:4] + ["12"] + args[5:])
    assert res["final_step"] == 12 and len(res["losses"]) == 2
    assert "resumed from step 10" in capsys.readouterr().out
