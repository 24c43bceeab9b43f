"""The whole platform: the port's `run_frontend` / `run_point` against the
reference on a batch of operating points.

Per-window `WindowOut` values and the ``n_rd``, ``n_wr``, ``injected``,
``weave_events`` and ``weave_sat`` views must be equal.  The port sums
floats in the reference's order (channels in index order, XLA's fused
multiply-adds in the PI loop), so the per-window float32 values are
exact too; the aggregated float views sum over windows, where XLA's
reduction order is its own, and are held to ``rtol=1e-6``.  Stage 04
and later close the PI loop, where one ulp in ``l_ir`` would flip its
rounding and fork every later window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_stage as ref_get_stage
from repro.core.platform import run_frontend as ref_run_frontend
from repro.core.workload import MessFrontend as RefMessFrontend
from repro_torch.core import get_stage, run_point
from repro_torch.core.platform import run_frontend
from repro_torch.core.workload import MessFrontend

torch.set_num_threads(1)

EXACT_VIEWS = ("n_rd", "n_wr", "injected", "weave_events", "weave_sat")
FLOAT_VIEWS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
               "app_bw_gbs", "app_lat_ns", "chase_lat_ns", "l_ir_final")
RTOL = 1e-6

CASES = [
    # stage, preset, sockets, weave, windows, paces, wr_num
    ("01-baseline", "ddr4_2666", 1, "event", 8, (4, 24), 16),
    ("04-model-correct", "ddr4_2666", 1, "dense", 8, (4, 48), 16),
    ("04-model-correct", "ddr4_2666", 1, "event", 12, (2, 12), 0),
    ("07-prefetch", "ddr4_2666", 1, "event", 8, (4, 64), 32),   # saturates
    ("10-delay-buffer", "ddr4_2666", 1, "event", 8, (1, 24), 8),
    ("04-model-correct", "ddr5_4800", 1, "event", 8, (4, 48), 16),
    ("04-model-correct", "hbm2e", 2, "event", 8, (8, 64), 16),
]


def _reference(cfg, paces, wr):
    fn = jax.jit(jax.vmap(lambda p, w: ref_run_frontend(
        cfg, RefMessFrontend(p, w, cfg.workload_config()))))
    views, outs = fn(jnp.asarray(paces, jnp.int32),
                     jnp.full((len(paces),), wr, jnp.int32))
    return ({k: np.asarray(v) for k, v in views.items()},
            {k: np.asarray(v) for k, v in outs._asdict().items()})


@pytest.mark.parametrize("stage,preset,sockets,weave,windows,paces,wr",
                         CASES)
def test_run_frontend_matches_reference(stage, preset, sockets, weave,
                                        windows, paces, wr):
    kw = dict(preset=preset, n_sockets=sockets, weave=weave,
              windows=windows, warmup=2 if windows < 12 else 4)
    ref_views, ref_outs = _reference(ref_get_stage(stage, **kw), paces, wr)
    cfg = get_stage(stage, **kw)
    pace_t = torch.tensor(paces, dtype=torch.int32)
    frontend = MessFrontend(pace_t, torch.full_like(pace_t, wr),
                            cfg.workload_config())
    views, outs = run_frontend(cfg, frontend, batch=len(paces),
                               device="cpu")
    for k, ref in ref_outs.items():          # (B, W) in the reference
        np.testing.assert_array_equal(getattr(outs, k).numpy().T, ref,
                                      err_msg=f"WindowOut.{k}")
    for k in EXACT_VIEWS:
        np.testing.assert_array_equal(views[k].numpy(), ref_views[k],
                                      err_msg=k)
    for k in FLOAT_VIEWS:
        np.testing.assert_allclose(views[k].numpy(), ref_views[k],
                                   rtol=RTOL, err_msg=k)
    if stage == "07-prefetch":
        assert (views["weave_sat"] > 0).any()     # the budget ran out


def test_scalar_pace_gives_scalar_views():
    out = run_point(get_stage("03-ps-clock", windows=3, warmup=1), 4, 0,
                    device="cpu")
    assert all(v.dim() == 0 for v in out.values())
    assert out["n_rd"] > 0


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_stage("01-baseline", windows=2, warmup=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_point(cfg, 4, 0)
