"""The Mess sweep: the port's `sweep` against the reference's on a small
grid, the knee routing between the weave engines, and the dense re-run
of event points that run out of budget."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import get_stage as ref_get_stage
from repro.core import mess as ref_mess
from repro_torch.core import get_stage, mess, run_point

torch.set_num_threads(1)

#: sweep arrays are float32 views aggregated over windows (XLA's own
#: reduction order in the reference)
RTOL = 1e-6


def test_sweep_matches_reference():
    kw = dict(windows=8, warmup=2)
    paces, mixes = (1, 4, 16), (0, 32)
    ref_cfg, cfg = ref_get_stage("05-addrmap", **kw), get_stage("05-addrmap",
                                                                **kw)
    ref = ref_mess.sweep(ref_cfg, paces=paces, write_mixes=mixes)
    res = mess.sweep(cfg, paces=paces, write_mixes=mixes, device="cpu")
    assert (res.stage, res.paces, res.write_mixes) == (
        ref.stage, ref.paces, ref.write_mixes)
    for f in ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
              "chase_lat"):
        got, want = getattr(res, f), getattr(ref, f)
        assert got.shape == want.shape == (2, 3), f
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f)
    assert res.to_rows() == pytest.approx(ref.to_rows(), rel=RTOL)
    assert mess.unloaded_latency_ns(res) == pytest.approx(
        ref_mess.unloaded_latency_ns(ref), rel=RTOL)


def test_routing_and_calibration_match_reference():
    assert (mess.load_event_calibration()
            == ref_mess.load_event_calibration())
    for stage in ("05-addrmap", "07-prefetch", "10-delay-buffer"):
        for preset in ("ddr4_2666", "ddr5_4800", "hbm2e"):
            cfg = get_stage(stage, preset=preset)
            ref_cfg = ref_get_stage(stage, preset=preset)
            for pace in mess.DEFAULT_PACES:
                assert (mess.event_covers(cfg, pace)
                        == ref_mess.event_covers(ref_cfg, pace)), (
                    stage, preset, pace)


def test_saturated_event_points_rerun_dense(monkeypatch):
    """An event point that runs out of budget is re-run dense, so the
    merged row equals an all-dense run, bit for bit."""
    cfg = get_stage("04-model-correct", windows=2, warmup=0)
    monkeypatch.setattr(mess, "event_covers", lambda cfg, pace: True)
    merged = mess._run_mix(cfg, (2, 48), 16, device="cpu")
    dense = run_point(dataclasses.replace(cfg, weave="dense"), [2, 48], 16,
                      device="cpu")
    for k, v in dense.items():
        if k not in ("weave_events", "weave_sat"):
            np.testing.assert_array_equal(merged[k], v.numpy(), err_msg=k)
    # the pace-48 point came from the dense engine: a full tick count
    assert merged["weave_sat"].tolist() == [0, 0]
    assert merged["weave_events"][1] == dense["weave_events"][1]
    assert merged["weave_events"][0] < dense["weave_events"][0]
