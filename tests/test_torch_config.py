"""The port's static configuration equals the reference's, field by field.

Stages, presets, clocks, NOC, backends and the ground-truth curve
families are host-side values; `stage_from_dict` carries a reference
`StageConfig` across through ``dataclasses.asdict``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import backends as ref_backends
from repro.core import clocking as ref_clocking
from repro.core import noc as ref_noc
from repro.core import presets as ref_presets
from repro.core import reference as ref_reference
from repro.core import stages as ref_stages
from repro_torch.core import backends, clocking, noc, presets, reference
from repro_torch.core import stages
from repro_torch.core.stages import stage_from_dict

torch.set_num_threads(1)


@pytest.mark.parametrize("n_sockets", [1, 2])
@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_stage_from_dict_equals_get_stage(preset, n_sockets):
    assert stages.STAGE_ORDER == ref_stages.STAGE_ORDER
    for name in stages.STAGE_ORDER:
        kw = dict(n_sockets=n_sockets) if n_sockets > 1 else {}
        ref = ref_stages.get_stage(name, preset=preset, **kw)
        port = stages.get_stage(name, preset=preset, **kw)
        assert stage_from_dict(dataclasses.asdict(ref)) == port, name
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert port.event_budget() == ref.event_budget(), name
        assert (dataclasses.asdict(port.workload_config())
                == dataclasses.asdict(ref.workload_config())), name


def test_presets_and_backends_equal_reference():
    assert presets.PRESET_ORDER == ref_presets.PRESET_ORDER
    for name in presets.PRESETS:
        assert (dataclasses.asdict(presets.get_preset(name))
                == dataclasses.asdict(ref_presets.get_preset(name)))
        assert (dataclasses.asdict(presets.platform_for(name))
                == dataclasses.asdict(ref_presets.platform_for(name)))
        assert (presets.get_preset(name).peak_gbs
                == ref_presets.get_preset(name).peak_gbs)
    with pytest.raises(ValueError, match="unknown device preset"):
        presets.get_preset("ddr3")
    for name in backends.BACKENDS:
        for delay in (False, True):
            assert (dataclasses.asdict(backends.make_policy(name, delay))
                    == dataclasses.asdict(ref_backends.make_policy(name,
                                                                   delay)))
    for kind in ("fixed", "mesh"):
        assert (dataclasses.asdict(noc.make_noc(kind))
                == dataclasses.asdict(ref_noc.make_noc(kind)))


@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_clocks_equal_reference(preset):
    plat = presets.platform_for(preset)
    ref_plat = ref_presets.platform_for(preset)
    for mode in clocking.CLOCK_MODES:
        clock = clocking.make_clock(mode, plat)
        ref = ref_clocking.make_clock(mode, ref_plat)
        assert dataclasses.asdict(clock) == dataclasses.asdict(ref), mode
        assert (clock.ticks_per_window_static
                == ref.ticks_per_window_static), mode
        assert (clock.events_per_window_static
                == ref.events_per_window_static), mode
        for ticks in (100, 500, 635, 1000):
            assert (clocking.event_budget(ticks, plat.dram)
                    == ref_clocking.event_budget(ticks, ref_plat.dram))
        w = np.arange(200)
        np.testing.assert_array_equal(clock.window_start_tick(w),
                                      ref.window_start_tick(w))
        np.testing.assert_array_equal(clock.tick_to_cpu_ps(w * 37),
                                      ref.tick_to_cpu_ps(w * 37))
    assert (clocking.reference_listing_1b(300, plat)
            == ref_clocking.reference_listing_1b(300, ref_plat))


def test_documented_step_counts():
    assert clocking.make_clock("picosecond").ticks_per_window_static == 635
    assert stages.get_stage("04-model-correct").event_budget() == 199


@pytest.mark.parametrize("flag", ["telemetry", "cmd_trace"])
def test_recorder_flags_build_and_sweep_refuses_cmd_trace(flag):
    from repro.core import mess as ref_mess
    from repro_torch.core import mess

    cfg = stages.get_stage("07-prefetch", **{flag: True})
    ref = ref_stages.get_stage("07-prefetch", **{flag: True})
    assert getattr(cfg, flag) and cfg == stage_from_dict(
        dataclasses.asdict(ref))
    if flag == "telemetry":
        return
    with pytest.raises(ValueError) as want:
        ref_mess.sweep(ref, paces=(4,), write_mixes=(0,))
    for device in (None, "cpu"):
        with pytest.raises(ValueError) as got:
            mess.sweep(cfg, paces=(4,), write_mixes=(0,), device=device)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_reference_curves_equal(preset):
    bw = np.linspace(0.0, 400.0, 41)
    for frac in (1.0, 0.87, 0.75, 0.62, 0.5):
        np.testing.assert_array_equal(
            reference.latency_ns(bw, frac, preset),
            ref_reference.latency_ns(bw, frac, preset))
        assert (reference.max_bandwidth_gbs(frac, preset)
                == ref_reference.max_bandwidth_gbs(frac, preset))
        for a, b in zip(reference.curve(frac, 16, preset),
                        ref_reference.curve(frac, 16, preset)):
            np.testing.assert_array_equal(a, b)
    assert reference.unloaded_ns(preset) == ref_reference.unloaded_ns(preset)
