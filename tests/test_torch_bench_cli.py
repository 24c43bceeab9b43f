"""The port's benchmark CLI: `repro_torch.bench.registry`, `bench.run`
and `bench.kernels_bench`, and `bench.app_validation`'s entry points,
against the JAX package's ``benchmarks/`` on the CPU.

The registry is alphabetized and holds the reference's names but
``roofline``; every entry resolves its ``main``; ``run`` lists them,
refuses an unknown name and runs a benchmark by name into ``--out-dir``
(never into ``reports/benchmarks/``), with the same CSV as a direct
call; the kernels bench raises without a card, and its inputs are the
reference's cases.
"""
import inspect
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.bench import app_validation, kernels_bench, registry, run
from repro_torch.bench import fig5_model_correct, util

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_registry():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import registry as ref
    finally:
        sys.path.remove(str(ROOT))
    return ref


def test_registry_is_alphabetized():
    names = list(registry.BENCHMARKS)
    assert names == sorted(names) and len(names) == 12
    for spec in registry.BENCHMARKS.values():
        assert spec.name and spec.description
        assert spec.module.startswith("repro_torch.bench.")


def test_names_are_the_references_but_roofline(ref_registry):
    ref = ref_registry.BENCHMARKS
    assert list(registry.BENCHMARKS) == [n for n in ref if n != "roofline"]
    for name, spec in registry.BENCHMARKS.items():
        want = ref[name]
        assert spec.main_attr == want.main_attr, name
        assert spec.reports == want.reports, name
        assert spec.module.split(".")[-1] == want.module.split(".")[-1]
        if name != "kernels":
            assert spec.description == want.description, name


@pytest.mark.parametrize("name", sorted(registry.BENCHMARKS))
def test_every_spec_resolves_a_main_that_takes_full(name):
    main = registry.get_benchmark(name).main
    params = inspect.signature(main).parameters
    assert "full" in params and params["full"].default is False
    # every benchmark but the kernels bench writes into an output directory
    assert name == "kernels" or run._takes(main, "out_dir"), name
    assert run._takes(main, "device"), name


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown benchmark 'nope'"):
        registry.get_benchmark("nope")
    with pytest.raises(ValueError, match="unknown benchmark 'nope'"):
        run.main(["--only", "fig5,nope", "--device", "cpu"])


def test_run_list_prints_every_name(capsys):
    run.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(registry.BENCHMARKS)


def _tree(path):
    return {p: p.stat().st_mtime_ns for p in path.rglob("*")} \
        if path.exists() else {}


def test_run_only_writes_into_out_dir(tmp_path, monkeypatch, capsys):
    """fig5 at a cut grid through the CLI on the CPU: its CSV in
    ``--out-dir``, equal to a direct call's, and nothing written under
    ``reports/benchmarks/``."""
    monkeypatch.setattr(util, "FAST_WINDOWS", dict(windows=2, warmup=0))
    monkeypatch.setattr(util, "FAST_PACES", (1, 24))
    monkeypatch.setattr(util, "FAST_MIXES", (0,))
    tracked = _tree(ROOT / "reports" / "benchmarks")
    run.main(["--only", "fig5", "--device", "cpu", "--out-dir",
              str(tmp_path / "cli")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert any(ln.startswith("fig5.") for ln in out[1:])
    fig5_model_correct.main(device="cpu", out_dir=tmp_path / "direct")
    got = (tmp_path / "cli" / "fig5_model_correct.csv").read_text()
    assert got == (tmp_path / "direct" / "fig5_model_correct.csv").read_text()
    assert len(got.splitlines()) == 3              # header + 2 points
    assert sorted(p.name for p in (tmp_path / "cli").iterdir()) == [
        "fig5_model_correct.csv"]
    assert _tree(ROOT / "reports" / "benchmarks") == tracked


def test_run_forwards_only_what_a_main_takes(monkeypatch):
    seen = {}

    def kernels_main(full=False, device=None):
        seen["kernels"] = dict(full=full, device=device)

    def mix_main(full=False, **kw):
        seen["app_mix"] = dict(full=full, **kw)

    monkeypatch.setattr(registry.BenchSpec, "main", property(
        lambda spec: {"kernels": kernels_main,
                      "app_mix": mix_main}[spec.name]))
    run.main(["--only", "kernels,app_mix", "--full", "--preset", "hbm2e",
              "--device", "cpu", "--out-dir", "d"])
    assert seen == {"kernels": dict(full=True, device="cpu"),
                    "app_mix": dict(full=True, preset="hbm2e",
                                    device="cpu", out_dir="d")}


def test_kernels_bench_raises_without_a_card(monkeypatch):
    for device in ("cpu", None):
        with pytest.raises(RuntimeError, match="never times a plain"):
            kernels_bench.main(device=device)
    with pytest.raises(RuntimeError, match="never times a plain"):
        run.main(["--only", "kernels", "--device", "cpu"])


def test_kernels_bench_inputs_are_the_references_cases():
    """The reference's ``bench_bank_timing`` and ``bench_addr_decode``
    inputs, drawn the same way: the plain versions on them give the
    reference's answers."""
    import jax.numpy as jnp
    from repro.kernels.addr_decode import decode_reference
    from repro.kernels.bank_timing import (pack_scalars, scalars_tuple,
                                           select_reference)
    from repro_torch.kernels.addr_decode import decode_packed_plain, unpack
    from repro_torch.kernels.bank_timing import select_plain

    rng = np.random.default_rng(1)                 # the reference's code
    C, Q = 6, 256
    r = lambda hi, shape=(C, Q): jnp.asarray(      # noqa: E731
        rng.integers(0, hi, size=shape, dtype=np.int32))
    args = [r(2), r(2), r(8), r(8) - 1, r(100), r(100), r(100), r(100),
            r(2), r(2), r(1000)]
    ch = pack_scalars(jnp.int32(50), r(100, (C,)), r(100, (C,)),
                      r(100, (C,)), r(2, (C,)), r(8, (C,)))
    planes, scal = kernels_bench.select_inputs(torch.device("cpu"))
    for got, want in zip(planes + [scal], args + [ch]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sel, cmd = select_plain(*planes, scal)
    want_sel, want_cmd = select_reference(*args, scalars_tuple(ch))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    np.testing.assert_array_equal(cmd.numpy(), np.asarray(want_cmd))

    rng = np.random.default_rng(2)
    lines = rng.integers(0, 2 ** 32, 1 << 16, dtype=np.uint32)
    got = kernels_bench.decode_inputs(torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), lines.astype(np.int64))
    fields = unpack(decode_packed_plain(got))
    want = decode_reference(jnp.asarray(lines))
    for name, g in zip(("channel", "rank", "bank", "row", "col"), fields):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_app_validation_entry_points_are_the_references(monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import app_validation as ref
    finally:
        sys.path.remove(str(ROOT))
    for fn in ("main", "main_mix"):
        want = inspect.signature(getattr(ref, fn)).parameters
        got = inspect.signature(getattr(app_validation, fn)).parameters
        assert list(got)[:len(want)] == list(want), fn
        for name, p in want.items():
            assert got[name].default == p.default, (fn, name)
    assert list(inspect.signature(app_validation.main).parameters)[
        len(inspect.signature(ref.main).parameters):] == ["device",
                                                          "out_dir"]
    calls = []

    def fake(kind):
        def run_one(preset, full, sockets, device, out_dir):
            calls.append((kind, preset, full, sockets, device, out_dir))
            return kind
        return run_one

    monkeypatch.setattr(app_validation, "run_preset", fake("solo"))
    monkeypatch.setattr(app_validation, "run_mixes", fake("mix"))
    assert app_validation.main(preset="hbm2e", device="cpu") == {
        "hbm2e": "solo"}
    assert app_validation.main_mix(full=True, out_dir="d") == dict.fromkeys(
        app_validation.PRESET_ORDER, "mix")
    assert app_validation.main_mix(grid=False, sockets=2) == {
        "ddr4_2666": "mix"}
    assert calls[0] == ("solo", "hbm2e", False, 1, "cpu", None)
    assert calls[1] == ("mix", app_validation.PRESET_ORDER[0], True, 1,
                        None, "d")
    assert calls[-1] == ("mix", "ddr4_2666", False, 2, None, None)
