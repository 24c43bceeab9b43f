"""The scenario fuzzer on the port, held against the JAX package.

Each seed of ``tests/test_fuzz_oracle.py`` (``REPRO_FUZZ_N``, 8 by
default) is drawn again by `repro_torch.oracle.fuzz.draw_scenario` and
replayed on the CPU with ``cmd_trace=True``.  The port's recorded stream
must be protocol-legal under `repro_torch.oracle.check_stream`, and its
``cmd_*`` records, its integer views and its stream must equal the
reference's on the same scenario (the reference's own ``draw_scenario``
from the same seed, whose description must match).

A failing seed reproduces alone with ``REPRO_FUZZ_N=<seed+1> pytest
tests/test_torch_fuzz_oracle.py -k <seed>``.  JAX is imported by the
reference's side only.
"""
import numpy as np
import pytest
import torch

from repro_torch.oracle import fuzz
from repro_torch.oracle.stream import CMD_KEYS

torch.set_num_threads(1)

#: the integer views (the float views follow from them by arithmetic the
#: platform tests hold separately)
INT_VIEWS = ("n_rd", "n_wr", "injected", "weave_events", "weave_sat")


def ref_run(seed):
    """The reference's scenario and views for ``seed``."""
    import jax
    from test_fuzz_oracle import draw_scenario
    from repro.oracle import extract_stream
    rng = np.random.default_rng(fuzz.SEED_BASE + seed)
    desc, cfg, frontend = draw_scenario(rng)
    views, _ = jax.device_get(jax.jit(frontend(cfg))())
    return desc, views, extract_stream(views, cfg.platform.dram)


@pytest.mark.parametrize("seed", range(fuzz.N_SEEDS))
def test_fuzzed_stream_is_legal_and_equals_reference(seed):
    scn = fuzz.draw_scenario(seed)
    views = fuzz.run(scn, device="cpu")
    got, rep = fuzz.check(scn, views)
    assert len(got) > 0, scn.desc
    assert rep.ok, f"{scn.desc}: {rep.summary()}\n{rep.violations[:5]}"

    desc, ref_views, want = ref_run(seed)
    assert scn.desc == desc
    for k in CMD_KEYS + INT_VIEWS:
        g, w = views[k].numpy(), np.asarray(ref_views[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (desc, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{desc}: {k}")
    for f in ("t", "cmd", "channel", "rank", "bank", "row"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{desc}: {f}")
