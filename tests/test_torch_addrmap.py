"""Address mappings: the port's `decode` equals the reference's on every
mapping and preset, over the full uint32 line range (bit-31 lines
included), and the encoders round-trip."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addrmap as ref_addrmap
from repro.core.presets import PRESETS as REF_PRESETS
from repro_torch.core import addrmap
from repro_torch.core.presets import PRESETS
from repro_torch.core.timing import DramParams

torch.set_num_threads(1)

FIELDS = ("channel", "rank", "bank", "row", "col")


def _lines(seed, n=4096):
    rng = np.random.default_rng(seed)
    lines = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    lines[::4] |= np.uint64(1 << 31)
    lines[:3] = [0, (1 << 31), (1 << 32) - 1]
    return lines.astype(np.uint32)


def _assert_same(port, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("mapping", ["simple", "skylake_xor"])
@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_decode_matches_reference(preset, mapping):
    lines = _lines(len(preset) * 10 + len(mapping))
    port = addrmap.decode(torch.from_numpy(lines.astype(np.int64)), mapping,
                          dram=PRESETS[preset])
    ref = ref_addrmap.decode(jnp.asarray(lines), mapping,
                             dram=REF_PRESETS[preset])
    _assert_same(port, ref)
    assert addrmap.check_fields(port, PRESETS[preset])
    np.testing.assert_array_equal(
        port.flat_bank_for(PRESETS[preset]).numpy(),
        np.asarray(ref.flat_bank_for(REF_PRESETS[preset])))


def test_direct_mappings_match_reference():
    lines = _lines(11)
    x = torch.from_numpy(lines.astype(np.int64))
    _assert_same(addrmap.decode_skylake_xor(x),
                 ref_addrmap.decode_skylake_xor(jnp.asarray(lines)))
    _assert_same(addrmap.decode_simple(x),
                 ref_addrmap.decode_simple(jnp.asarray(lines)))
    for name in PRESETS:
        _assert_same(addrmap.decode_xor_fold(x, PRESETS[name]),
                     ref_addrmap.decode_xor_fold(jnp.asarray(lines),
                                                 REF_PRESETS[name]))
    # the default geometry goes through the addr_decode wrapper and
    # agrees with the direct decode, field by field
    _assert_same(addrmap.decode(x, "skylake_xor"),
                 ref_addrmap.decode_skylake_xor(jnp.asarray(lines)))
    with pytest.raises(ValueError, match="unknown mapping"):
        addrmap.decode(x, "banked")


@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_encode_simple_round_trips(preset):
    d = PRESETS[preset]
    cap = (d.n_channels * d.lines_per_row * d.ranks_per_channel
           * d.banks_per_rank * d.rows_per_bank)
    lines = np.random.default_rng(3).integers(
        0, min(cap, 2 ** 32), 2048).astype(np.uint32)
    dec = addrmap.decode_simple(torch.from_numpy(lines.astype(np.int64)), d)
    back = addrmap.encode_simple(dec, d)
    np.testing.assert_array_equal(back, lines)
    np.testing.assert_array_equal(
        back, ref_addrmap.encode_simple(
            ref_addrmap.decode_simple(jnp.asarray(lines), dram=d), d))


def test_encode_xor_fold_round_trips_and_refuses_real_presets():
    geo = DramParams(n_channels=4, ranks_per_channel=2, banks_per_rank=4,
                     bank_groups=2, cols_per_row=128, rows_per_bank=1 << 12)
    assert addrmap.xor_fold_encodable(geo) is None
    rng = np.random.default_rng(5)
    fields = addrmap.DecodedAddr(
        channel=rng.integers(0, 4, 512), rank=rng.integers(0, 2, 512),
        bank=rng.integers(0, 4, 512), row=rng.integers(0, 1 << 12, 512),
        col=rng.integers(0, geo.lines_per_row, 512))
    lines = addrmap.encode_xor_fold(fields, geo)
    np.testing.assert_array_equal(
        lines, ref_addrmap.encode_xor_fold(
            ref_addrmap.DecodedAddr(*fields), geo))
    dec = addrmap.decode_xor_fold(torch.from_numpy(lines.astype(np.int64)),
                                  geo)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(dec, f).numpy(),
                                      getattr(fields, f))
    for name, d in PRESETS.items():
        assert (addrmap.xor_fold_encodable(d)
                == ref_addrmap.xor_fold_encodable(d)), name
        with pytest.raises(ValueError, match="not xor_fold-encodable"):
            addrmap.encode_xor_fold(fields, d)
