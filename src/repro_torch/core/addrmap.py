"""Physical-address -> (channel, rank, bank, row, col) mappings.

The paper (Sec. 4, Fig. 6a) shows that the simulators' *simple*
mapping hides the read/write-mix latency gradient of real hardware and
that the mapping reverse-engineered by DRAMDig restores it:

* ``simple``      — Ramulator-style RoBaRaCoCh: ch | col | rank | bank
                    | row from low to high line bits.
* ``skylake_xor`` — DRAMDig-style XOR-folded Skylake mapping.  On the
                    DDR4 geometry it runs the ``addr_decode`` kernel
                    (its plain version on the CPU); on any other preset
                    it falls back to `decode_xor_fold`.

Line indices are int64 tensors holding uint32 values (``[0, 2**32)``):
torch has no ``>>``, ``%`` or ``//`` on uint32, and on non-negative
int64 those operations equal the reference's uint32 ones.  Fields come
back as int32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.timing import DramParams
from repro_torch.kernels.addr_decode import decode_packed, unpack

LINES_PER_ROW = 128        # 8 KB row / 64 B line
N_BANKS = 16               # banks per rank (4 groups x 4)
N_RANKS = 2
N_CHANNELS = 6
_U32 = 0xFFFFFFFF


class DecodedAddr(NamedTuple):
    channel: torch.Tensor  # [0, n_channels)
    rank: torch.Tensor     # [0, ranks_per_channel)
    bank: torch.Tensor     # [0, banks_per_rank)
    row: torch.Tensor      # [0, rows_per_bank)
    col: torch.Tensor      # [0, lines_per_row) line-within-row

    def flat_bank_for(self, dram: DramParams):
        """Geometry-aware bank-state index: rank * banks_per_rank + bank."""
        return self.rank * dram.banks_per_rank + self.bank


def _lines(line) -> torch.Tensor:
    return torch.as_tensor(line).to(torch.int64) & _U32


def _bit(x, i):
    return (x >> i) & 1


def _i32(x):
    return x.to(torch.int32)


def decode_simple(line, dram: DramParams | None = None) -> DecodedAddr:
    """RoBaRaCoCh: ch | col | rank | bank | row  (low -> high bits)."""
    C = dram.n_channels if dram else N_CHANNELS
    R = dram.ranks_per_channel if dram else N_RANKS
    B = dram.banks_per_rank if dram else N_BANKS
    lpr = dram.lines_per_row if dram else LINES_PER_ROW
    row_mask = (dram.rows_per_bank if dram else (1 << 17)) - 1
    line = _lines(line)
    ch = line % C
    a = line // C
    col = a % lpr
    a = a // lpr
    rank = a % R
    a = a // R
    bank = a % B
    row = (a // B) & row_mask
    return DecodedAddr(_i32(ch), _i32(rank), _i32(bank), _i32(row), _i32(col))


def decode_skylake_xor(line) -> DecodedAddr:
    """DRAMDig-style XOR-folded Skylake mapping (DDR4 geometry).

    2 memory controllers x 3 channels: the MC select and the 3-way
    channel select hash low and high (row) bits; bank-group / bank bits
    XOR row bits in.
    """
    line = _lines(line)
    mc = _bit(line, 0) ^ _bit(line, 6) ^ _bit(line, 11) ^ _bit(line, 17)
    ch3 = ((line >> 1) ^ (line >> 7) ^ (line >> 13) ^ (line >> 19)) % 3
    ch = mc * 3 + ch3
    bg0 = _bit(line, 2) ^ _bit(line, 12)
    bg1 = _bit(line, 3) ^ _bit(line, 14)
    ba0 = _bit(line, 4) ^ _bit(line, 15)
    ba1 = _bit(line, 5) ^ _bit(line, 16)
    bank = bg0 | (bg1 << 1) | (ba0 << 2) | (ba1 << 3)
    rank = _bit(line, 8) ^ _bit(line, 18)
    col = (line ^ (line >> 9)) % LINES_PER_ROW
    row = (line >> 9) & 0x1FFFF
    return DecodedAddr(_i32(ch), _i32(rank), _i32(bank), _i32(row), _i32(col))


def decode_xor_fold(line, dram: DramParams) -> DecodedAddr:
    """Generic XOR-folded mapping for non-DDR4 geometries."""
    C = dram.n_channels
    R = dram.ranks_per_channel
    B = dram.banks_per_rank
    lpr = dram.lines_per_row
    row_mask = dram.rows_per_bank - 1
    line = _lines(line)
    mix = line ^ (line >> 6) ^ (line >> 12) ^ (line >> 18)
    ch = mix % C
    a = line // C
    col = (a ^ (a >> 9)) % lpr
    bank = ((a // lpr) ^ (line >> 13)) % B
    rank = ((line >> 8) ^ (line >> 17)) % R
    row = (line >> 9) & row_mask
    return DecodedAddr(_i32(ch), _i32(rank), _i32(bank), _i32(row), _i32(col))


def encode_simple(dec: DecodedAddr, dram: DramParams | None = None):
    """Inverse of `decode_simple` (numpy, any geometry, within capacity)."""
    C = dram.n_channels if dram else N_CHANNELS
    R = dram.ranks_per_channel if dram else N_RANKS
    B = dram.banks_per_rank if dram else N_BANKS
    lpr = dram.lines_per_row if dram else LINES_PER_ROW
    f = {k: np.asarray(v).astype(np.int64) for k, v in dec._asdict().items()}
    line = (((f["row"] * B + f["bank"]) * R + f["rank"]) * lpr
            + f["col"]) * C + f["channel"]
    return line.astype(np.uint32)


def xor_fold_encodable(dram: DramParams) -> str | None:
    """Why `encode_xor_fold` cannot invert this geometry (None = it can)."""
    bits = {}
    for name, n in (("channels", dram.n_channels),
                    ("ranks", dram.ranks_per_channel),
                    ("banks", dram.banks_per_rank),
                    ("lines_per_row", dram.lines_per_row),
                    ("rows_per_bank", dram.rows_per_bank)):
        b = int(n).bit_length() - 1
        if n <= 0 or (1 << b) != n:
            return f"{name}={n} is not a power of two"
        bits[name] = b
    if dram.ranks_per_channel > 2:
        return f"ranks={dram.ranks_per_channel} > 2 (one rank XOR bit)"
    if bits["channels"] > 6:
        return (f"channels={dram.n_channels} needs "
                f"{bits['channels']} > 6 bits (first XOR tap)")
    low = bits["channels"] + bits["lines_per_row"] + bits["banks"]
    if low > 8:
        return (f"channel+column+bank need {low} > 8 bits "
                "(collides with the rank bit)")
    return None


def encode_xor_fold(dec: DecodedAddr, dram: DramParams):
    """Inverse of `decode_xor_fold` on encodable geometries (numpy)."""
    reason = xor_fold_encodable(dram)
    if reason is not None:
        raise ValueError(f"geometry not xor_fold-encodable: {reason}")
    C, R = dram.n_channels, dram.ranks_per_channel
    B, lpr = dram.banks_per_rank, dram.lines_per_row
    cb = C.bit_length() - 1
    lb = lpr.bit_length() - 1
    f = {k: np.asarray(v).astype(np.int64) for k, v in dec._asdict().items()}
    line = f["row"] << 9
    if R == 2:
        line = line | ((f["rank"] ^ ((line >> 17) & 1)) << 8)
    line = line | ((f["bank"] ^ ((line >> 13) % B)) << (cb + lb))
    line = line | ((f["col"] ^ ((line >> (cb + 9)) % lpr)) << cb)
    line = line | ((f["channel"]
                    ^ ((line >> 6) ^ (line >> 12) ^ (line >> 18))) % C)
    return line.astype(np.uint32)


MAPPINGS = ("simple", "skylake_xor")

_DDR4_GEOMETRY = (N_CHANNELS, N_RANKS, N_BANKS, LINES_PER_ROW, 1 << 17)


def _is_default_geometry(dram: DramParams | None) -> bool:
    return dram is None or (
        dram.n_channels, dram.ranks_per_channel, dram.banks_per_rank,
        dram.lines_per_row, dram.rows_per_bank) == _DDR4_GEOMETRY


def decode_route(mapping: str, dram: DramParams | None = None) -> str:
    """The decode a mapping takes on a geometry: ``"simple"``,
    ``"skylake_xor"`` (the DDR4 geometry only) or ``"xor_fold"``."""
    if mapping not in MAPPINGS:
        raise ValueError(f"unknown mapping {mapping!r}; "
                         f"one of {sorted(MAPPINGS)}")
    if mapping == "simple" or _is_default_geometry(dram):
        return mapping
    return "xor_fold"


def decode(line, mapping: str = "simple",
           dram: DramParams | None = None) -> DecodedAddr:
    """Decode cache-line indices against a mapping + device geometry.

    ``"skylake_xor"`` on the DDR4 geometry goes through the
    ``addr_decode`` kernel wrapper; on another geometry it falls back to
    the generic `decode_xor_fold` (same scatter properties).
    """
    route = decode_route(mapping, dram)
    if route == "simple":
        return decode_simple(line, dram=dram)
    if route == "skylake_xor":
        return DecodedAddr(*unpack(decode_packed(_lines(line))))
    return decode_xor_fold(line, dram)


def check_fields(dec: DecodedAddr, dram: DramParams | None = None) -> bool:
    """Host-side range validation (used by property tests)."""
    d = dram or DramParams()
    f = {k: torch.as_tensor(v) for k, v in dec._asdict().items()}
    return bool(
        (f["channel"] >= 0).all() and (f["channel"] < d.n_channels).all()
        and (f["rank"] < d.ranks_per_channel).all()
        and (f["bank"] < d.banks_per_rank).all()
        and (f["row"] < d.rows_per_bank).all()
        and (f["col"] < d.lines_per_row).all()
    )
