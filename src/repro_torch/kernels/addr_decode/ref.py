"""Plain PyTorch version of the Skylake XOR address-decode kernel.

Line indices travel as int64 in ``[0, 2**32)`` (torch has no ``>>`` or
``%`` on uint32), so every step below equals the reference's uint32
arithmetic.  The packed word (ch 3b | rank 1b | bank 4b | col 7b |
row 17b) is returned as its int32 bit pattern, like the kernel's.
"""
from __future__ import annotations

import torch

# packed-field shifts / widths
CH_SH, CH_W = 0, 3
RANK_SH, RANK_W = 3, 1
BANK_SH, BANK_W = 4, 4
COL_SH, COL_W = 8, 7
ROW_SH, ROW_W = 15, 17


def _bit(x, i):
    return (x >> i) & 1


def to_int32_bits(x):
    """int64 in ``[0, 2**32)`` -> the int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def decode_packed_plain(lines):
    """int64 line indices -> packed coordinates as int32 bit patterns."""
    line = lines.to(torch.int64) & 0xFFFFFFFF
    mc = _bit(line, 0) ^ _bit(line, 6) ^ _bit(line, 11) ^ _bit(line, 17)
    ch3 = ((line >> 1) ^ (line >> 7) ^ (line >> 13) ^ (line >> 19)) % 3
    ch = mc * 3 + ch3
    bank = ((_bit(line, 2) ^ _bit(line, 12))
            | ((_bit(line, 3) ^ _bit(line, 14)) << 1)
            | ((_bit(line, 4) ^ _bit(line, 15)) << 2)
            | ((_bit(line, 5) ^ _bit(line, 16)) << 3))
    rank = _bit(line, 8) ^ _bit(line, 18)
    col = (line ^ (line >> 9)) % 128
    row = (line >> 9) & 0x1FFFF
    packed = (ch | (rank << RANK_SH) | (bank << BANK_SH) | (col << COL_SH)
              | (row << ROW_SH))
    return to_int32_bits(packed)


def unpack(packed):
    """Packed int32 bit patterns -> (channel, rank, bank, row, col) int32."""
    p = packed.to(torch.int64) & 0xFFFFFFFF

    def field(sh, w):
        return ((p >> sh) & ((1 << w) - 1)).to(torch.int32)

    return (field(CH_SH, CH_W), field(RANK_SH, RANK_W),
            field(BANK_SH, BANK_W), field(ROW_SH, ROW_W),
            field(COL_SH, COL_W))
