// DRAMDig Skylake XOR-folded address decode of one cache line, shared by
// the standalone decode kernel (addr_decode.cu) and the interface-window
// kernel (window_inject.cu).
//
// The body of the Pallas TPU kernel `decode_packed` / `_decode_kernel`
// (src/repro/kernels/addr_decode/kernel.py:36-53): the MC-select XOR, the
// mod-3 channel fold, the bank-group/bank and rank XORs, the column fold
// and the row bits of a 32-bit cache-line index, on the DDR4 geometry
// (6 channels, 2 ranks, 16 banks, 128 lines a row, 2^17 rows).
#pragma once

#include <cstdint>

namespace addr_decode {

struct Fields {
  uint32_t ch, rank, bank, col, row;
};

__device__ __forceinline__ uint32_t bit(uint32_t x, int i) {
  return (x >> i) & 1u;
}

__device__ __forceinline__ Fields skylake_xor(uint32_t l) {
  const uint32_t mc = bit(l, 0) ^ bit(l, 6) ^ bit(l, 11) ^ bit(l, 17);
  const uint32_t ch3 = ((l >> 1) ^ (l >> 7) ^ (l >> 13) ^ (l >> 19)) % 3u;
  const uint32_t bg0 = bit(l, 2) ^ bit(l, 12);
  const uint32_t bg1 = bit(l, 3) ^ bit(l, 14);
  const uint32_t ba0 = bit(l, 4) ^ bit(l, 15);
  const uint32_t ba1 = bit(l, 5) ^ bit(l, 16);
  Fields f;
  f.ch = mc * 3u + ch3;
  f.bank = bg0 | (bg1 << 1) | (ba0 << 2) | (ba1 << 3);
  f.rank = bit(l, 8) ^ bit(l, 18);
  f.col = (l ^ (l >> 9)) % 128u;
  f.row = (l >> 9) & 0x1FFFFu;
  return f;
}

// ch 3b | rank 1b << 3 | bank 4b << 4 | col 7b << 8 | row 17b << 15
__device__ __forceinline__ uint32_t pack(const Fields& f) {
  return f.ch | (f.rank << 3) | (f.bank << 4) | (f.col << 8) | (f.row << 15);
}

}  // namespace addr_decode
