// DRAMDig Skylake XOR-folded address decode, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `decode_packed` / `_decode_kernel`
// (src/repro/kernels/addr_decode/kernel.py:57, body :36-53).  Each
// 32-bit cache-line index maps to one packed word:
//   ch 3b | rank 1b << 3 | bank 4b << 4 | col 7b << 8 | row 17b << 15
// from the MC-select XOR, the mod-3 channel fold, the bank-group/bank and
// rank XORs, the column fold and the row bits (addr_decode.cuh, shared
// with window_inject.cu, which runs the same body on the main path).
//
// What bounds it on an H100: 4 bytes in and 4 bytes out per line and a
// few dozen integer operations, so it is bound by bytes -- and at the
// main path's size (B x 1920 lines per window) by launch latency.  The
// design is one thread per line over a grid-stride loop: consecutive
// threads touch consecutive words, so loads and stores coalesce, and the
// grid is capped so that a large batch reuses resident blocks.
#include <cuda_runtime.h>

#include <cstdint>

#include "addr_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each SM

__global__ void decode_packed_kernel(const uint32_t* __restrict__ lines,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = addr_decode::pack(addr_decode::skylake_xor(lines[i]));
}

}  // namespace

// (n,) uint32 line indices -> (n,) uint32 packed coordinates.  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int decode_packed_launch(const void* lines, void* out, int64_t n,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  decode_packed_kernel<<<static_cast<int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lines), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
