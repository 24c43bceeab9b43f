// FR-FCFS eligibility + select for the DRAM weave step, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `frfcfs_select` / `_select_kernel`
// (src/repro/kernels/bank_timing/kernel.py:97, body :36-92).  For every
// queue slot of one (batch, channel) row it evaluates RD/WR CAS, ACT and
// PRE eligibility under the DDR timing set, scores the slot FR-FCFS style
// (CAS > ACT > PRE, oldest first, optional row-hit-cap inversion), takes
// the masked argmax (lowest slot on ties, like jnp.argmax) and returns
// the winner's slot and command code.
//
// What bounds it on an H100: per row it reads 11 planes of Q int32 plus
// 8 scalars and writes 2 int32 -- ~11 KB per row at Q = 256, ~68 KB per
// DDR4 operating point.  That is well under a microsecond of HBM time at
// 3.35 TB/s, so a launch costs its latency, not its bytes.  The design
// keeps the whole row inside one warp: each lane strides over the slots
// (coalesced 128-byte loads per plane), keeps its own best (score, slot,
// eligibility bits), and a shuffle reduction finishes the argmax with no
// shared memory and no second pass.  The eligibility, score and command
// decode are frfcfs.cuh's, shared with weave_window.cu, which runs whole
// windows of weave steps in one launch on the card's main path; this
// kernel serves the stepwise route.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "frfcfs.cuh"

namespace {

// scalar plane columns
constexpr int kT = 0, kBusFree = 1, kWtr = 2, kRtw = 3, kDrain = 4,
              kStreak = 5, kNScalars = 8;
constexpr int kWarpsPerBlock = 4;

struct Planes {
  const int32_t* __restrict__ arrived;
  const int32_t* __restrict__ is_write;
  const int32_t* __restrict__ row;
  const int32_t* __restrict__ open_e;
  const int32_t* __restrict__ nrd;
  const int32_t* __restrict__ nwr;
  const int32_t* __restrict__ nact;
  const int32_t* __restrict__ npre;
  const int32_t* __restrict__ faw_ok;
  const int32_t* __restrict__ hit_pend;
  const int32_t* __restrict__ arrival;
};

__global__ void frfcfs_select_kernel(Planes p,
                                     const int32_t* __restrict__ scalars,
                                     int32_t* __restrict__ out, int rows,
                                     int q, int row_hit_cap) {
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp leaves together

  const int32_t* s = scalars + static_cast<size_t>(r) * kNScalars;
  const frfcfs::Channel ch =
      frfcfs::make_channel(s[kT], s[kBusFree], s[kWtr], s[kRtw],
                           s[kDrain] == 1, s[kStreak], row_hit_cap);

  int best = -1;
  int best_i = INT_MAX;
  int best_bits = 0;
  const size_t base = static_cast<size_t>(r) * q;
  for (int i = lane; i < q; i += 32) {
    const size_t k = base + i;
    const frfcfs::Slot slot{p.arrived[k] == 1, p.is_write[k] == 1,
                            p.open_e[k],       p.row[k],
                            p.nrd[k],          p.nwr[k],
                            p.nact[k],         p.npre[k],
                            p.faw_ok[k] == 1,  p.hit_pend[k] != 0,
                            p.arrival[k]};
    int bits;
    const int sc = frfcfs::score(slot, ch, &bits);
    if (sc > best) {  // strict: a lane visits slots in increasing order
      best = sc;
      best_i = i;
      best_bits = bits;
    }
  }

  // warp argmax over (score, slot): the lowest slot wins a tie
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    const int ob = __shfl_down_sync(0xffffffffu, best_bits, off);
    if (os > best || (os == best && oi < best_i)) {
      best = os;
      best_i = oi;
      best_bits = ob;
    }
  }

  if (lane == 0) {
    out[2 * static_cast<size_t>(r)] = best_i;
    out[2 * static_cast<size_t>(r) + 1] =
        frfcfs::command(best, best_bits, ch.capped);
  }
}

}  // namespace

// (rows, q) int32 planes + (rows, 8) int32 scalars -> (rows, 2) int32
// (slot, command).  Launches on `stream`; returns cudaGetLastError().
extern "C" int frfcfs_select_launch(
    const void* arrived, const void* is_write, const void* row,
    const void* open_e, const void* nrd, const void* nwr, const void* nact,
    const void* npre, const void* faw_ok, const void* hit_pend,
    const void* arrival, const void* scalars, void* out, int rows, int q,
    int row_hit_cap, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  Planes p{static_cast<const int32_t*>(arrived),
           static_cast<const int32_t*>(is_write),
           static_cast<const int32_t*>(row),
           static_cast<const int32_t*>(open_e),
           static_cast<const int32_t*>(nrd),
           static_cast<const int32_t*>(nwr),
           static_cast<const int32_t*>(nact),
           static_cast<const int32_t*>(npre),
           static_cast<const int32_t*>(faw_ok),
           static_cast<const int32_t*>(hit_pend),
           static_cast<const int32_t*>(arrival)};
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  frfcfs_select_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(scalars), static_cast<int32_t*>(out),
      rows, q, row_hit_cap);
  return static_cast<int>(cudaGetLastError());
}
