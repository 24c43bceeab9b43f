// The interface of one window -- bound phase, address decode, admission
// and queue scatter -- for a batch of points in one launch, by hand for
// Hopper.  A template over the bound-phase frontend,
// `window_inject_kernel<Frontend>`, with two instances: the Mess pace
// generator's (`MessGen`, C entry `window_inject_launch`) and the trace
// replay's (`TraceGen`, `window_inject_trace_launch`).
//
// Replaces the Pallas TPU kernel `decode_packed` / `_decode_kernel`
// (src/repro/kernels/addr_decode/kernel.py:57) together with the eager
// code around it on the main paths (the reference's window step,
// src/repro/core/platform.py:146-156; the port's `_bound_inject_eager`):
//   * the MSHR budget `littles_law_budget` and `l_ir_cycles`;
//   * the bound phase of the frontend -- Mess: `workload.generate`
//     (traffic quota, the 64-line stream segments, the write mix, issue
//     cycles, the stage-07 prefetch candidates); trace:
//     `TraceFrontend.bound` (src/repro/traces/frontend.py:124-212; the
//     port's traces/frontend.py; each core's 64 accesses at its clamped
//     cursor, their cost under the MSHR closed loop, the finish-time and
//     wrapped line-sum scans, the take, the hashed phase within the
//     footprint, the region base) -- and `chase_probe`;
//   * the decode of every candidate under `decode_simple`, the Skylake XOR
//     body of `decode_packed` (addr_decode.cuh) or `decode_xor_fold`,
//     and the partitioned-socket channel override;
//   * the admission of `inject_queue`: a stable ranking by channel, chase
//     first, issue cycle, core and flat index (`jnp.argsort` at
//     src/repro/core/workload.py:312), each channel's free slots taken in
//     slot order (the stable argsort at :321), and the scatter of the
//     seven queue planes, arrival through `cycle_to_tick`;
//   * the frontend's `update` -- Mess: backlog, stream position and chase
//     carry; trace: cursors, line sums, cycle carries and the probe's
//     position and carry.
// The eager route runs a few hundred small PyTorch ops a window for the
// same work, two radix sorts among them; this kernel must agree with it
// bit for bit.
//
// What bounds it on an H100: not bytes (the seven queue planes in and out
// and the core state are ~1 MB a launch at 12 points, a third of a
// microsecond of HBM time) and not operations (a few thousand candidates
// a point).  It is latency: a chain of dependent phases, the ranking a
// sort.  So the design keeps a point on one SM:
//   * one block of 1024 threads per point; every candidate of the point
//     (24 cores x 80 = 1920 a socket) is generated and decoded by one
//     thread into a 64-bit sort key in shared memory: the int32 admission
//     value of the reference (bias-flipped, so unsigned order is signed
//     order) above the flat index, which makes every key unique and the
//     order the stable one;  invalid candidates take the largest value;
//   * a bitonic sort of the keys in shared memory (2048 or 4096 keys, 16
//     or 32 KB; one barrier a stage);
//   * the valid candidates per channel counted with shared atomics, and
//     each channel's free slots ranked by warp ballots and a per-chunk
//     prefix, so slot s of channel c, the r-th free one, takes the r-th
//     candidate of c in the sorted order when r < count(c): every slot is
//     written once, with its new or its old value, and the candidate's
//     fields are found again from its flat index;
//   * Mess: a candidate is generated again from its flat index (no
//     per-candidate state kept), and the accepted demand per core is
//     counted with shared integer atomics, which are exact whatever their
//     order;
//   * trace: a candidate depends on its core's prefix (the finish time of
//     its cost and the wrapped sum of its deltas), so each core's 64
//     accesses are read coalesced by one warp, two a lane, scanned with
//     warp shuffles, and the line, issue cycle and flags of each kept in
//     shared memory (~29 KB for 51 cores, beside the 32 KB of keys: the
//     instance takes dynamic shared memory above 48 KB).  The trace
//     frontend drops rejected demand, so nothing is counted per core.
// Integer arithmetic wraps like int32 tensors (done in unsigned) and
// divides with torch's floor semantics and remainder; uint32 hashes are
// native.  The budget divides in float32 with IEEE rounding
// (`__fdiv_rn`), and `l_ir` rounds half to even (`rintf`), as torch does.
//
// Packed parameter vector, in the order of PARAM_NAMES in ops.py:
//   n_cores n_traffic n_channels q ranks banks_per_rank lines_per_row
//   row_mask mapping channels_per_socket window_cycles w_cycles
//   cache_path_cycles noc_req_cycles noc_resp_cycles prefetch pf_shift
//   c2t_num c2t_den c2t_round
#include <cuda_runtime.h>

#include <cstdint>

#include "addr_decode.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSort = 4096;   // candidates of a point, two sockets
constexpr int kMaxCores = 64;    // the admission key's core stride
constexpr int kMaxC = 32;        // channels
constexpr int kMaxQ = 512;       // queue slots a channel
constexpr int kMaxChunks = kMaxC * kMaxQ / 32;
constexpr int kCand = 80, kCapDemand = 64, kCapPf = 16;
constexpr int kBacklogMax = 192;
constexpr int kCoresPerSocket = 24;
constexpr int kTraceCores = kMaxSort / kCand;   // cores of a trace point
constexpr int kNParams = 20;
constexpr unsigned kFull = 0xffffffffu;
// queue field planes of the inputs and of the packed (7, B, C, Q) output
constexpr int kPlanes = 7;
constexpr int kValid = 0, kIsWrite = 1, kArrival = 2, kIssue = 3,
              kFbank = 4, kRow = 5, kChase = 6;
// address mappings
constexpr int kSimple = 0, kSkylake = 1, kXorFold = 2;

struct Params {
  int n_cores, n_traffic, n_channels, q, ranks, banks_per_rank,
      lines_per_row, row_mask, mapping, channels_per_socket, window_cycles,
      w_cycles, cache_path_cycles, noc_req_cycles, noc_resp_cycles,
      prefetch, pf_shift, c2t_num, c2t_den, c2t_round;
};
static_assert(sizeof(Params) == kNParams * sizeof(int), "parameter count");

// Shared memory of every instance: the keys, the per-channel counts and
// the free-slot ranking.  The frontend's own state follows it.
struct Smem {
  unsigned long long key[kMaxSort];
  int cnt[kMaxC], start[kMaxC];
  unsigned free_mask[kMaxChunks];   // free (valid == 0) slots of a chunk
  int free_before[kMaxChunks];      // free slots of the row before it
  int injected;
};
constexpr int kSmemBytes = (sizeof(Smem) + 15) / 16 * 16;

// The point's scalars, the same value in every thread.
struct Point {
  int wr, chase_seq, chase_iters, iter_cycles, new_carry, l_ir_cycles,
      budget;
};

struct Cand {
  bool valid, is_write, chase, pf;
  uint32_t line;
  int issue;
};

struct Dec {
  int ch, rank, bank, row;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

// torch's `//` on int32: rounds toward negative infinity
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// torch.remainder on int32 by a positive divisor: in [0, b)
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// torch.clamp(x, min=lo) on float32: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ uint32_t lcg(uint32_t x) {
  return x * 2654435761u + 0x9E3779B9u;
}

// Traffic stream: 64-line sequential segments at hashed bases.
__device__ __forceinline__ uint32_t segment_line(int core, int k) {
  const uint32_t seg = static_cast<uint32_t>(k >> 6);
  const uint32_t c = static_cast<uint32_t>(core);
  const uint32_t h = lcg(seg * 31u + c * 97u);
  return (c << 22) | ((h & 0xFFFFu) << 6) | (static_cast<uint32_t>(k) & 63u);
}

// Pointer chase: a 2^26-line region above bit 31.
__device__ __forceinline__ uint32_t chase_line(int k) {
  return (1u << 31) | (lcg(lcg(static_cast<uint32_t>(k))) >> 6);
}

// The chase core's candidate j (`chase_probe`).
__device__ __forceinline__ Cand chase_candidate(int core, int j,
                                                const Point& pt,
                                                const Params& p) {
  Cand c;
  c.pf = false;
  c.valid = core == p.n_cores - 1 && j < pt.chase_iters;
  c.chase = c.valid;
  c.line = chase_line(wadd(pt.chase_seq, j));
  c.is_write = false;
  c.issue = wmul(j, pt.iter_cycles);
  return c;
}

// The MSHR budget, l_ir_cycles and `chase_probe`'s scalars.
__device__ __forceinline__ Point point_scalars(float l_ir, float lat_est,
                                               int chase_carry,
                                               int chase_seq, int wr,
                                               const Params& p,
                                               float budget_num) {
  Point pt;
  pt.wr = wr;
  pt.l_ir_cycles = max(__float2int_rz(rintf(l_ir)), 1);
  const float lat = clamp_min(lat_est, 1.0f);
  pt.budget = __float2int_rz(clamp_min(__fdiv_rn(budget_num, lat), 1.0f));
  const int noc_rt = p.noc_req_cycles + p.noc_resp_cycles;
  pt.iter_cycles = max(wadd(p.cache_path_cycles + noc_rt, pt.l_ir_cycles), 1);
  const int chase_budget = wadd(p.window_cycles, chase_carry);
  pt.chase_iters = min(floor_div(chase_budget, pt.iter_cycles), kCand);
  pt.new_carry = wsub(chase_budget, wmul(pt.chase_iters, pt.iter_cycles));
  pt.chase_seq = chase_seq;
  return pt;
}

// `addrmap.decode` of one line, then the partitioned-socket override.
__device__ __forceinline__ Dec decode(uint32_t l, int core, const Params& p) {
  const uint32_t C = static_cast<uint32_t>(p.n_channels);
  const uint32_t R = static_cast<uint32_t>(p.ranks);
  const uint32_t B = static_cast<uint32_t>(p.banks_per_rank);
  const uint32_t lpr = static_cast<uint32_t>(p.lines_per_row);
  const uint32_t row_mask = static_cast<uint32_t>(p.row_mask);
  uint32_t ch, rank, bank, row;
  if (p.mapping == kSkylake) {
    const addr_decode::Fields f = addr_decode::skylake_xor(l);
    ch = f.ch;
    rank = f.rank;
    bank = f.bank;
    row = f.row;
  } else if (p.mapping == kSimple) {  // ch | col | rank | bank | row
    ch = l % C;
    uint32_t a = l / C / lpr;
    rank = a % R;
    a /= R;
    bank = a % B;
    row = (a / B) & row_mask;
  } else {                            // kXorFold
    const uint32_t mix = l ^ (l >> 6) ^ (l >> 12) ^ (l >> 18);
    ch = mix % C;
    const uint32_t a = l / C;
    bank = ((a / lpr) ^ (l >> 13)) % B;
    rank = ((l >> 8) ^ (l >> 17)) % R;
    row = (l >> 9) & row_mask;
  }
  Dec d;
  d.ch = static_cast<int>(ch);
  if (p.channels_per_socket > 0)
    d.ch = (core / kCoresPerSocket) * p.channels_per_socket +
           d.ch % p.channels_per_socket;
  d.rank = static_cast<int>(rank);
  d.bank = static_cast<int>(bank);
  d.row = static_cast<int>(row);
  return d;
}

// ---- the Mess pace generator ----------------------------------------------

struct MessGen {
  struct Io {
    const int32_t* __restrict__ q_in[kPlanes];  // each (B, C, Q)
    const int32_t* __restrict__ seq;            // (B, N)
    const int32_t* __restrict__ backlog;        // (B, N)
    const int32_t* __restrict__ carry;          // (B,)
    const int32_t* __restrict__ pace;           // (B,)
    const int32_t* __restrict__ wr_num;         // (B,)
    const float* __restrict__ l_ir;             // (B,)
    const float* __restrict__ lat_est;          // (B,)
    int32_t* __restrict__ q_out;                // (7, B, C, Q)
    int32_t* __restrict__ core_out;             // (2, B, N): seq, backlog
    int32_t* __restrict__ point_out;            // (3, B): carry, injected,
                                                //   l_ir_cycles
  };
  struct State {
    int seq[kMaxCores], quota[kMaxCores], acc[kMaxCores];
  };

  static __device__ __forceinline__ Point point(const Io& io,
                                                const Params& p,
                                                float budget_num, int b) {
    const int N = p.n_cores;
    return point_scalars(io.l_ir[b], io.lat_est[b], io.carry[b],
                         io.seq[b * N + N - 1], io.wr_num[b], p,
                         budget_num);
  }

  // each core's quota and stream position (`generate`'s prologue)
  static __device__ __forceinline__ void load(State& st, const Io& io,
                                              const Point& pt,
                                              const Params& p, int b,
                                              int tid) {
    const int N = p.n_cores;
    if (tid < N) {
      const int want = wadd(io.pace[b], io.backlog[b * N + tid]);
      st.quota[tid] = min(min(want, kCapDemand), pt.budget);
      st.seq[tid] = io.seq[b * N + tid];
      st.acc[tid] = 0;
    }
  }

  // Candidate `f` (core f / 80, slot f % 80) of `generate`.
  static __device__ __forceinline__ Cand candidate(int f, const State& st,
                                                   const Point& pt,
                                                   const Params& p) {
    const int core = f / kCand, j = f - core * kCand;
    if (core >= p.n_traffic) return chase_candidate(core, j, pt, p);
    Cand c;
    c.chase = false;
    c.pf = false;
    const int q = st.quota[core], seq = st.seq[core];
    const int k = wadd(seq, j);
    c.valid = j < q;
    c.line = segment_line(core, k);
    // ((k+1)*wr)//64 - (k*wr)//64 > 0; // 64 is an arithmetic shift
    c.is_write = wsub(wmul(wadd(k, 1), pt.wr) >> 6, wmul(k, pt.wr) >> 6) > 0;
    c.issue = floor_div(wmul(j, p.window_cycles), max(q, 1));
    if (p.prefetch) {
      const int pfq = min(q >> p.pf_shift, kCapPf);
      const int jp = j - kCapDemand;
      if (jp >= 0 && jp < pfq) {
        c.valid = true;
        c.pf = true;
        c.line = segment_line(core, wadd(wadd(seq, q), jp));
        c.is_write = false;
        c.issue = floor_div(wmul(jp, p.window_cycles), max(pfq, 1));
      }
    }
    return c;
  }

  // an admitted demand request counts toward its core's grant
  static __device__ __forceinline__ void accept(State& st, const Cand& c,
                                                int core) {
    if (!c.pf) atomicAdd(&st.acc[core], 1);
  }

  // `MessFrontend.update`
  static __device__ __forceinline__ void update(const State& st,
                                                const Io& io,
                                                const Point& pt,
                                                const Params& p, int b,
                                                int tid, int injected) {
    const int N = p.n_cores, B = gridDim.x;
    if (tid < N) {
      const bool traffic = tid < p.n_traffic;
      const int want = wadd(io.pace[b], io.backlog[b * N + tid]);
      const int demanded = traffic ? want : 0;
      const int backlog = wsub(demanded, min(st.acc[tid], demanded));
      io.core_out[b * N + tid] =
          wadd(st.seq[tid], traffic ? st.quota[tid] : pt.chase_iters);
      io.core_out[B * N + b * N + tid] = min(max(backlog, 0), kBacklogMax);
    }
    if (tid == 0) {
      io.point_out[b] = pt.new_carry;
      io.point_out[B + b] = injected;
      io.point_out[2 * B + b] = pt.l_ir_cycles;
    }
  }
};

// ---- the trace replay -----------------------------------------------------

__device__ __forceinline__ unsigned warp_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct TraceGen {
  struct Io {
    const int32_t* __restrict__ q_in[kPlanes];  // each (B, C, Q)
    const int32_t* __restrict__ pos;            // (B, N) cursors
    const int32_t* __restrict__ line_cum;       // (B, N)
    const int32_t* __restrict__ carry;          // (B, N)
    const int32_t* __restrict__ chase_seq;      // (B,)
    const int32_t* __restrict__ chase_carry;    // (B,)
    // (B, L) for a Trace (one row for every core), (B, N, L) for a mix
    const int32_t* __restrict__ delta;
    const int32_t* __restrict__ is_write;
    const int32_t* __restrict__ dep;
    const int32_t* __restrict__ length;         // (B,) or (B, N)
    const int32_t* __restrict__ footprint;      // (B,) or (B, N)
    const int32_t* __restrict__ region;         // (B,)
    const float* __restrict__ l_ir;             // (B,)
    const float* __restrict__ lat_est;          // (B,)
    int32_t* __restrict__ q_out;                // (7, B, C, Q)
    int32_t* __restrict__ core_out;             // (3, B, N): pos, line_cum,
                                                //   carry
    int32_t* __restrict__ point_out;            // (4, B): chase_seq,
                                                //   chase_carry, injected,
                                                //   l_ir_cycles
    int n_slots, is_mix;
  };
  // each traffic core's 64 candidates (line, issue cycle, flags: 1 valid,
  // 2 write) and its update
  struct State {
    uint32_t line[kTraceCores * kCapDemand];
    int issue[kTraceCores * kCapDemand];
    unsigned char flags[kTraceCores * kCapDemand];
    int n_take[kTraceCores], carry[kTraceCores], cum[kTraceCores];
  };

  static __device__ __forceinline__ Point point(const Io& io,
                                                const Params& p,
                                                float budget_num, int b) {
    return point_scalars(io.l_ir[b], io.lat_est[b], io.chase_carry[b],
                         io.chase_seq[b], 0, p, budget_num);
  }

  // `TraceFrontend.bound` for every core, one warp a core
  static __device__ __forceinline__ void load(State& st, const Io& io,
                                              const Point& pt,
                                              const Params& p, int b,
                                              int tid) {
    const int N = p.n_cores, wc = p.window_cycles;
    const int warp = tid >> 5, lane = tid & 31;
    const int ind_cycles = max(floor_div(wc, max(pt.budget, 1)), 1);
    for (int c = warp; c < N; c += kWarps) {
      const int pc = b * N + c;
      const int pos = min(io.pos[pc], io.n_slots - kCapDemand);
      const int target = io.is_mix ? io.length[pc]
                         : c < p.n_traffic ? io.length[b] : 0;
      const int64_t row =
          static_cast<int64_t>(io.is_mix ? pc : b) * io.n_slots + pos;
      const int j0 = 2 * lane;
      int d[2], cost[2], wr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t at = row + j0 + e;
        d[e] = io.delta[at];
        wr[e] = io.is_write[at];
        cost[e] = io.dep[at] == 1 ? pt.iter_cycles : ind_cycles;
      }
      // inclusive scans over the 64 accesses: cost finish times and the
      // int32-wrapped line sums from the core's running sum
      const unsigned c_pair = static_cast<unsigned>(cost[0]) +
                              static_cast<unsigned>(cost[1]);
      const unsigned c_incl = warp_scan(c_pair, lane);
      const unsigned fin[2] = {c_incl - c_pair + cost[0], c_incl};
      const unsigned d_pair =
          static_cast<unsigned>(d[0]) + static_cast<unsigned>(d[1]);
      const unsigned d_incl = warp_scan(d_pair, lane);
      const unsigned lc = static_cast<unsigned>(io.line_cum[pc]);
      const unsigned cum[2] = {lc + d_incl - d_pair + d[0], lc + d_incl};
      const int avail = wadd(wc, io.carry[pc]);
      bool in[2], take[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        in[e] = wadd(pos, j0 + e) < target;
        take[e] = in[e] && static_cast<int>(fin[e]) <= avail;
      }
      const unsigned used = warp_sum((take[0] ? cost[0] : 0u) +
                                     (take[1] ? cost[1] : 0u));
      const unsigned taken_d = warp_sum((take[0] ? d[0] : 0u) +
                                        (take[1] ? d[1] : 0u));
      const int n_take = __popc(__ballot_sync(kFull, take[0])) +
                         __popc(__ballot_sync(kFull, take[1]));
      const bool any_in = __ballot_sync(kFull, in[0] || in[1]) != 0u;
      // absolute lines: the region base plus the wrapped sum, offset by
      // the core's hashed phase, floor-wrapped into the footprint
      const int foot = max(io.footprint[io.is_mix ? pc : b], 1);
      const uint32_t uc = static_cast<uint32_t>(c);
      const int phase =
          static_cast<int>(uc * 2654435761u % static_cast<uint32_t>(foot));
      const uint32_t base = uc * static_cast<uint32_t>(io.region[b]);
      const bool traffic = c < p.n_traffic;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = c * kCapDemand + j0 + e;
        const int idx = floor_mod(wadd(static_cast<int>(cum[e]), phase), foot);
        st.line[k] = base + static_cast<uint32_t>(idx);
        st.issue[k] = min(wsub(static_cast<int>(fin[e]), cost[e]), wc - 1);
        st.flags[k] = (traffic && take[e] ? 1 : 0) |
                      (traffic && wr[e] == 1 ? 2 : 0);
      }
      if (lane == 0) {
        st.n_take[c] = n_take;
        // at most one window of slack; none once the stream is done
        st.carry[c] =
            min(max(any_in ? wsub(avail, static_cast<int>(used)) : 0, 0), wc);
        st.cum[c] = static_cast<int>(lc + taken_d);
      }
    }
  }

  // Candidate `f` (core f / 80, slot f % 80) of `TraceFrontend.bound`:
  // a traffic core's first 64 slots, the chase core's 80.
  static __device__ __forceinline__ Cand candidate(int f, const State& st,
                                                   const Point& pt,
                                                   const Params& p) {
    const int core = f / kCand, j = f - core * kCand;
    if (core >= p.n_traffic) return chase_candidate(core, j, pt, p);
    Cand c;
    c.chase = false;
    c.pf = false;
    if (j < kCapDemand) {
      const int k = core * kCapDemand + j;
      c.valid = (st.flags[k] & 1) != 0;
      c.is_write = (st.flags[k] & 2) != 0;
      c.line = st.line[k];
      c.issue = st.issue[k];
    } else {   // the padding up to 80 slots
      c.valid = false;
      c.is_write = false;
      c.line = 0;
      c.issue = 0;
    }
    return c;
  }

  // rejected demand is dropped, not replayed: nothing to count
  static __device__ __forceinline__ void accept(State&, const Cand&, int) {}

  // `TraceFrontend.update`
  static __device__ __forceinline__ void update(const State& st,
                                                const Io& io,
                                                const Point& pt,
                                                const Params& p, int b,
                                                int tid, int injected) {
    const int N = p.n_cores, B = gridDim.x;
    if (tid < N) {
      const int pc = b * N + tid;
      io.core_out[pc] = wadd(io.pos[pc], st.n_take[tid]);
      io.core_out[B * N + pc] = st.cum[tid];
      io.core_out[2 * B * N + pc] = st.carry[tid];
    }
    if (tid == 0) {
      io.point_out[b] = wadd(pt.chase_seq, pt.chase_iters);
      io.point_out[B + b] = pt.new_carry;
      io.point_out[2 * B + b] = injected;
      io.point_out[3 * B + b] = pt.l_ir_cycles;
    }
  }
};

// ---- the window, for either frontend ---------------------------------------

template <class Gen>
__global__ void __launch_bounds__(kThreads)
    window_inject_kernel(const typename Gen::Io io, const Params p,
                         float budget_num, int n_sort) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  typename Gen::State& st =
      *reinterpret_cast<typename Gen::State*>(smem_raw + kSmemBytes);
  const int tid = threadIdx.x, b = blockIdx.x;
  const int N = p.n_cores, C = p.n_channels, Q = p.q;
  const int n = N * kCand, slots = C * Q;

  // ---- the point's scalars, the frontend's per-core state ---------------
  const Point pt = Gen::point(io, p, budget_num, b);
  Gen::load(st, io, pt, p, b, tid);
  if (tid < C) sm.cnt[tid] = 0;
  if (tid == 0) sm.injected = 0;
  __syncthreads();

  // ---- every candidate: generate, decode, its sort key -----------------
  for (int f = tid; f < n_sort; f += kThreads) {
    unsigned long long key = ~0ull;
    if (f < n) {
      const Cand c = Gen::candidate(f, st, pt, p);
      key = (0xFFFFFFFFull << 32) | static_cast<unsigned>(f);
      if (c.valid) {
        const int core = f / kCand;
        const Dec d = decode(c.line, core, p);
        // the reference's int32 value ch * 2^26 + key, wrapping
        const int adm = wadd(
            wmul(d.ch, 1 << 26),
            wadd(wadd((c.chase ? 0 : 1) << 24, wmul(c.issue, 64)), core));
        key = (static_cast<unsigned long long>(static_cast<unsigned>(adm) ^
                                               0x80000000u)
               << 32) |
              static_cast<unsigned>(f);
        atomicAdd(&sm.cnt[d.ch], 1);
      }
    }
    sm.key[f] = key;
  }
  // free slots of each 32-slot chunk (Q is a multiple of 32, so a chunk
  // lies in one channel)
  const int base = b * slots;
  const int lane = tid & 31;
  for (int s = tid; s - lane < slots; s += kThreads) {
    const bool free = s < slots && io.q_in[kValid][base + s] == 0;
    const unsigned m = __ballot_sync(kFull, free);
    if (lane == 0 && s < slots) sm.free_mask[s >> 5] = m;
  }
  __syncthreads();

  // ---- per-channel starts, per-chunk free prefix -----------------------
  if (tid == 0) {
    int acc = 0;
    for (int c = 0; c < C; ++c) {
      sm.start[c] = acc;
      acc += sm.cnt[c];
    }
  }
  const int row_chunks = Q >> 5;
  for (int t = tid; t < (slots >> 5); t += kThreads) {
    int before = 0;
    for (int u = t - t % row_chunks; u < t; ++u)
      before += __popc(sm.free_mask[u]);
    sm.free_before[t] = before;
  }

  // ---- bitonic sort of the keys, ascending -----------------------------
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = tid; i < (n_sort >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = sm.key[lo], z = sm.key[hi];
        if ((a > z) == ((lo & k) == 0)) {
          sm.key[lo] = z;
          sm.key[hi] = a;
        }
      }
    }
  }
  __syncthreads();

  // ---- every slot once: the admitted candidate or its old value --------
  const int plane = gridDim.x * slots;
  for (int s = tid; s < slots; s += kThreads) {
    const int c = s / Q;
    int v[kPlanes];
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) v[i] = io.q_in[i][base + s];
    if (v[kValid] == 0) {
      const unsigned below = (1u << (s & 31)) - 1u;
      const int fr =
          sm.free_before[s >> 5] + __popc(sm.free_mask[s >> 5] & below);
      if (fr < sm.cnt[c]) {
        const int f = static_cast<int>(sm.key[sm.start[c] + fr] & 0xFFFFFFFFu);
        const int core = f / kCand;
        const Cand cd = Gen::candidate(f, st, pt, p);
        const Dec d = decode(cd.line, core, p);
        const int cycle = wadd(p.w_cycles, cd.issue);
        const int arrival_cycle =
            wadd(cycle, p.cache_path_cycles + p.noc_req_cycles);
        v[kValid] = 1;
        v[kIsWrite] = cd.is_write;
        v[kArrival] = floor_div(wadd(wmul(arrival_cycle, p.c2t_num),
                                     p.c2t_round),
                                p.c2t_den);
        v[kIssue] = cycle;
        v[kFbank] = wadd(wmul(d.rank, p.banks_per_rank), d.bank);
        v[kRow] = d.row;
        v[kChase] = cd.chase;
        Gen::accept(st, cd, core);
        atomicAdd(&sm.injected, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) io.q_out[i * plane + base + s] = v[i];
  }
  __syncthreads();

  // ---- the frontend's update -------------------------------------------
  Gen::update(st, io, pt, p, b, tid, sm.injected);
}

// The parameter vector, checked; cudaSuccess or cudaErrorInvalidValue.
int unpack(const int* params, int n_params, Params* p) {
  if (n_params != kNParams) return static_cast<int>(cudaErrorInvalidValue);
  int* dst = reinterpret_cast<int*>(p);
  for (int i = 0; i < kNParams; ++i) dst[i] = params[i];
  const int n = p->n_cores * kCand;
  if (p->n_cores < 2 || p->n_cores > kMaxCores || n > kMaxSort ||
      p->n_traffic != p->n_cores - 1 || p->n_channels <= 0 ||
      p->n_channels > kMaxC || p->q <= 0 || p->q > kMaxQ || p->q % 32 != 0 ||
      p->ranks <= 0 || p->banks_per_rank <= 0 || p->lines_per_row <= 0 ||
      p->mapping < kSimple || p->mapping > kXorFold || p->c2t_den <= 0 ||
      p->window_cycles <= 0 || p->pf_shift < 0 || p->pf_shift > 31 ||
      p->channels_per_socket < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

template <class Gen>
int launch(const typename Gen::Io& io, const Params& p, float budget_num,
           int batch, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  int n_sort = 2;
  while (n_sort < p.n_cores * kCand) n_sort <<= 1;
  constexpr int smem = kSmemBytes + sizeof(typename Gen::State);
  const cudaError_t e = cudaFuncSetAttribute(
      window_inject_kernel<Gen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_inject_kernel<Gen><<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      io, p, budget_num, n_sort);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One window's bound phase and injection for `batch` points of the Mess
// frontend.  `q_in` holds the seven (B, C, Q) int32 queue planes in
// QueueState order; the outputs are fresh: (7, B, C, Q) queue, (2, B, N)
// seq and backlog, (3, B) chase carry, injected and l_ir_cycles.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int window_inject_launch(
    const void* const* q_in, const void* seq, const void* backlog,
    const void* carry, const void* pace, const void* wr_num, const void* l_ir,
    const void* lat_est, void* q_out, void* core_out, void* point_out,
    const int* params, int n_params, float budget_num, int batch,
    void* stream) {
  Params p;
  const int err = unpack(params, n_params, &p);
  if (err) return err;
  MessGen::Io io;
  for (int i = 0; i < kPlanes; ++i)
    io.q_in[i] = static_cast<const int32_t*>(q_in[i]);
  io.seq = static_cast<const int32_t*>(seq);
  io.backlog = static_cast<const int32_t*>(backlog);
  io.carry = static_cast<const int32_t*>(carry);
  io.pace = static_cast<const int32_t*>(pace);
  io.wr_num = static_cast<const int32_t*>(wr_num);
  io.l_ir = static_cast<const float*>(l_ir);
  io.lat_est = static_cast<const float*>(lat_est);
  io.q_out = static_cast<int32_t*>(q_out);
  io.core_out = static_cast<int32_t*>(core_out);
  io.point_out = static_cast<int32_t*>(point_out);
  return launch<MessGen>(io, p, budget_num, batch, stream);
}

// The same for `batch` points of the trace frontend.  `state` holds the
// TraceState's (B, N) pos, line_cum, carry and (B,) chase_seq,
// chase_carry; `trace` the delta, is_write and dep arrays ((B, L) for a
// Trace, (B, N, L) for a TraceMix: `is_mix`), the length and footprint
// ((B,) or (B, N)) and the (B,) region stride, L = `n_slots` >= 64; all
// int32.  The outputs are fresh: (7, B, C, Q) queue, (3, B, N) pos,
// line_cum, carry, (4, B) chase_seq, chase_carry, injected, l_ir_cycles.
// Cursors must be >= 0.  Launches on `stream`; returns
// cudaGetLastError() or cudaErrorInvalidValue.
extern "C" int window_inject_trace_launch(
    const void* const* q_in, const void* const* state,
    const void* const* trace, const void* l_ir, const void* lat_est,
    void* q_out, void* core_out, void* point_out, const int* params,
    int n_params, float budget_num, int n_slots, int is_mix, int batch,
    void* stream) {
  Params p;
  const int err = unpack(params, n_params, &p);
  if (err) return err;
  if (p.n_cores > kTraceCores || n_slots < kCapDemand ||
      (is_mix != 0 && is_mix != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  TraceGen::Io io;
  for (int i = 0; i < kPlanes; ++i)
    io.q_in[i] = static_cast<const int32_t*>(q_in[i]);
  const int32_t* const* s = reinterpret_cast<const int32_t* const*>(state);
  io.pos = s[0];
  io.line_cum = s[1];
  io.carry = s[2];
  io.chase_seq = s[3];
  io.chase_carry = s[4];
  const int32_t* const* t = reinterpret_cast<const int32_t* const*>(trace);
  io.delta = t[0];
  io.is_write = t[1];
  io.dep = t[2];
  io.length = t[3];
  io.footprint = t[4];
  io.region = t[5];
  io.l_ir = static_cast<const float*>(l_ir);
  io.lat_est = static_cast<const float*>(lat_est);
  io.q_out = static_cast<int32_t*>(q_out);
  io.core_out = static_cast<int32_t*>(core_out);
  io.point_out = static_cast<int32_t*>(point_out);
  io.n_slots = n_slots;
  io.is_mix = is_mix;
  return launch<TraceGen>(io, p, budget_num, batch, stream);
}
