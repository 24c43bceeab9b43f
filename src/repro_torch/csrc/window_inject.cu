// The interface of one Mess window -- bound phase, address decode,
// admission and queue scatter -- for a batch of points in one launch, by
// hand for Hopper.
//
// Replaces the Pallas TPU kernel `decode_packed` / `_decode_kernel`
// (src/repro/kernels/addr_decode/kernel.py:57) together with the eager
// code around it on the main path (the reference's window step,
// src/repro/core/platform.py:146-156; the port's `_bound_inject_eager`):
//   * the MSHR budget `littles_law_budget` and `l_ir_cycles`;
//   * the bound phase `workload.generate` (traffic quota, the 64-line
//     stream segments, the write mix, issue cycles, the stage-07
//     prefetch candidates, `chase_probe`);
//   * the decode of every candidate under `decode_simple`, the Skylake XOR
//     body of `decode_packed` (addr_decode.cuh) or `decode_xor_fold`,
//     and the partitioned-socket channel override;
//   * the admission of `inject_queue`: a stable ranking by channel, chase
//     first, issue cycle, core and flat index (`jnp.argsort` at
//     src/repro/core/workload.py:312), each channel's free slots taken in
//     slot order (the stable argsort at :321), and the scatter of the
//     seven queue planes, arrival through `cycle_to_tick`;
//   * `MessFrontend.update`: backlog, stream position and chase carry.
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
//     fields are generated again from its flat index (no per-candidate
//     state kept);
//   * the accepted demand per core counted with shared integer atomics,
//     which are exact whatever their order.
// Integer arithmetic wraps like int32 tensors (done in unsigned) and
// divides with torch's floor semantics; uint32 hashes are native.  The
// budget divides in float32 with IEEE rounding (`__fdiv_rn`), and
// `l_ir` rounds half to even (`rintf`), as torch does.
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
constexpr int kMaxSort = 4096;   // candidates of a point, two sockets
constexpr int kMaxCores = 64;    // the admission key's core stride
constexpr int kMaxC = 32;        // channels
constexpr int kMaxQ = 512;       // queue slots a channel
constexpr int kMaxChunks = kMaxC * kMaxQ / 32;
constexpr int kCand = 80, kCapDemand = 64, kCapPf = 16;
constexpr int kBacklogMax = 192;
constexpr int kCoresPerSocket = 24;
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

struct Smem {
  unsigned long long key[kMaxSort];
  int seq[kMaxCores], quota[kMaxCores], acc[kMaxCores];
  int cnt[kMaxC], start[kMaxC];
  unsigned free_mask[kMaxChunks];   // free (valid == 0) slots of a chunk
  int free_before[kMaxChunks];      // free slots of the row before it
  int injected;
};

// The point's scalars, the same value in every thread.
struct Point {
  int wr, chase_seq, chase_iters, iter_cycles, new_carry, l_ir_cycles;
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

// Candidate `f` (core f / 80, slot f % 80) of `generate`.
__device__ __forceinline__ Cand candidate(int f, const Smem& sm,
                                          const Point& pt, const Params& p) {
  const int core = f / kCand, j = f - core * kCand;
  Cand c;
  c.chase = false;
  c.pf = false;
  if (core < p.n_traffic) {
    const int q = sm.quota[core], seq = sm.seq[core];
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
  } else {
    c.valid = core == p.n_cores - 1 && j < pt.chase_iters;
    c.chase = c.valid;
    c.line = chase_line(wadd(pt.chase_seq, j));
    c.is_write = false;
    c.issue = wmul(j, pt.iter_cycles);
  }
  return c;
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

__global__ void __launch_bounds__(kThreads)
    window_inject_kernel(Io io, Params p, float budget_num, int n_sort) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, b = blockIdx.x;
  const int N = p.n_cores, C = p.n_channels, Q = p.q;
  const int n = N * kCand, slots = C * Q;

  // ---- the point's scalars: budget, l_ir_cycles, the chase probe --------
  Point pt;
  pt.wr = io.wr_num[b];
  pt.l_ir_cycles = max(__float2int_rz(rintf(io.l_ir[b])), 1);
  const float lat = clamp_min(io.lat_est[b], 1.0f);
  const int budget =
      __float2int_rz(clamp_min(__fdiv_rn(budget_num, lat), 1.0f));
  const int noc_rt = p.noc_req_cycles + p.noc_resp_cycles;
  pt.iter_cycles = max(wadd(p.cache_path_cycles + noc_rt, pt.l_ir_cycles), 1);
  const int chase_budget = wadd(p.window_cycles, io.carry[b]);
  pt.chase_iters = min(floor_div(chase_budget, pt.iter_cycles), kCand);
  pt.new_carry = wsub(chase_budget, wmul(pt.chase_iters, pt.iter_cycles));
  pt.chase_seq = io.seq[b * N + N - 1];
  const int pace = io.pace[b];

  if (tid < N) {
    const int want = wadd(pace, io.backlog[b * N + tid]);
    sm.quota[tid] = min(min(want, kCapDemand), budget);
    sm.seq[tid] = io.seq[b * N + tid];
    sm.acc[tid] = 0;
  }
  if (tid < C) sm.cnt[tid] = 0;
  if (tid == 0) sm.injected = 0;
  __syncthreads();

  // ---- every candidate: generate, decode, its sort key -----------------
  for (int f = tid; f < n_sort; f += kThreads) {
    unsigned long long key = ~0ull;
    if (f < n) {
      const Cand c = candidate(f, sm, pt, p);
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
        const Cand cd = candidate(f, sm, pt, p);
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
        if (!cd.pf) atomicAdd(&sm.acc[core], 1);
        atomicAdd(&sm.injected, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) io.q_out[i * plane + base + s] = v[i];
  }
  __syncthreads();

  // ---- MessFrontend.update ---------------------------------------------
  if (tid < N) {
    const bool traffic = tid < p.n_traffic;
    const int want = wadd(pace, io.backlog[b * N + tid]);
    const int demanded = traffic ? want : 0;
    const int backlog = wsub(demanded, min(sm.acc[tid], demanded));
    const int B = gridDim.x;
    io.core_out[b * N + tid] =
        wadd(sm.seq[tid], traffic ? sm.quota[tid] : pt.chase_iters);
    io.core_out[B * N + b * N + tid] = min(max(backlog, 0), kBacklogMax);
  }
  if (tid == 0) {
    const int B = gridDim.x;
    io.point_out[b] = pt.new_carry;
    io.point_out[B + b] = sm.injected;
    io.point_out[2 * B + b] = pt.l_ir_cycles;
  }
}

}  // namespace

// One window's bound phase and injection for `batch` points.  `q_in`
// holds the seven (B, C, Q) int32 queue planes in QueueState order; the
// outputs are fresh: (7, B, C, Q) queue, (2, B, N) seq and backlog, (3,
// B) chase carry, injected and l_ir_cycles.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int window_inject_launch(
    const void* const* q_in, const void* seq, const void* backlog,
    const void* carry, const void* pace, const void* wr_num, const void* l_ir,
    const void* lat_est, void* q_out, void* core_out, void* point_out,
    const int* params, int n_params, float budget_num, int batch,
    void* stream) {
  if (n_params != kNParams) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kNParams; ++i) dst[i] = params[i];
  const int n = p.n_cores * kCand;
  if (p.n_cores < 2 || p.n_cores > kMaxCores || n > kMaxSort ||
      p.n_traffic != p.n_cores - 1 || p.n_channels <= 0 ||
      p.n_channels > kMaxC || p.q <= 0 || p.q > kMaxQ || p.q % 32 != 0 ||
      p.ranks <= 0 || p.banks_per_rank <= 0 || p.lines_per_row <= 0 ||
      p.mapping < kSimple || p.mapping > kXorFold || p.c2t_den <= 0 ||
      p.window_cycles <= 0 || p.pf_shift < 0 || p.pf_shift > 31 ||
      p.channels_per_socket < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  int n_sort = 2;
  while (n_sort < n) n_sort <<= 1;
  Io io;
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
  window_inject_kernel<<<batch, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      io, p, budget_num, n_sort);
  return static_cast<int>(cudaGetLastError());
}
