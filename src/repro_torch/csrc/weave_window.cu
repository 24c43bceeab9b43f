// One whole window of the Mess platform's weave phase in one launch, by
// hand for Hopper.
//
// Replaces the per-step Pallas TPU kernel `frfcfs_select` /
// `_select_kernel` (src/repro/kernels/bank_timing/kernel.py:97) together
// with the reference's weave scans around it: `jax.lax.scan` over a
// window's DRAM ticks (dense, src/repro/core/platform.py:198-211) or over
// its event horizon (event, :212-239), each step a `dram.tick` (refresh,
// write-drain hysteresis, FR-FCFS select, command apply, stats) and, on
// the event engine, a `dram.next_event`.  The port's stepwise route runs
// the same steps as ~170 eager PyTorch ops around one select launch per
// step (core/dram.py); this kernel is its fused counterpart and must
// agree with it bit for bit.
//
// What bounds it on an H100: not bytes.  A row's state in and out is a
// few KB per window, microseconds of HBM time for the whole batch, while
// a window is hundreds of dependent steps.  The cost is the latency of
// one step inside a block.  So the design keeps everything a step
// touches on the SM:
//   * one block per (point, channel) row, the rows independent inside a
//     window (channels couple only through the stats, reduced after);
//   * one thread per queue slot, holding its slot's fields in registers
//     for the whole window; the fields that never change inside a window
//     (fbank, row, arrival, issue cycle, chase flag) also sit in shared
//     memory, so every thread can read the winner's;
//   * the bank planes (open row, ACT/RD/WR/PRE timers, pending-hit flags)
//     and the FAW registers in shared memory, each bank owned by thread
//     `bank` for its writes;
//   * the per-channel registers (bus, turnaround, last rank, drain,
//     hit streak, refresh deadlines and REFsb slots) replicated in every
//     thread's registers and updated identically by all, so they cost no
//     barrier.
// A dense step takes three barriers: the arrived read/write counts (warp
// ballots summed across warps), the pending-hit flags, and the argmax.
// The argmax key is 64 bits: the int32 FR-FCFS score above the
// complemented slot and the winner's eligibility bits, so the lowest slot
// wins a tie (as jnp.argmax does) and every thread decodes the command
// from the key alone.  `next_event` adds three more: counts, flags and a
// block minimum over the per-slot candidates.  An inactive step grants
// and refreshes nothing, so after the counts (the drain still settles) it
// ends there.
//
// The eligibility, score and command decode are frfcfs.cuh's, shared with
// bank_timing.cu.  Integer arithmetic wraps like int32 tensors; the
// interface latency divides with floor semantics (torch's `//`) and
// converts with round-to-nearest; its float32 sum adds in step order with
// no contraction.
//
// The recorders (`StageConfig.telemetry` / `cmd_trace`) are compile-time
// variants: `weave_window_kernel<kTele, kCmd>`, four instances.  The
// <false, false> instance is the kernel without them.  Telemetry keeps
// the reference's event-accounted planes: busy time and each bank's last
// ACT tick in the registers of the bank's owner thread; the command
// counters and the write-burst state in the registers of the row's last
// warp (the same value in each lane); the two log2 latency histograms in
// shared memory, added to by the row's last thread alone (at most one
// read a step).  The command record is one row of 4 + 2 * ranks int32
// per step and row (cmd, t, fbank, row, then ref and ref_bank per rank),
// one field a lane of the last warp, written after the argmax on every
// step, inactive ones included, where the slot is 0 as the reference's
// argmax over all-zero scores gives.  The bank owners (the first warps)
// carry a step's critical path; the last warp's recorder work overlaps
// it.
//
// Packed parameter vector, in the order of PARAM_NAMES in ops.py:
//   tCL tRCD tRP tRAS tBL tCCD_S tCCD_L tWR tWTR_L tRTP tRRD_S tRRD_L tFAW
//   tCWL tRTRS tREFI tRFC tRC banks_per_rank banks_per_group
//   same_bank_refresh drain_hi drain_lo row_hit_cap mc_extra_ticks
//   tick2cpu_num tick2cpu_den cpu_ps_per_clk
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "frfcfs.cuh"

namespace {

constexpr int kMaxQ = 512;   // threads a block: queue slots of a row
constexpr int kMaxRB = 64;   // banks a channel
constexpr int kMaxR = 4;     // ranks a channel
constexpr int kMaxWarps = kMaxQ / 32;
constexpr int kSlotBits = 10;
constexpr int kNHist = 24;   // log2 latency buckets (dram.N_HIST)
constexpr int kNCounters = 7;
constexpr int kNParams = 28;
constexpr int kBigTick = 1 << 28;  // "no event" (the reference's _BIG)
constexpr unsigned kFull = 0xffffffffu;
// queue field planes of the packed (7, rows, Q) input and output
constexpr int kValid = 0, kIsWrite = 1, kArrival = 2, kIssue = 3,
              kFbank = 4, kRow = 5, kChase = 6;
// bank planes of the packed (5, rows, RB) input and output
constexpr int kOpenRow = 0, kNextAct = 1, kNextRd = 2, kNextWr = 3,
              kNextPre = 4;
// channel registers of the packed (6, rows) input and output
constexpr int kBusFree = 0, kWtr = 1, kRtw = 2, kLastRank = 3, kDrain = 4,
              kStreak = 5;
// integer stats of the (5, rows) output; the float sum goes apart
constexpr int kServedRd = 0, kServedWr = 1, kSumRdLat = 2, kChaseRd = 3,
              kSumChaseLat = 4;
// telemetry counters of the (7, rows) output, in TickTele's order
constexpr int kNAct = 0, kNPre = 1, kNCasRd = 2, kNCasWr = 3, kNRef = 4,
              kDrainEnter = 5, kDrainTicks = 6;
// command record fields (then ref[ranks], ref_bank[ranks])
constexpr int kRecCmd = 0, kRecT = 1, kRecFbank = 2, kRecRow = 3,
              kRecRef = 4;

struct Params {
  int tCL, tRCD, tRP, tRAS, tBL, tCCD_S, tCCD_L, tWR, tWTR_L, tRTP, tRRD_S,
      tRRD_L, tFAW, tCWL, tRTRS, tREFI, tRFC, tRC;
  int banks_per_rank, banks_per_group, same_bank_refresh;
  int drain_hi, drain_lo, row_hit_cap, mc_extra_ticks;
  int tick2cpu_num, tick2cpu_den, cpu_ps_per_clk;
};
static_assert(sizeof(Params) == kNParams * sizeof(int), "parameter count");

struct Window {
  int start, end, horizon, n_steps, event;
  int q, rb, ranks;
};

struct Io {
  const int32_t* __restrict__ q_in;
  const int32_t* __restrict__ b_in;
  const int32_t* __restrict__ faw_in;
  const int32_t* __restrict__ ref_in;
  const int32_t* __restrict__ ch_in;
  int32_t* __restrict__ q_out;
  int32_t* __restrict__ b_out;
  int32_t* __restrict__ faw_out;
  int32_t* __restrict__ ref_out;
  int32_t* __restrict__ ch_out;
  int32_t* __restrict__ stats_i;
  float* __restrict__ stats_f;
  int32_t* __restrict__ live;
  int32_t* __restrict__ sat;
};

// The recorders' inputs and outputs: TeleState in (opened_at (rows, rb);
// last_wr_t, wr_burst (2, rows)) and out (fresh, the same shapes), the
// window's increments (counters (7, rows), busy (rows, rb), histograms
// (2, rows, kNHist)) and the command record (n_steps, rows, 4 + 2 ranks).
struct TeleIo {
  const int32_t* __restrict__ opened_in;
  const int32_t* __restrict__ burst_in;
  int32_t* __restrict__ opened_out;
  int32_t* __restrict__ burst_out;
  int32_t* __restrict__ counters;
  int32_t* __restrict__ busy;
  int32_t* __restrict__ hist;
  int32_t* __restrict__ rec;
};

// Telemetry's shared memory (dynamic: the <false, *> instances take none).
struct TeleSmem {
  int hist[2][kNHist];  // read latency in ticks, interface latency in ps
};

// Telemetry's registers: the bank's busy time and last ACT tick in its
// owner thread; the counters and write-burst state in the last warp.
struct TeleRegs {
  unsigned busy;
  int opened_at;
  unsigned n[kNCounters];
  int last_wr_t;
  bool wr_burst;
};

struct Smem {
  int open_row[kMaxRB], next_act[kMaxRB], next_rd[kMaxRB], next_wr[kMaxRB],
      next_pre[kMaxRB], hit_pend[kMaxRB];
  int faw[kMaxR][4];
  // window-invariant slot fields, for reading the winner's
  int fbank[kMaxQ], row[kMaxQ], arrival[kMaxQ], issue[kMaxQ], chase[kMaxQ];
  // per-warp partials; the counts alternate buffers (an inactive step
  // reads them and moves on with no barrier before the next write)
  int warp_cnt[2][kMaxWarps];
  long long warp_key[kMaxWarps];
  int warp_min[kMaxWarps];
};

// The per-channel registers, the same value in every thread.
struct RowRegs {
  int bus_free, wtr_until, rtw_until, last_rank, hit_streak;
  bool drain;
  int next_ref[kMaxR], ref_slot[kMaxR];
};

// The slot's own fields, in its thread's registers.
struct SlotRegs {
  int valid, is_write, arrival, fbank, row;
};

// Stats of the window, per row (every thread keeps the same values).
struct Stats {
  unsigned served_rd, served_wr, sum_rd_lat, chase_rd, sum_chase_lat;
  float sum_if;
};

__device__ __forceinline__ int pick(const int (&a)[kMaxR], int k) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < kMaxR; ++i) v = k == i ? a[i] : v;
  return v;
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}

// torch's `//` on int32: rounds toward negative infinity
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// `dram.log2_bucket`: floor(log2(max(v, 1))) clipped to kNHist - 1
__device__ __forceinline__ int log2_bucket(int v) {
  return min(31 - __clz(max(v, 1)), kNHist - 1);
}

// Field `f` of one step's command record, by lane `f` of the row's last
// warp: the refresh fields read the deadlines and REFsb slots before the
// step moves them.
__device__ __forceinline__ void write_record(int32_t* rec, int f, int cmd,
                                             int t, int fbank, int row,
                                             const RowRegs& rr, bool active,
                                             const Params& p,
                                             const Window& win) {
  int v;
  if (f == kRecCmd) {
    v = cmd;
  } else if (f == kRecT) {
    v = t;
  } else if (f == kRecFbank) {
    v = fbank;
  } else if (f == kRecRow) {
    v = row;
  } else {
    const int k = (f - kRecRef) % win.ranks;
    const bool due = active && t >= pick(rr.next_ref, k);
    v = f < kRecRef + win.ranks
            ? (due ? 1 : 0)
            : (p.same_bank_refresh && due ? pick(rr.ref_slot, k) : -1);
  }
  rec[f] = v;
}

__device__ __forceinline__ bool settle_drain(bool drain, int nw, int nr,
                                             const Params& p) {
  bool d = drain ? nw > p.drain_lo : nw >= p.drain_hi;
  return d || (nr == 0 && nw > 0);
}

// Arrived writes and reads of the row; one barrier.
__device__ __forceinline__ void count_arrived(Smem& sm, int buf, bool arrived,
                                              bool is_wr, int nwarps, int* nw,
                                              int* nr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bw = __ballot_sync(kFull, arrived && is_wr);
  const unsigned br = __ballot_sync(kFull, arrived && !is_wr);
  if (lane == 0) sm.warp_cnt[buf][warp] = (__popc(bw) << 16) | __popc(br);
  __syncthreads();
  const int v = lane < nwarps ? sm.warp_cnt[buf][lane] : 0;
  const int sum = static_cast<int>(__reduce_add_sync(kFull, v));
  *nw = sum >> 16;
  *nr = sum & 0xffff;
}

// `dram.next_event` of the row on its state at `t`: the earliest tick
// > t where a tick can act, clamped into [t + 1, end].
__device__ __forceinline__ int next_event(Smem& sm, int* cnt_buf,
                                          const SlotRegs& s,
                                          const RowRegs& rr, const Params& p,
                                          const Window& win, int nwarps,
                                          int t, int end) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < win.rb) sm.hit_pend[tid] = 0;
  const bool valid = s.valid == 1;
  const bool is_wr = s.is_write == 1;
  const bool arrived = valid && s.arrival <= t;
  int nw, nr;
  count_arrived(sm, *cnt_buf, arrived, is_wr, nwarps, &nw, &nr);
  *cnt_buf ^= 1;
  const bool drain = settle_drain(rr.drain, nw, nr, p);
  const int fb = s.fbank;
  const int open_e = sm.open_row[fb];
  const bool row_hit = open_e == s.row;
  if (arrived && row_hit && is_wr == drain) sm.hit_pend[fb] = 1;
  __syncthreads();

  int ev = kBigTick;
  if (valid && s.arrival > t) ev = s.arrival;
  const bool side_ok = is_wr ? drain : !drain;
  const bool closed = open_e < 0;
  if (arrived && row_hit && side_ok) {
    int ready = is_wr ? max(sm.next_wr[fb], rr.rtw_until)
                      : max(sm.next_rd[fb], rr.wtr_until);
    ev = min(ev, max(ready, rr.bus_free));
  }
  if (arrived && closed && side_ok) {
    const int rank = fb / p.banks_per_rank;
    ev = min(ev, max(sm.next_act[fb], sm.faw[rank][0] + p.tFAW));
  }
  if (arrived && !closed && !row_hit && side_ok && sm.hit_pend[fb] == 0)
    ev = min(ev, sm.next_pre[fb]);
  ev = __reduce_min_sync(kFull, ev);
  if (lane == 0) sm.warp_min[tid >> 5] = ev;
  __syncthreads();
  ev = __reduce_min_sync(kFull, lane < nwarps ? sm.warp_min[lane] : INT_MAX);

  if (drain != rr.drain) ev = min(ev, t + 1);
#pragma unroll
  for (int k = 0; k < kMaxR; ++k)
    if (k < win.ranks) ev = min(ev, rr.next_ref[k]);
  return min(max(ev, t + 1), end);
}

// `dram.tick` of the row at `t`; with kTele its telemetry planes, with
// kCmd its record at `rec`.
template <bool kTele, bool kCmd>
__device__ __forceinline__ void tick(Smem& sm, TeleSmem& ts, TeleRegs& tr,
                                     int32_t* rec, int* cnt_buf, SlotRegs& s,
                                     RowRegs& rr, Stats& st, const Params& p,
                                     const Window& win, int nwarps, int t,
                                     bool active) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int nbanks = p.banks_per_rank;
  // the row's last warp keeps the recorders; lane f writes record field f
  const bool rec_warp = (tid >> 5) == nwarps - 1;
  const bool rec_lane = rec_warp && lane < kRecRef + 2 * win.ranks;

  // refresh: all-bank closes the rank, REFsb one rotating bank; each
  // bank's owner applies it (the deadlines move with the apply below)
  if (tid < win.rb) {
    sm.hit_pend[tid] = 0;
    const int rank = tid / nbanks;
    bool due = active && t >= pick(rr.next_ref, rank);
    if (p.same_bank_refresh)
      due = due && tid % nbanks == pick(rr.ref_slot, rank);
    if (due) {
      if constexpr (kTele) {  // a refresh closes an open row: its busy time
        if (sm.open_row[tid] >= 0)
          tr.busy += static_cast<unsigned>(wrap_sub(t, tr.opened_at));
      }
      sm.open_row[tid] = -1;
      sm.next_act[tid] = max(sm.next_act[tid], t + p.tRFC);
    }
  }

  // write-drain hysteresis (settles on inactive steps too)
  const bool is_wr = s.is_write == 1;
  const bool arrived = s.valid == 1 && s.arrival <= t;
  int nw, nr;
  count_arrived(sm, *cnt_buf, arrived, is_wr, nwarps, &nw, &nr);
  *cnt_buf ^= 1;
  const bool drain = settle_drain(rr.drain, nw, nr, p);
  if (!active) {  // grants nothing, refreshes nothing
    if constexpr (kCmd) {
      if (rec_lane)
        write_record(rec, lane, frfcfs::kNone, t, sm.fbank[0], -1, rr, false,
                     p, win);
    }
    rr.drain = drain;
    return;
  }

  // FR-FCFS guard: banks with an arrived row hit on the drain side are
  // not precharged (post-refresh open rows)
  const int fb = s.fbank;
  const int open_e = sm.open_row[fb];
  if (arrived && open_e == s.row && is_wr == drain) sm.hit_pend[fb] = 1;
  __syncthreads();

  // eligibility + score, then the block argmax on (score, ~slot, bits)
  const frfcfs::Channel ch = frfcfs::make_channel(
      t, rr.bus_free, rr.wtr_until, rr.rtw_until, drain, rr.hit_streak,
      p.row_hit_cap);
  const int rank_e = fb / nbanks;
  const frfcfs::Slot slot{arrived,         is_wr,
                          open_e,          s.row,
                          sm.next_rd[fb],  sm.next_wr[fb],
                          sm.next_act[fb], sm.next_pre[fb],
                          t >= sm.faw[rank_e][0] + p.tFAW,
                          sm.hit_pend[fb] != 0,
                          s.arrival};
  int bits;
  const int sc = frfcfs::score(slot, ch, &bits);
  const unsigned low = (static_cast<unsigned>((1 << kSlotBits) - 1 - tid)
                        << 8) | static_cast<unsigned>(bits);
  long long key = static_cast<long long>(sc) * 4294967296LL +
                  static_cast<long long>(low);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    key = max(key, __shfl_xor_sync(kFull, key, off));
  if (lane == 0) sm.warp_key[tid >> 5] = key;
  __syncthreads();
  key = lane < nwarps ? sm.warp_key[lane] : LLONG_MIN;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    key = max(key, __shfl_xor_sync(kFull, key, off));

  const int best = static_cast<int>(key >> 32);
  const unsigned best_low = static_cast<unsigned>(key & 0xffffffffLL);
  const int sel = (1 << kSlotBits) - 1 - static_cast<int>(best_low >> 8);
  const int cmd = frfcfs::command(best, best_low & 0xff, ch.capped);
  const bool s_rd = cmd == frfcfs::kRd, s_wr = cmd == frfcfs::kWr;
  const bool s_cas = s_rd || s_wr, s_act = cmd == frfcfs::kAct;
  const bool s_pre = cmd == frfcfs::kPre, any_cmd = cmd != frfcfs::kNone;
  const int s_fb = sm.fbank[sel];
  const int s_rank = s_fb / nbanks;
  const int s_bg = (s_fb % nbanks) / p.banks_per_group;
  if constexpr (kCmd) {
    if (rec_lane)
      write_record(rec, lane, cmd, t, s_fb,
                   s_act || s_cas ? sm.row[sel] : -1, rr, true, p, win);
  }
  if (kTele && rec_warp) {  // a write-CAS run is one drain burst
    tr.n[kNAct] += s_act;
    tr.n[kNPre] += s_pre;
    tr.n[kNCasRd] += s_rd;
    tr.n[kNCasWr] += s_wr;
    if (s_wr) {
      tr.n[kDrainEnter] += !tr.wr_burst;
      tr.n[kDrainTicks] +=
          tr.wr_burst ? static_cast<unsigned>(wrap_sub(t, tr.last_wr_t))
                      : static_cast<unsigned>(p.tBL);
      tr.last_wr_t = t;
    }
    if (s_cas) tr.wr_burst = s_wr;
  }

  // apply the command: bank planes by their owners
  if (tid < win.rb && any_cmd) {
    const bool at_sel = tid == s_fb;
    const bool same_rank = tid / nbanks == s_rank;
    const bool same_grp =
        same_rank && (tid % nbanks) / p.banks_per_group == s_bg;
    int orow = sm.open_row[tid], nact = sm.next_act[tid];
    int nrd = sm.next_rd[tid], nwr = sm.next_wr[tid];
    int npre = sm.next_pre[tid];
    if (s_act) {
      if (same_rank) nact = max(nact, t + p.tRRD_S);
      if (same_grp) nact = max(nact, t + p.tRRD_L);
      if (at_sel) {
        if constexpr (kTele) tr.opened_at = t;
        orow = sm.row[sel];
        nact = max(nact, t + p.tRC);
        nrd = t + p.tRCD;
        nwr = t + p.tRCD;
        npre = t + p.tRAS;
      }
    }
    if (s_cas) {  // tCCD is channel-wide, bank-group aware
      const int ccd = p.tCCD_S + (same_grp ? p.tCCD_L - p.tCCD_S : 0);
      nrd = max(nrd, t + ccd);
      nwr = max(nwr, t + ccd);
      if (at_sel && s_rd) npre = max(npre, t + p.tRTP);
      if (at_sel && s_wr) npre = max(npre, t + (p.tCWL + p.tBL + p.tWR));
    }
    if (s_pre && at_sel) {
      if constexpr (kTele)
        tr.busy += static_cast<unsigned>(wrap_sub(t, tr.opened_at));
      orow = -1;
      nact = max(nact, t + p.tRP);
    }
    sm.open_row[tid] = orow;
    sm.next_act[tid] = nact;
    sm.next_rd[tid] = nrd;
    sm.next_wr[tid] = nwr;
    sm.next_pre[tid] = npre;
  }
  if (tid == 0 && s_act) {  // FAW shift-register push on the ACT's rank
    int* f = sm.faw[s_rank];
    f[0] = f[1];
    f[1] = f[2];
    f[2] = f[3];
    f[3] = t;
  }

  // the channel registers, in every thread
  if (s_cas) {
    rr.bus_free = t + p.tBL + (s_rank != rr.last_rank ? p.tRTRS : 0);
    rr.last_rank = s_rank;
  }
  if (s_wr) rr.wtr_until = t + (p.tCWL + p.tBL + p.tWTR_L);
  if (s_rd) rr.rtw_until = t + (p.tCL + p.tBL + p.tRTRS - p.tCWL);
  rr.hit_streak = s_cas ? rr.hit_streak + 1 : (any_cmd ? 0 : rr.hit_streak);
  rr.drain = drain;
#pragma unroll
  for (int k = 0; k < kMaxR; ++k) {
    if (k < win.ranks && t >= rr.next_ref[k]) {
      if (kTele && rec_warp) ++tr.n[kNRef];
      rr.next_ref[k] += p.tREFI;
      if (p.same_bank_refresh)
        rr.ref_slot[k] = (rr.ref_slot[k] + 1) % nbanks;
    }
  }

  // retire the CAS'd entry
  if (s_cas && tid == sel) s.valid = 0;

  // stats of the step
  const int done_t = t + (p.tCL + p.tBL + p.mc_extra_ticks);
  const int rd_lat = wrap_sub(done_t, sm.arrival[sel]);
  const int if_lat =
      wrap_sub(floor_div(wrap_mul(done_t, p.tick2cpu_num), p.tick2cpu_den),
               wrap_mul(sm.issue[sel], p.cpu_ps_per_clk));
  st.served_rd += s_rd;
  st.served_wr += s_wr;
  if constexpr (kTele) {
    if (tid == win.q - 1 && s_rd) {
      // one thread: the atomics only spare the load-to-store latency
      atomicAdd(&ts.hist[0][log2_bucket(rd_lat)], 1);
      atomicAdd(&ts.hist[1][log2_bucket(if_lat)], 1);
    }
  }
  if (s_rd) {
    st.sum_rd_lat += static_cast<unsigned>(rd_lat);
    st.sum_if = __fadd_rn(st.sum_if, __int2float_rn(if_lat));
    if (sm.chase[sel] == 1) {
      st.chase_rd += 1;
      st.sum_chase_lat += static_cast<unsigned>(rd_lat);
    }
  }
}

template <bool kTele, bool kCmd>
__global__ void __launch_bounds__(kMaxQ, 1)
    weave_window_kernel(Io io, TeleIo tio, Params p, Window win) {
  __shared__ Smem sm;
  extern __shared__ int tele_smem[];
  TeleSmem& ts = *reinterpret_cast<TeleSmem*>(tele_smem);
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int rows = gridDim.x;
  const int nwarps = win.q >> 5;

  // ---- load the row's state ---------------------------------------------
  SlotRegs s;
  {
    const size_t plane = static_cast<size_t>(rows) * win.q;
    const int32_t* q = io.q_in + static_cast<size_t>(row) * win.q + tid;
    s.valid = q[kValid * plane];
    s.is_write = q[kIsWrite * plane];
    s.arrival = q[kArrival * plane];
    s.fbank = q[kFbank * plane];
    s.row = q[kRow * plane];
    sm.fbank[tid] = s.fbank;
    sm.row[tid] = s.row;
    sm.arrival[tid] = s.arrival;
    sm.issue[tid] = q[kIssue * plane];
    sm.chase[tid] = q[kChase * plane];
  }
  if (tid < win.rb) {
    const size_t plane = static_cast<size_t>(rows) * win.rb;
    const int32_t* b = io.b_in + static_cast<size_t>(row) * win.rb + tid;
    sm.open_row[tid] = b[kOpenRow * plane];
    sm.next_act[tid] = b[kNextAct * plane];
    sm.next_rd[tid] = b[kNextRd * plane];
    sm.next_wr[tid] = b[kNextWr * plane];
    sm.next_pre[tid] = b[kNextPre * plane];
  }
  if (tid < 4 * win.ranks)
    sm.faw[tid >> 2][tid & 3] =
        io.faw_in[static_cast<size_t>(row) * win.ranks * 4 + tid];
  RowRegs rr;
  rr.bus_free = io.ch_in[kBusFree * rows + row];
  rr.wtr_until = io.ch_in[kWtr * rows + row];
  rr.rtw_until = io.ch_in[kRtw * rows + row];
  rr.last_rank = io.ch_in[kLastRank * rows + row];
  rr.drain = io.ch_in[kDrain * rows + row] != 0;
  rr.hit_streak = io.ch_in[kStreak * rows + row];
#pragma unroll
  for (int k = 0; k < kMaxR; ++k) {
    const bool in = k < win.ranks;
    const size_t at = static_cast<size_t>(row) * win.ranks + k;
    rr.next_ref[k] = in ? io.ref_in[at] : INT_MAX;
    rr.ref_slot[k] =
        in ? io.ref_in[static_cast<size_t>(rows) * win.ranks + at] : 0;
  }
  Stats st{0u, 0u, 0u, 0u, 0u, 0.0f};
  TeleRegs tr{};
  if constexpr (kTele) {
    if (tid < win.rb) {
      tr.opened_at = tio.opened_in[static_cast<size_t>(row) * win.rb + tid];
    }
    if (tid < 2 * kNHist) ts.hist[tid / kNHist][tid % kNHist] = 0;
    tr.last_wr_t = tio.burst_in[row];
    tr.wr_burst = tio.burst_in[rows + row] != 0;
  }
  // this row's command record of step i
  const int rec_len = 4 + 2 * win.ranks;
  auto rec_at = [&](int i) {
    return kCmd ? tio.rec + (static_cast<size_t>(i) * rows + row) * rec_len
                : nullptr;
  };
  int cnt_buf = 0;
  __syncthreads();

  // ---- the window's steps -------------------------------------------------
  int live = 0;
  bool sat = false;
  if (!win.event) {
    for (int i = 0; i < win.n_steps; ++i) {
      const int t = win.start + i;
      tick<kTele, kCmd>(sm, ts, tr, rec_at(i), &cnt_buf, s, rr, st, p, win,
                        nwarps, t, t < win.end);
      live += t < win.end;
    }
  } else {
    // every row starts at start - 1 and jumps to its own next event; an
    // exhausted row parks at horizon - 1, inactive
    int t = win.start - 1;
    for (int i = 0; i < win.n_steps; ++i) {
      const int tn = next_event(sm, &cnt_buf, s, rr, p, win, nwarps, t,
                                win.horizon);
      const int tau = min(tn, win.horizon - 1);
      tick<kTele, kCmd>(sm, ts, tr, rec_at(i), &cnt_buf, s, rr, st, p, win,
                        nwarps, tau, tn < win.horizon && tau < win.end);
      live += tn < win.end;
      t = tau;
    }
    // budget spent with an event pending before the horizon
    sat = next_event(sm, &cnt_buf, s, rr, p, win, nwarps, t, win.horizon) <
          win.horizon;
  }
  __syncthreads();

  // ---- write the row's state out ------------------------------------------
  {
    const size_t plane = static_cast<size_t>(rows) * win.q;
    int32_t* q = io.q_out + static_cast<size_t>(row) * win.q + tid;
    q[kValid * plane] = s.valid;
    q[kIsWrite * plane] = s.is_write;
    q[kArrival * plane] = s.arrival;
    q[kIssue * plane] = sm.issue[tid];
    q[kFbank * plane] = s.fbank;
    q[kRow * plane] = s.row;
    q[kChase * plane] = sm.chase[tid];
  }
  if (tid < win.rb) {
    const size_t plane = static_cast<size_t>(rows) * win.rb;
    int32_t* b = io.b_out + static_cast<size_t>(row) * win.rb + tid;
    b[kOpenRow * plane] = sm.open_row[tid];
    b[kNextAct * plane] = sm.next_act[tid];
    b[kNextRd * plane] = sm.next_rd[tid];
    b[kNextWr * plane] = sm.next_wr[tid];
    b[kNextPre * plane] = sm.next_pre[tid];
  }
  if (tid < 4 * win.ranks)
    io.faw_out[static_cast<size_t>(row) * win.ranks * 4 + tid] =
        sm.faw[tid >> 2][tid & 3];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kMaxR; ++k) {
      if (k < win.ranks) {
        const size_t at = static_cast<size_t>(row) * win.ranks + k;
        io.ref_out[at] = rr.next_ref[k];
        io.ref_out[static_cast<size_t>(rows) * win.ranks + at] =
            rr.ref_slot[k];
      }
    }
    io.ch_out[kBusFree * rows + row] = rr.bus_free;
    io.ch_out[kWtr * rows + row] = rr.wtr_until;
    io.ch_out[kRtw * rows + row] = rr.rtw_until;
    io.ch_out[kLastRank * rows + row] = rr.last_rank;
    io.ch_out[kDrain * rows + row] = rr.drain ? 1 : 0;
    io.ch_out[kStreak * rows + row] = rr.hit_streak;
    io.stats_i[kServedRd * rows + row] = static_cast<int>(st.served_rd);
    io.stats_i[kServedWr * rows + row] = static_cast<int>(st.served_wr);
    io.stats_i[kSumRdLat * rows + row] = static_cast<int>(st.sum_rd_lat);
    io.stats_i[kChaseRd * rows + row] = static_cast<int>(st.chase_rd);
    io.stats_i[kSumChaseLat * rows + row] =
        static_cast<int>(st.sum_chase_lat);
    io.stats_f[row] = st.sum_if;
    io.live[row] = live;
    io.sat[row] = sat ? 1 : 0;
  }
  if constexpr (kTele) {
    if (tid < win.rb) {
      const size_t at = static_cast<size_t>(row) * win.rb + tid;
      tio.opened_out[at] = tr.opened_at;
      tio.busy[at] = static_cast<int>(tr.busy);
    }
    if (tid < 2 * kNHist)
      tio.hist[(static_cast<size_t>(tid / kNHist) * rows + row) * kNHist +
               tid % kNHist] = ts.hist[tid / kNHist][tid % kNHist];
    if (tid == win.q - 1) {
#pragma unroll
      for (int k = 0; k < kNCounters; ++k)
        tio.counters[k * rows + row] = static_cast<int>(tr.n[k]);
      tio.burst_out[row] = tr.last_wr_t;
      tio.burst_out[rows + row] = tr.wr_burst ? 1 : 0;
    }
  }
}

// The launch of one instance; `ok` checks of the C entry points first.
template <bool kTele, bool kCmd>
int launch(const Io& io, const TeleIo& tio, const int* params, int rows,
           const Window& win, void* stream) {
  Params p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kNParams; ++i) dst[i] = params[i];
  weave_window_kernel<kTele, kCmd>
      <<<rows, win.q, kTele ? sizeof(TeleSmem) : 0,
         static_cast<cudaStream_t>(stream)>>>(io, tio, p, win);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int n_params, int q, int rb, int ranks, const int* params) {
  return n_params == kNParams && q > 0 && q <= kMaxQ && q % 32 == 0 &&
         rb > 0 && rb <= kMaxRB && rb <= q && ranks > 0 && ranks <= kMaxR &&
         ranks * params[18] == rb;
}

Io make_io(const void* q_in, const void* b_in, const void* faw_in,
           const void* ref_in, const void* ch_in, void* q_out, void* b_out,
           void* faw_out, void* ref_out, void* ch_out, void* stats_i,
           void* stats_f, void* live, void* sat) {
  return Io{static_cast<const int32_t*>(q_in),
            static_cast<const int32_t*>(b_in),
            static_cast<const int32_t*>(faw_in),
            static_cast<const int32_t*>(ref_in),
            static_cast<const int32_t*>(ch_in),
            static_cast<int32_t*>(q_out),
            static_cast<int32_t*>(b_out),
            static_cast<int32_t*>(faw_out),
            static_cast<int32_t*>(ref_out),
            static_cast<int32_t*>(ch_out),
            static_cast<int32_t*>(stats_i),
            static_cast<float*>(stats_f),
            static_cast<int32_t*>(live),
            static_cast<int32_t*>(sat)};
}

}  // namespace

// One window of weave steps for `rows` (point, channel) rows.  Inputs and
// outputs are packed int32 planes: queue (7, rows, q), banks (5, rows, rb),
// faw (rows, ranks, 4), refresh (2, rows, ranks) = next_ref, ref_slot,
// channel (6, rows) = bus_free, wtr_until, rtw_until, last_rank, drain,
// hit_streak; stats (5, rows) = served_rd, served_wr, sum_rd_lat_ticks,
// chase_rd, sum_chase_lat_ticks, plus the float32 sum_if_lat_ps (rows),
// live steps (rows) and the saturation flag (rows).  `params` is a host
// array of `n_params` ints in the order above.  `event` selects the
// event-horizon engine (budget `n_steps`) over the dense one (`n_steps`
// ticks from `start`).  Launches on `stream`; returns cudaGetLastError().
extern "C" int weave_window_launch(
    const void* q_in, const void* b_in, const void* faw_in,
    const void* ref_in, const void* ch_in, void* q_out, void* b_out,
    void* faw_out, void* ref_out, void* ch_out, void* stats_i, void* stats_f,
    void* live, void* sat, const int* params, int n_params, int rows, int q,
    int rb, int ranks, int start, int end, int horizon, int n_steps,
    int event, void* stream) {
  if (!shape_ok(n_params, q, rb, ranks, params))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const Window win{start, end, horizon, n_steps, event, q, rb, ranks};
  const Io io = make_io(q_in, b_in, faw_in, ref_in, ch_in, q_out, b_out,
                        faw_out, ref_out, ch_out, stats_i, stats_f, live, sat);
  return launch<false, false>(io, TeleIo{}, params, rows, win, stream);
}

// The same window with the recorders: `telemetry` and `cmd_trace` pick the
// instance.  After the arguments above: TeleState in, opened_at (rows, rb)
// and (last_wr_t, wr_burst) (2, rows); TeleState out, the same shapes;
// the increments, counters (7, rows) = n_act, n_pre, n_cas_rd, n_cas_wr,
// n_ref, drain_enter, drain_ticks, busy (rows, rb) and the histograms
// (2, rows, 24) = read latency in ticks, interface latency in ps; the
// command record (n_steps, rows, 4 + 2 ranks).  Pointers of an unset flag
// are not read and may be null.
extern "C" int weave_window_record_launch(
    const void* q_in, const void* b_in, const void* faw_in,
    const void* ref_in, const void* ch_in, void* q_out, void* b_out,
    void* faw_out, void* ref_out, void* ch_out, void* stats_i, void* stats_f,
    void* live, void* sat, const void* opened_in, const void* burst_in,
    void* opened_out, void* burst_out, void* counters, void* busy,
    void* hist, void* rec, const int* params, int n_params, int rows, int q,
    int rb, int ranks, int start, int end, int horizon, int n_steps,
    int event, int telemetry, int cmd_trace, void* stream) {
  if (!shape_ok(n_params, q, rb, ranks, params))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const Window win{start, end, horizon, n_steps, event, q, rb, ranks};
  const Io io = make_io(q_in, b_in, faw_in, ref_in, ch_in, q_out, b_out,
                        faw_out, ref_out, ch_out, stats_i, stats_f, live, sat);
  const TeleIo tio{static_cast<const int32_t*>(opened_in),
                   static_cast<const int32_t*>(burst_in),
                   static_cast<int32_t*>(opened_out),
                   static_cast<int32_t*>(burst_out),
                   static_cast<int32_t*>(counters),
                   static_cast<int32_t*>(busy),
                   static_cast<int32_t*>(hist),
                   static_cast<int32_t*>(rec)};
  if (telemetry && cmd_trace)
    return launch<true, true>(io, tio, params, rows, win, stream);
  if (telemetry) return launch<true, false>(io, tio, params, rows, win, stream);
  if (cmd_trace) return launch<false, true>(io, tio, params, rows, win, stream);
  return launch<false, false>(io, tio, params, rows, win, stream);
}
