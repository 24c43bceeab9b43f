// FR-FCFS eligibility, score and command decode of one DRAM weave step,
// shared by the per-step select kernel (bank_timing.cu) and the
// whole-window weave kernel (weave_window.cu), so both grant exactly the
// same command.  Mirrors `select_reference` of the JAX package.
#pragma once

#include <cstdint>

namespace frfcfs {

constexpr unsigned kBig = 1u << 28;
constexpr int kNone = 0, kRd = 1, kWr = 2, kAct = 3, kPre = 4;
// eligibility bits carried with a slot's score
constexpr int kBitRd = 1, kBitWr = 2, kBitAct = 4, kBitPre = 8,
              kBitIsWr = 16;

// One queue slot as the select sees it: its own fields and the timers of
// its bank, gathered.
struct Slot {
  bool arrived;  // valid, arrived and the tick active
  bool is_wr;
  int open_e;    // open row of the slot's bank (-1: precharged)
  int row;
  int nrd, nwr, nact, npre;  // the bank's CAS / ACT / PRE timers
  bool faw_ok;   // the slot's rank may activate (four-activate window)
  bool hit_pend; // the bank has an arrived row hit on the drain side
  int arrival;
};

// The per-channel registers the select reads.
struct Channel {
  int t;
  bool bus_ok, wtr_ok, rtw_ok, drain;
  bool capped;  // hit streak at the row-hit cap
};

__device__ __forceinline__ Channel make_channel(int t, int bus_free,
                                                int wtr_until, int rtw_until,
                                                bool drain, int hit_streak,
                                                int row_hit_cap) {
  return Channel{t, t >= bus_free, t >= wtr_until, t >= rtw_until, drain,
                 row_hit_cap > 0 && hit_streak >= row_hit_cap};
}

// The slot's FR-FCFS score (CAS > ACT > PRE, oldest first, the cap
// inverting CAS and ACT) as an int32, 0 when nothing is eligible; its
// eligibility bits go to `*bits`.
__device__ __forceinline__ int score(const Slot& s, const Channel& c,
                                     int* bits) {
  const int t = c.t;
  const bool row_hit = (s.open_e == s.row) && s.arrived;
  const bool closed = (s.open_e < 0) && s.arrived;
  const bool side_ok = s.is_wr ? c.drain : !c.drain;
  const bool rd = row_hit && !s.is_wr && t >= s.nrd && c.bus_ok &&
                  c.wtr_ok && !c.drain;
  const bool wr = row_hit && s.is_wr && t >= s.nwr && c.bus_ok && c.rtw_ok &&
                  c.drain;
  const bool act = closed && t >= s.nact && s.faw_ok && side_ok;
  const bool pre = s.arrived && s.open_e >= 0 && s.open_e != s.row &&
                   t >= s.npre && !s.hit_pend && side_ok;
  // int32 wrap-around arithmetic, as the reference computes it
  const unsigned age = kBig - static_cast<unsigned>(s.arrival);
  unsigned sc = 0;
  if (rd || wr) {
    sc = 3 * kBig + age;
  } else if (act) {
    sc = 2 * kBig + age;
  } else if (pre) {
    sc = kBig + age;
  }
  if (c.capped) {
    if (rd || wr) sc = kBig + age;
    if (act) sc = 3 * kBig + age;
  }
  *bits = (rd ? kBitRd : 0) | (wr ? kBitWr : 0) | (act ? kBitAct : 0) |
          (pre ? kBitPre : 0) | (s.is_wr ? kBitIsWr : 0);
  return static_cast<int>(sc);
}

// The command of the argmax winner from its score and bits.
__device__ __forceinline__ int command(int best, int bits, bool capped) {
  const bool any_cmd = best > 0;
  const bool rd_ok = bits & kBitRd;
  const bool wr_ok = bits & kBitWr;
  const bool act_ok = bits & kBitAct;
  const bool pre_ok = bits & kBitPre;
  const bool is_wr = bits & kBitIsWr;
  // under the cap inversion an ACT can outrank a CAS
  const bool s_cas = any_cmd && (rd_ok || wr_ok) && !(capped && act_ok);
  const bool s_act = any_cmd && act_ok && !s_cas;
  const bool s_pre = any_cmd && pre_ok && !s_cas && !s_act;
  if (s_cas) return is_wr ? kWr : kRd;
  if (s_act) return kAct;
  if (s_pre) return kPre;
  return kNone;
}

}  // namespace frfcfs
