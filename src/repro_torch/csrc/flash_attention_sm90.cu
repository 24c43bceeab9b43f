// Block-wise online-softmax GQA attention (FlashAttention forward) on
// Hopper's tensor cores: bf16 tiles fed by TMA into `wgmma`.
//
// Replaces, for bf16 inputs with head dim 64, 80 or 128, the Pallas TPU
// kernel `flash_attention_bhsd` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:89, body :36-83); every
// other input takes the CUDA-core kernel of flash_attention.cu, and the
// wrapper (kernels/flash_attention/ops.py::route) decides which.  It
// computes what flash_attention.cu computes (scale 1/sqrt(D) rounded to
// fp32 by the caller, keys >= Sk masked, causal query i at key position
// Sk - Sq + i, fp32 running max and denominator with the reference's
// guards, a row that sees no key outputs exactly 0, GQA reads KV head
// h / (Hq / Hkv) in place, output into the wrapper's (B, Sq, Hq, D)
// buffer), with one change of arithmetic: the probabilities are rounded
// to bf16 before the P.V product, as every tensor-core flash kernel
// does.  The softmax runs in base 2 with the scale times log2(e) folded
// into one multiply.
//
// What bounds it on an H100: at tinyllama prefill (B=2, Hq=32, Hkv=4,
// S=2048, D=64, causal) 34.4 GFLOP against 38 MB of q/k/v/o, so the
// bf16 tensor cores (989 TFLOP/s: 34.7 us), not the bytes (11 us).
//
// Design (hopper-kernels guide, section 1):
//   * a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and one producer warp;
//   * the producer's first lane copies the Q tile once, then K and V
//     tiles of BK keys into a ring of kStages shared-memory stages, all
//     by TMA from 4-d tensor maps (D, S, H, B) built on the host from the
//     tensors' strides, in the 128-byte swizzle that the wgmma
//     descriptors read; rows past Sq or Sk arrive zero-filled, and so do
//     the columns past D of the last 64-column block (D = 80: columns
//     80-127 of the second block; the box's bytes still count in full on
//     the barrier).  A stage
//     is reported full on an mbarrier (transaction bytes) and released
//     by the 256 consumer threads on a second one;
//   * S = Q.K^T is `wgmma m64nBKk16` with both operands in shared
//     memory; the online softmax runs on the accumulator fragment in
//     registers (row max and sum over the 4 lanes that share a row);
//     P is packed to bf16 in registers, where the fp32 accumulator
//     layout of S is already the A-fragment layout of the next product,
//     and O += P.V is `wgmma m64n64k16` per 64 output columns, V read
//     from shared memory through a transposing (MN-major) descriptor;
//     at D = 80, S takes D/16 = 5 k16 steps (the zero columns are never
//     multiplied) and the second column block's 16 real columns take one
//     `wgmma m64n16k16`, so O holds 40 fp32 registers a thread, not 64;
//   * the denominator divides once at the end; bf16 stores round to
//     nearest even;
//   * KV tiles wholly above the causal diagonal are never loaded; a
//     warpgroup whose rows end before a tile skips its products; the
//     grid runs the query tiles with the most keys first, and the query
//     heads of one KV group side by side (they share K/V in L2).
//   * within a warpgroup, S of tile t and P.V of tile t-1 go to the
//     tensor cores together, and the softmax of tile t runs while the
//     P.V does (FA3's intra-warpgroup overlap: O is rescaled one tile
//     late); the ring's third stage keeps the next tile's copy in flight
//     meanwhile.
// The two warpgroups of a block overlap each other only as the scheduler
// lets them: no ping-pong barrier, no clusters, no persistent grid yet.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;                      // query rows per block
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // + one producer warp
constexpr int kStages = 3;                    // K/V ring depth
// keys per KV tile: at D=128 the O and S fragments would need 64 + 64
// fp32 registers a thread at 128 keys, so it takes 64; at D=80 they need
// 40 + 64 (and P 32), close to D=64's 32 + 64, so it takes 128 as D=64
template <int D>
constexpr int kBK = D <= 80 ? 128 : 64;
// head-dim columns in shared memory: whole 64-column (128-byte) blocks
template <int D>
constexpr int kDPad = (D + 63) / 64 * 64;
constexpr int kRowBytes = 128;                // one swizzle row: 64 bf16
constexpr float kNegInf = -__builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTensorMapError = 10000;  // + the CUDA driver's CUresult

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_sh, o_ss;
  int hq, group, sq, sk, causal;
  float scale;
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows): Q as ceil(D/64) column blocks of kBQ x 64; per
// stage K and V as ceil(D/64) column blocks of BK x 64; then the barriers.
// D = 80 is laid out as D = 128.
template <int D, int BK>
struct Layout {
  static constexpr int kQBytes = kBQ * kDPad<D> * 2;
  static constexpr int kTileBytes = BK * kDPad<D> * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA copy of a (64, rows, 1, 1) box at (c0, c1, c2, c3) into shared
// memory; its bytes complete as transactions on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand:
// address >> 4, leading byte offset, stride byte offset (8-row groups,
// 1024 bytes apart), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same over the first N registers of a fragment (the live columns of
// a 64-column block whose last columns lie past D)
template <int N, int M>
__device__ __forceinline__ void fence_first(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D = A.B^T (+ D when scale_d), A (64 x 16) and B (N x 16) both K-major
// in shared memory; D is the m64nNk16 fp32 fragment, N/2 per thread.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A.B, A (64 x 16) the bf16 register fragment, B (16 x 64) in
// shared memory MN-major (64 contiguous columns per key row): V read
// through a transposing descriptor.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// The same for the first 16 columns of the block only (m64n16k16): the
// 8 registers d[0..7] of the fragment, laid out as the n64 one's first
// two n8 blocks.
__device__ __forceinline__ void wgmma_rs16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using L = Layout<D, BK>;
  constexpr int kCB = kDPad<D> / 64;   // 64-column blocks of the head dim
  // columns of block c that lie below D (64, or D % 64 for the last)
  constexpr int kLastN = D - 64 * (kCB - 1);
  static_assert(kLastN == 64 || kLastN == 16, "D 64, 80 or 128");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.hq, h = blockIdx.x % p.hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const int shift = p.sk - p.sq;  // query i sits at key position i + shift
  int kend = p.sk;                // keys this block's rows may see
  if (p.causal) kend = min(kend, min(q0 + kBQ, p.sq) + shift);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- producer: one lane issues every copy
    if (tid == kConsumers && ntiles > 0) {
      const int hk = h / p.group;
      mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c)
        tma_load(sQ + c * kBQ * kRowBytes, &tq, qbar, 64 * c, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        // the first round finds every stage free (parity 1 passes)
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kTileBytes);
        const uint32_t ks = sK + s * L::kTileBytes;
        const uint32_t vs = sV + s * L::kTileBytes;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          tma_load(ks + c * BK * kRowBytes, &tk, full + 8 * s, 64 * c,
                   t * BK, hk, b);
          tma_load(vs + c * BK * kRowBytes, &tv, full + 8 * s, 64 * c,
                   t * BK, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;                     // column pair in an n8 block
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  // keys this warpgroup may see: it computes tiles 0 .. nwg-1 only
  int wg_kend = row_lo < p.sq ? p.sk : 0;
  if (p.causal && row_lo < p.sq)
    wg_kend = min(wg_kend, min(row_lo + 64, p.sq) + shift);
  const int nwg = wg_kend > 0 ? min(ntiles, (wg_kend + BK - 1) / BK) : 0;
  const float sl2 = p.scale * kLog2e;

  float o[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  // running max (of the scores times scale log2 e) and this thread's
  // share of the denominator per row; alpha rescales O before the
  // pending P.V
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  float sc[BK / 2];        // S of the current tile, then its P in fp32
  uint32_t pa[BK / 16][4];  // P of the previous tile in bf16

  // S = Q.K^T over D in k16 steps: 32-byte steps inside a swizzled row,
  // then the next 64-column block
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc(sQ + (kk / 4) * kBQ * kRowBytes +
                                   wg * 64 * kRowBytes + off, 16);
      const uint64_t db = desc(sK + s * L::kTileBytes +
                                   (kk / 4) * BK * kRowBytes + off, 16);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P.V: key rows 16 kk .. 16 kk + 15 of the stage's V tile; the
  // last block's columns below D only
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const uint64_t db = desc(sV + s * L::kTileBytes +
                                     c * BK * kRowBytes + kk * 16 * kRowBytes,
                                 BK * kRowBytes);
        if (c < kCB - 1 || kLastN == 64)
          wgmma_rs(o[c], pa[kk], db);
        else   // D 80: columns 64-79
          wgmma_rs16(o[c], pa[kk], db);
      }
    wgmma_commit();
  };
  auto fence_o = [&] {
#pragma unroll
    for (int c = 0; c < kCB - 1; ++c) fence_regs(o[c]);
    fence_first<kLastN / 2>(o[kCB - 1]);
  };
  // the n8 blocks of O below D: 8 in a full block, kLastN / 8 in the last
  auto rescale_o = [&] {
#pragma unroll
    for (int c = 0; c < kCB - 1; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[c][4 * j + 2 * i] *= alpha[i];
          o[c][4 * j + 2 * i + 1] *= alpha[i];
        }
#pragma unroll
    for (int j = 0; j < kLastN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[kCB - 1][4 * j + 2 * i] *= alpha[i];
        o[kCB - 1][4 * j + 2 * i + 1] *= alpha[i];
      }
  };
  // online softmax on the fragment: sc[4j + 2i + e] is row r0 + 8i,
  // key k0 + 8j + 2 quad + e; leaves P (fp32) in sc and the rescale of
  // the rows' earlier sums in alpha
  auto softmax = [&](int k0) {
    const bool edge =
        k0 + BK > p.sk || (p.causal && k0 + BK - 1 > row_lo + shift);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = r0 + 8 * i + shift;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x *= sl2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * quad + e;
            if (kpos >= p.sk || (p.causal && kpos > qpos)) x = kNegInf;
          }
          mc = fmaxf(mc, x);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[i], mc);
      // guard rows that have seen no key: exp(-inf - -inf) must not fire
      const float safe = mn == kNegInf ? 0.f : mn;
      alpha[i] = m[i] == kNegInf ? 0.f : ex2(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x = ex2(x - safe);  // masked: exp2(-inf) = 0
          rs += x;
        }
      l[i] = alpha[i] * l[i] + rs;
      m[i] = mn;
    }
  };
  // P in bf16: the accumulator's n8 blocks 2kk and 2kk+1 are the A
  // fragment of the k16 step kk, register for register
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  if (ntiles > 0) mbar_wait(qbar, 0);
  if (nwg > 0) {
    // tile 0: S, softmax, P
    mbar_wait(full, 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    pack_p();
  }
  // tile t: S(t) and the P.V of tile t-1 go to the tensor cores
  // together, and the softmax of tile t runs while the P.V does
  for (int t = 1; t < nwg; ++t) {
    const int s = t % kStages, sp = (t - 1) % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    rescale_o();
    fence_o();
    wgmma_fence();
    issue_qk(s);
    issue_pv(sp);
    wgmma_wait<1>();            // S(t) is in
    fence_regs(sc);
    softmax(t * BK);
    wgmma_wait<0>();            // P(t-1).V(t-1) is in; pa is free
    fence_o();
    mbar_arrive(empty + 8 * sp);  // this thread is done with tile t-1
    pack_p();
  }
  if (nwg > 0) {
    const int sp = (nwg - 1) % kStages;
    rescale_o();
    fence_o();
    wgmma_fence();
    issue_pv(sp);
    wgmma_wait<0>();
    fence_o();
    mbar_arrive(empty + 8 * sp);
  }
  // tiles past this warpgroup's rows: wait for them (their phase must
  // complete) and release them unread
  for (int t = nwg; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = r0 + 8 * i;
    if (row >= p.sq) continue;
    const float den = li == 0.f ? 1.f : li;
    __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh +
                          static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
    for (int c = 0; c < kCB - 1; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * j +
                                           2 * quad) =
            __floats2bfloat162_rn(o[c][4 * j + 2 * i] / den,
                                  o[c][4 * j + 2 * i + 1] / den);
    // the last block: its columns below D only
#pragma unroll
    for (int j = 0; j < kLastN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 64 * (kCB - 1) + 8 * j +
                                         2 * quad) =
          __floats2bfloat162_rn(o[kCB - 1][4 * j + 2 * i] / den,
                                o[kCB - 1][4 * j + 2 * i + 1] / den);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The CUDA driver's tensor-map encoder, reached through the runtime so that
// the library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 4-d map (D, S, H, B) of bf16 over `ptr` with element strides
// (s, h, b), read in (64, rows, 1, 1) boxes, 128-byte swizzled, rows
// out of range zero-filled.
CUresult make_map(CUtensorMap* map, const void* ptr, int d, int s, int h,
                  int b, int64_t ss, int64_t sh, int64_t sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, const int64_t* st,
           int b, int hq, int hkv, int sq, int sk, const Params& p,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, q, D, sq, hq, b, st[2], st[1], st[0], kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&tk, k, D, sk, hkv, b, st[5], st[4], st[3], BK);
  if (r == CUDA_SUCCESS)
    r = make_map(&tv, v, D, sk, hkv, b, st[8], st[7], st[6], BK);
  if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  constexpr int smem = Layout<D, BK>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_sm90_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (sq + kBQ - 1) / kBQ;
  flash_sm90_kernel<D, BK>
      <<<dim3(b * hq, nq), kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), o (B,Hq,Sq,D), each given by its
// (batch, head, seq) strides in elements with D contiguous; D 64, 80 or
// 128;
// base addresses and strides multiples of 16 bytes (TMA's rule; the
// wrapper checks).  Launches on `stream` and returns cudaGetLastError(),
// cudaErrorInvalidValue for a shape it does not take, or
// 10000 + the CUresult when the CUDA driver refuses a tensor map (or 10000 +
// CUDA_ERROR_NOT_FOUND = 10500 when the encoder cannot be reached).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int b, int hq, int hkv, int sq, int sk, int d, int causal,
    float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      static_cast<int64_t>(b) * hq > 0x7fffffff ||
      (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const Params p{static_cast<__nv_bfloat16*>(o), o_sb, o_sh, o_ss, hq,
                 hq / hkv, sq, sk, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64, kBK<64>>(q, k, v, st, b, hq, hkv, sq, sk, p, s);
    case 80: return launch<80, kBK<80>>(q, k, v, st, b, hq, hkv, sq, sk, p, s);
    case 128:
      return launch<128, kBK<128>>(q, k, v, st, b, hq, hkv, sq, sk, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block at head dim d (0 if not taken).
extern "C" int flash_attention_sm90_smem_bytes(int d) {
  return d == 64    ? Layout<64, kBK<64>>::kBytes
         : d == 80  ? Layout<80, kBK<80>>::kBytes
         : d == 128 ? Layout<128, kBK<128>>::kBytes
                    : 0;
}
