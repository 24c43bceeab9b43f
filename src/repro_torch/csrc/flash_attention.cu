// Block-wise online-softmax GQA attention (FlashAttention forward), by
// hand for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:89, body :36-83) and its
// GQA wrapper `flash_attention` (ops.py:15).  It computes what the TPU
// kernel computes, not its block layout:
//   * scores q.k^T * scale in fp32 (scale 1/sqrt(D) rounded to fp32 by
//     the caller unless given);
//   * keys >= Sk masked and, under `causal`, keys with
//     kpos > Sk - Sq + qpos masked (the decode convention);
//   * running max and denominator in fp32 with the reference's guards for
//     fully masked rows; a row that sees no key outputs 0;
//   * output in the input type (fp32 or bf16).
// Two things are not carried over: D is taken as it is (no padding to
// 128 lanes), and GQA reads KV head h / (Hq / Hkv) in place instead of
// repeating K and V.
//
// What bounds it on an H100: at tinyllama prefill (B=2, Hq=32, Hkv=4,
// S=2048, D=64, bf16, causal) the work is 4*B*Hq*S^2*D/2 = 34.4 GFLOP
// against 38 MB of q/k/v/o, about 900 FLOP per byte, so it is bound by
// tensor-core FLOPs (34.7 us at 989 TFLOP/s), not by bytes (11 us).
//
// This first design is simple and exact rather than fast.  One block of
// 128 threads owns 64 query rows of one (batch, head); it loops over KV
// tiles of 64 keys staged in shared memory as fp32 (rows padded to D+1
// floats so that the column reads do not conflict), and does both
// products with fp32 FMAs on the CUDA cores: each thread holds a 4 x 8
// tile of scores and a 4 x D/8 tile of the output accumulator, so every
// shared load feeds two or more FMAs.  KV tiles wholly above the causal
// diagonal are skipped (they add exactly 0), and the blocks of the last
// query tiles, which see the most keys, are scheduled first.  CUDA cores
// peak at 67 TFLOP/s in fp32, so even a perfect version of this design
// stays >14x above the bf16 bound.  bf16 inputs at head dim 64 or 128
// therefore take flash_attention_sm90.cu (wgmma on bf16 tiles fed by
// TMA); this kernel is the exact route for fp32 and the other head dims.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 column lanes
constexpr int kPS = kBK + 2;   // row stride of the probability tile
constexpr float kNegInf = -__builtin_huge_valf();

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int hq, group, sq, sk, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;   // padded row stride of the Q and K tiles
  constexpr int DC = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // rows 4*tr .. 4*tr+3
  const int tc = tid & 7;   // columns tc + 8*j
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] = q0 + r < p.sq
        ? to_f32(qb[static_cast<int64_t>(q0 + r) * p.q_ss + c]) : 0.f;
  }

  const int shift = p.sk - p.sq;  // query i sits at key position i + shift
  int kend = p.sk;
  if (p.causal) {
    const int last = min(q0 + kBQ, p.sq) - 1 + shift;  // last row's pos
    kend = min(kend, last + 1);
  }
  const int ntiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q staged; the previous tile's K, V, P consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      const int64_t row = k0 + r;
      sK[r * LD + c] = in ? to_f32(kb[row * p.k_ss + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vb[row * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * tr + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * tr + i + shift;
      bool valid[8];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        valid[j] = kpos < p.sk && (!p.causal || kpos <= qpos);
        s[i][j] = valid[j] ? s[i][j] * p.scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      // the 8 lanes of a row group are adjacent lanes of one warp
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float mn = fmaxf(m[i], mc);
      // guard fully masked rows: exp(-inf - -inf) must not fire
      const float safe = mn == kNegInf ? 0.f : mn;
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = valid[j] ? expf(s[i][j] - safe) : 0.f;
        sP[(4 * tr + i) * kPS + tc + 8 * j] = pj;
        rs += pj;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = alpha * l[i] + rs;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * tr + i) * kPS + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = sV[kk * D + tc + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= p.sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* orow = ob + static_cast<int64_t>(row) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) store(orow + tc + 8 * jj, acc[i][jj] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, int nq, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel must opt in
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<T, D><<<dim3(bh, nq), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int d, int bh, int nq,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, bh, nq, stream);
    case 32: return launch<T, 32>(p, bh, nq, stream);
    case 48: return launch<T, 48>(p, bh, nq, stream);
    case 64: return launch<T, 64>(p, bh, nq, stream);
    case 80: return launch<T, 80>(p, bh, nq, stream);
    case 96: return launch<T, 96>(p, bh, nq, stream);
    case 112: return launch<T, 112>(p, bh, nq, stream);
    case 128: return launch<T, 128>(p, bh, nq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), o (B,Hq,Sq,D), each given by its
// (batch, head, seq) strides in elements with D contiguous; fp32 when
// is_bf16 == 0, else bf16.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// take: D not a multiple of 16 up to 128, Hq % Hkv != 0, or more than
// 65535 query tiles).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int b, int hq, int hkv, int sq, int sk, int d, int is_bf16,
    int causal, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bh = static_cast<int64_t>(b) * hq;
  const int nq = (sq + kBQ - 1) / kBQ;
  if (bh > 0x7fffffff || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    q_sb, q_sh,    q_ss,   k_sb,
                 k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,    o_sh,   o_ss,
                 hq,   hq / hkv, sq, sk, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? dispatch<__nv_bfloat16>(p, d, static_cast<int>(bh), nq, s)
              : dispatch<float>(p, d, static_cast<int>(bh), nq, s));
}
