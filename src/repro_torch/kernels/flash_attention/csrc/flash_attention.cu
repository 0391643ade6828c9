// Causal / windowed / softcapped GQA flash attention, forward and backward:
// the Hopper port of repro/kernels/flash_attention/kernel.py --
//   flash_attention_pallas  (_flash_fwd_kernel, pallas_call :425)
//                                        -> forward, kLse false;
//   flash_attention_fwd_lse (_flash_fwd_kernel_lse, :285)
//                                        -> forward, kLse true;
//   flash_attention_bwd     (_flash_bwd_dq_kernel :333,
//                            _flash_bwd_dkv_kernel :357)
//                                        -> dq, dk/dv.
//
// Layout as the TPU kernels': q, o, do (B*H, Sq, D); k, v (B*Hkv, Sk, D);
// lse, dsum (B*H, Sq) fp32.  Query head row bh = b*H + h reads kv row
// b*Hkv + h/G (G = H/Hkv): GQA with no repeat of K/V.  Key j is visible to
// query i iff (!causal || j <= i) && (window <= 0 || i - j < window).
//
// What each computes:
//   forward o = softmax(mask(softcap(q k^T * D^-0.5))) v with online
//           softmax in fp32 (m, l, acc); masked scores are -1e9, as in the
//           TPU kernel, keys past Sk -inf; softcap is applied before the
//           mask; p is rounded to v's type before PV; l is floored at
//           1e-30; o in q's type; with kLse also lse = m + log(l) in fp32.
//   dq      dq = sum over keys of ds k * D^-0.5, with p = exp(s - lse),
//           ds = p (do v^T - dsum), times (1 - tanh^2) under softcap: the
//           algebra of _bwd_block.
//   dk/dv   dk = sum over query rows of ds^T q * D^-0.5, dv = p^T do, for
//           one KV head: the block loops over the G query heads that share
//           it and writes the group's sum directly (the TPU kernel writes
//           per-query-head dk/dv and ops.py group-sums them).  The plain
//           version keeps the TPU kernel's per-head outputs; its group sum
//           is what this kernel's output equals.
//
// Bound on an H100: operations.  The work is 4 D flops per visible (query,
// key) pair forward and 10 D backward against each input byte read once:
// at granite-3-2b's S 4096, D 64 about 68.7 GFLOP over 21.5 MB forward,
// some 3,200 flops a byte, far above the ~295 flop/byte ridge of 989
// TFLOP/s bf16 over 3.35 TB/s.  A block brings each K/V tile into shared
// memory once for its 64 queries (64 flops a byte of tile).  Only the
// tensor cores move it.
//
// Grid: nothing carries between blocks (the TPU carries m/l/acc across a
// sequential grid axis).  The forward and dq: one block per (query head,
// 64-row query tile) loops over the key tiles of the causal / window band
// (the TPU kernel's skip, kernel.py:105-110); dk/dv: one block per (KV
// head, 64-key tile) loops over its G query heads and the query tiles of
// the band, in a fixed order.  No atomics: every output element is written
// once by the block that owns it, so the backward is bit-equal from call
// to call, which a resumed training run relies on.  Edges are
// bounds-checked (rows past Sq / Sk are zero and never stored), so any Sq
// and Sk work; D <= 256 is zero-padded in shared memory to DM, the next of
// 16, 32, 64, 128, 256.
//
// bf16 (flash_mma.cuh; every full-width path runs it): four warps, 16 rows
// each.  Products are mma.sync m16n8k16, bf16 in, fp32 accumulate: scores
// are fp32 sums of exact bf16 products, as in JAX.  The block-fixed tile
// (q, or q and do, or k and v) is read once; the other side streams
// through a two-stage ring of 64-row tiles (32 at DM 256): cp.async of 16
// bytes (8 or 4 for narrower rows, plain loads for odd D), zero-filled
// past S and D, the next tile in flight while the block computes on this
// one.  Rows are padded by 8 bf16, so the 8 rows an ldmatrix reads fall in
// 8 distinct bank quads.  A row of the score tile lives in a quad of 4
// lanes: scale, softcap, mask and the online softmax run on the fp32
// accumulator fragments with two shuffles per reduction, exponentials on
// ex2.approx, the mask only where the band's edge crosses a warp's tile
// (per-score work, not registers, set these kernels' time); p (forward) and
// ds (dq) are rounded to bf16 in registers and are the A operand of the
// next product, with V and K transposed by ldmatrix.trans.  dk/dv computes
// s^T = k q^T and dp^T = v do^T, so a warp's 16 key rows hold p^T and ds^T
// as A fragments for dv += p^T do and dk += ds^T q.  The backward rounds
// p and ds to bf16 as operands, which JAX's fp32 _bwd_block does not.  At
// DM 256 two blocks split the output columns, each recomputing the scores.
// mma.sync reaches part of the tensor cores' rate; wgmma with TMA and a
// warp-specialised producer is later work.
//
// fp32 keeps the scalar design (the tensor cores take fp32 only as TF32,
// whose 10-bit mantissa is far from fp32's 1e-4 limit): 128 threads, 16 x
// 8, each a micro-tile of the score tile, tiles in padded fp32 shared
// memory, dots as fp32 FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

using flash_mma::key_band;
using flash_mma::query_band;

constexpr int kThreads = 128;     // 16 x 8
constexpr float kNegInf = -1e9f;  // masked score, as the TPU kernel

// The scalar kernels below are instantiated for fp32 only (T = float);
// bf16 runs the tensor-core kernels of flash_mma.cuh.
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Tiles by padded head dim: 64 rows, 32 at DM 256 (shared memory).
template <int DM> struct Tile {
  static constexpr int BQ = DM >= 256 ? 32 : 64;
  static constexpr int BK = BQ;
  static constexpr int DP = DM + 1;   // padded row stride in shared memory
  static constexpr int RM = BQ / 16;  // score rows per thread
  static constexpr int CN = BK / 8;   // score columns per thread
  static constexpr int AD = DM / 8;   // accumulator columns per thread
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows x DM tile of a (S, D) matrix starting at row r0 into shared memory
// as fp32 times ``mul``; rows past S and columns past D are zero.
template <int DM, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int S, int D,
                                          float mul) {
  constexpr int DP = DM + 1;
  for (int idx = threadIdx.x; idx < rows * DM; idx += kThreads) {
    const int r = idx / DM, d = idx % DM;
    float x = 0.f;
    if (r0 + r < S && d < D) x = to_f32(src[(size_t)(r0 + r) * D + d]) * mul;
    dst[r * DP + d] = x;
  }
}

// s[i][j] = sum_d A[ty*RM + i][d] * B[tx + 8j][d] (both tiles DP-strided).
template <int DM, int RM, int CN>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int ty, int tx, float (&s)[RM][CN]) {
  constexpr int DP = DM + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty * RM + i) * DP + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = B[(tx + 8 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int causal,
                                        int window) {
  return (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

template <typename T, int DM, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int D,
          int causal, int window, float scale, float softcap) {
  using Tl = Tile<DM>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DP = Tl::DP, RM = Tl::RM,
                CN = Tl::CN, AD = Tl::AD;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvrow * Sk * D;
  const T* vb = v + (size_t)kvrow * Sk * D;

  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x DP, q * scale
  float* sK = sQ + BQ * DP;      // BK x DP
  float* sV = sK + BK * DP;      // BK x DP
  float* sP = sV + BK * DP;      // BQ x (BK + 1), p in v's type
  load_tile<DM>(sQ, qb, q0, BQ, Sq, D, scale);

  float m[RM], l[RM], acc[RM][AD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < AD; ++a) acc[i][a] = 0.f;
  }
  int lo, hi;
  key_band(q0, BQ, BK, Sk, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's sK, sV, sP are read
    load_tile<DM>(sK, kb, k0, BK, Sk, D, 1.f);
    load_tile<DM>(sV, vb, k0, BK, Sk, D, 1.f);
    __syncthreads();
    float s[RM][CN];
    tile_dot<DM>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (!visible(qi, kj, causal, window)) x = kNegInf;
        if (kj >= Sk) x = -INFINITY;   // not a key at all
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty * RM + i) * (BK + 1) + tx + 8 * j] = to_f32(from_f32<T>(p));
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int a = 0; a < AD; ++a) acc[i][a] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sP[(ty * RM + i) * (BK + 1) + c];
#pragma unroll
      for (int a = 0; a < AD; ++a) {
        const float vv = sV[c * DP + tx + 8 * a];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][a] = fmaf(p[i], vv, acc[i][a]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) {
      const int d = tx + 8 * a;
      if (d < D) orow[d] = from_f32<T>(acc[i][a] / ll);
    }
    if (kLse && tx == 0) lse[(size_t)bh * Sq + qi] = m[i] + logf(ll);
  }
}

// p and ds of one (query tile, key tile) pair at thread (ty, tx)'s
// micro-tile: the algebra of _bwd_block.  sQ holds q * scale, sDO do;
// lse and dsum are the tile's rows.
template <int DM, int RM, int CN>
__device__ __forceinline__ void bwd_block(
    const float* sQ, const float* sK, const float* sV, const float* sDO,
    const float* sLse, const float* sDsum, int q0, int k0, int Sq, int Sk,
    int causal, int window, float softcap, int ty, int tx,
    float (&p)[RM][CN], float (&ds)[RM][CN]) {
  float dp[RM][CN];
  tile_dot<DM>(sQ, sK, ty, tx, p);     // raw scores
  tile_dot<DM>(sDO, sV, ty, tx, dp);   // do v^T
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kj = k0 + tx + 8 * j;
      float t = 0.f, used = p[i][j];
      if (softcap > 0.f) {
        t = tanhf(used / softcap);
        used = t * softcap;
      }
      const bool ok = qi < Sq && kj < Sk && visible(qi, kj, causal, window);
      const float pp = ok ? expf(used - sLse[r]) : 0.f;
      float d = pp * (dp[i][j] - sDsum[r]);
      if (softcap > 0.f) d *= 1.f - t * t;
      p[i][j] = pp;
      ds[i][j] = d;
    }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int D,
             int causal, int window, float scale, float softcap) {
  using Tl = Tile<DM>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DP = Tl::DP, RM = Tl::RM,
                CN = Tl::CN, AD = Tl::AD;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)kvrow * Sk * D;

  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x DP, q * scale
  float* sDO = sQ + BQ * DP;     // BQ x DP
  float* sK = sDO + BQ * DP;     // BK x DP
  float* sV = sK + BK * DP;      // BK x DP
  float* sDS = sV + BK * DP;     // BQ x (BK + 1)
  float* sLse = sDS + BQ * (BK + 1);
  float* sDsum = sLse + BQ;
  load_tile<DM>(sQ, q + qoff, q0, BQ, Sq, D, scale);
  load_tile<DM>(sDO, dout + qoff, q0, BQ, Sq, D, 1.f);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    sLse[r] = in ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
    sDsum[r] = in ? dsum[(size_t)bh * Sq + q0 + r] : 0.f;
  }
  float acc[RM][AD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int a = 0; a < AD; ++a) acc[i][a] = 0.f;
  int lo, hi;
  key_band(q0, BQ, BK, Sk, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<DM>(sK, k + koff, k0, BK, Sk, D, 1.f);
    load_tile<DM>(sV, v + koff, k0, BK, Sk, D, 1.f);
    __syncthreads();
    float p[RM][CN], ds[RM][CN];
    bwd_block<DM>(sQ, sK, sV, sDO, sLse, sDsum, q0, k0, Sq, Sk, causal,
                  window, softcap, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        sDS[(ty * RM + i) * (BK + 1) + tx + 8 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float d[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) d[i] = sDS[(ty * RM + i) * (BK + 1) + c];
#pragma unroll
      for (int a = 0; a < AD; ++a) {
        const float kk = sK[c * DP + tx + 8 * a];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][a] = fmaf(d[i], kk, acc[i][a]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= Sq) continue;
    T* row = dq + qoff + (size_t)qi * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) {
      const int d = tx + 8 * a;
      if (d < D) row[d] = from_f32<T>(acc[i][a] * scale);
    }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv,
              int Sq, int Sk, int D, int causal, int window, float scale,
              float softcap) {
  using Tl = Tile<DM>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, DP = Tl::DP, RM = Tl::RM,
                CN = Tl::CN, AD = Tl::AD;
  constexpr int RK = BK / 16;   // key rows of dk / dv per thread
  const int kvrow = blockIdx.y, k0 = blockIdx.x * BK;
  const int b = kvrow / Hkv, hk = kvrow % Hkv, G = H / Hkv;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t koff = (size_t)kvrow * Sk * D;

  extern __shared__ float smem[];
  float* sK = smem;              // BK x DP
  float* sV = sK + BK * DP;      // BK x DP
  float* sQ = sV + BK * DP;      // BQ x DP, q * scale
  float* sDO = sQ + BQ * DP;     // BQ x DP
  float* sP = sDO + BQ * DP;     // BQ x (BK + 1)
  float* sDS = sP + BQ * (BK + 1);
  float* sLse = sDS + BQ * (BK + 1);
  float* sDsum = sLse + BQ;
  load_tile<DM>(sK, k + koff, k0, BK, Sk, D, 1.f);
  load_tile<DM>(sV, v + koff, k0, BK, Sk, D, 1.f);

  float dka[RK][AD], dva[RK][AD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int a = 0; a < AD; ++a) dka[i][a] = dva[i][a] = 0.f;
  int lo, hi;
  query_band(k0, BQ, BK, Sq, causal, window, &lo, &hi);
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + hk * G + g;
    const size_t qoff = (size_t)bh * Sq * D;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<DM>(sQ, q + qoff, q0, BQ, Sq, D, scale);
      load_tile<DM>(sDO, dout + qoff, q0, BQ, Sq, D, 1.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        sLse[r] = in ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
        sDsum[r] = in ? dsum[(size_t)bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[RM][CN], ds[RM][CN];
      bwd_block<DM>(sQ, sK, sV, sDO, sLse, sDsum, q0, k0, Sq, Sk, causal,
                    window, softcap, ty, tx, p, ds);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int at = (ty * RM + i) * (BK + 1) + tx + 8 * j;
          sP[at] = p[i][j];
          sDS[at] = ds[i][j];
        }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], dr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = sP[r * (BK + 1) + ty * RK + i];
          dr[i] = sDS[r * (BK + 1) + ty * RK + i];
        }
#pragma unroll
        for (int a = 0; a < AD; ++a) {
          const float qq = sQ[r * DP + tx + 8 * a];
          const float oo = sDO[r * DP + tx + 8 * a];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dva[i][a] = fmaf(pr[i], oo, dva[i][a]);
            dka[i][a] = fmaf(dr[i], qq, dka[i][a]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kj = k0 + ty * RK + i;
    if (kj >= Sk) continue;
    T* krow = dk + koff + (size_t)kj * D;
    T* vrow = dv + koff + (size_t)kj * D;
#pragma unroll
    for (int a = 0; a < AD; ++a) {
      const int d = tx + 8 * a;
      if (d < D) {
        krow[d] = from_f32<T>(dka[i][a]);   // q was scaled in sQ
        vrow[d] = from_f32<T>(dva[i][a]);
      }
    }
  }
}

template <int DM> size_t fwd_smem() {
  using Tl = Tile<DM>;
  return sizeof(float) * (size_t)((Tl::BQ + 2 * Tl::BK) * Tl::DP +
                                  Tl::BQ * (Tl::BK + 1));
}
template <int DM> size_t dq_smem() {
  using Tl = Tile<DM>;
  return sizeof(float) * (size_t)((2 * Tl::BQ + 2 * Tl::BK) * Tl::DP +
                                  Tl::BQ * (Tl::BK + 1) + 2 * Tl::BQ);
}
template <int DM> size_t dkv_smem() {
  using Tl = Tile<DM>;
  return sizeof(float) * (size_t)((2 * Tl::BQ + 2 * Tl::BK) * Tl::DP +
                                  2 * Tl::BQ * (Tl::BK + 1) + 2 * Tl::BQ);
}

// Raise the kernel's dynamic shared memory cap once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* set) {
  if (bytes <= *set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *set = bytes;
  return err;
}

template <typename T, int DM>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int BH, int H, int Hkv, int Sq, int Sk, int D,
                int causal, int window, float scale, float softcap,
                cudaStream_t stream) {
  const size_t smem = fwd_smem<DM>();
  const dim3 grid((Sq + Tile<DM>::BQ - 1) / Tile<DM>::BQ, BH);
  cudaError_t err;
  if (lse != nullptr) {
    static size_t set = 48 * 1024;
    err = allow_smem(flash_fwd<T, DM, true>, smem, &set);
    if (err != cudaSuccess) return err;
    flash_fwd<T, DM, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), H, Hkv, Sq, Sk, D, causal, window, scale,
        softcap);
  } else {
    static size_t set = 48 * 1024;
    err = allow_smem(flash_fwd<T, DM, false>, smem, &set);
    if (err != cudaSuccess) return err;
    flash_fwd<T, DM, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), nullptr, H, Hkv, Sq,
        Sk, D, causal, window, scale, softcap);
  }
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dsum,
                   void* dq, int BH, int H, int Hkv, int Sq, int Sk, int D,
                   int causal, int window, float scale, float softcap,
                   cudaStream_t stream) {
  static size_t set = 48 * 1024;
  const cudaError_t err = allow_smem(flash_bwd_dq<T, DM>, dq_smem<DM>(),
                                     &set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Tile<DM>::BQ - 1) / Tile<DM>::BQ, BH);
  flash_bwd_dq<T, DM><<<grid, kThreads, dq_smem<DM>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), H, Hkv, Sq, Sk, D, causal, window, scale,
      softcap);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dsum,
                    void* dk, void* dv, int BH, int H, int Hkv, int Sq,
                    int Sk, int D, int causal, int window, float scale,
                    float softcap, cudaStream_t stream) {
  static size_t set = 48 * 1024;
  const cudaError_t err = allow_smem(flash_bwd_dkv<T, DM>, dkv_smem<DM>(),
                                     &set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + Tile<DM>::BK - 1) / Tile<DM>::BK, BH / H * Hkv);
  flash_bwd_dkv<T, DM><<<grid, kThreads, dkv_smem<DM>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, D, causal,
      window, scale, softcap);
  return cudaGetLastError();
}

#define FWD_ARGS                                                         \
  q, k, v, o, lse, BH, H, Hkv, Sq, Sk, D, causal, window, scale, softcap, \
      stream
#define DQ_ARGS                                                          \
  q, k, v, dout, lse, dsum, dq, BH, H, Hkv, Sq, Sk, D, causal, window,    \
      scale, softcap, stream
#define DKV_ARGS                                                         \
  q, k, v, dout, lse, dsum, dk, dv, BH, H, Hkv, Sq, Sk, D, causal,        \
      window, scale, softcap, stream

// The widest cp.async (16, 8 or 4 bytes) that rows of D bf16 values and
// every pointer allow; 0: plain loads (odd D).
int copy_bytes(int D, const void* const* ptrs, int n) {
  int vec = D % 8 == 0 ? 16 : D % 4 == 0 ? 8 : D % 2 == 0 ? 4 : 0;
  for (int i = 0; i < n; ++i)
    while (vec && reinterpret_cast<uintptr_t>(ptrs[i]) % vec)
      vec = vec > 4 ? vec / 2 : 0;
  return vec;
}

using bf16 = __nv_bfloat16;

template <int DM>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int BH, int H, int Hkv, int Sq, int Sk, int D,
                    int causal, int window, float scale, float softcap,
                    cudaStream_t stream) {
  using C = flash_mma::Cfg<DM>;
  const void* in[] = {q, k, v};
  const int vec = copy_bytes(D, in, 3);
  const size_t smem = flash_mma::fwd_smem<DM>();
  const dim3 grid(BH, (Sq + C::BM - 1) / C::BM, C::NZ);
  cudaError_t err;
  if (lse != nullptr) {
    static size_t set = 48 * 1024;
    err = allow_smem(flash_mma::flash_fwd_mma<DM, true>, smem, &set);
    if (err != cudaSuccess) return err;
    flash_mma::flash_fwd_mma<DM, true>
        <<<grid, flash_mma::kThreads, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o),
            static_cast<float*>(lse), H, Hkv, Sq, Sk, D, causal, window,
            scale, softcap, vec);
  } else {
    static size_t set = 48 * 1024;
    err = allow_smem(flash_mma::flash_fwd_mma<DM, false>, smem, &set);
    if (err != cudaSuccess) return err;
    flash_mma::flash_fwd_mma<DM, false>
        <<<grid, flash_mma::kThreads, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr, H,
            Hkv, Sq, Sk, D, causal, window, scale, softcap, vec);
  }
  return cudaGetLastError();
}

template <int DM>
cudaError_t dq_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dsum,
                   void* dq, int BH, int H, int Hkv, int Sq, int Sk, int D,
                   int causal, int window, float scale, float softcap,
                   cudaStream_t stream) {
  using C = flash_mma::Cfg<DM>;
  const void* in[] = {q, k, v, dout};
  const int vec = copy_bytes(D, in, 4);
  const size_t smem = flash_mma::dq_smem<DM>();
  static size_t set = 48 * 1024;
  const cudaError_t err = allow_smem(flash_mma::flash_dq_mma<DM>, smem, &set);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + C::BM - 1) / C::BM, C::NZ);
  flash_mma::flash_dq_mma<DM><<<grid, flash_mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dq), H, Hkv, Sq, Sk, D, causal, window, scale,
      softcap, vec);
  return cudaGetLastError();
}

template <int DM>
cudaError_t dkv_mma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dsum,
                    void* dk, void* dv, int BH, int H, int Hkv, int Sq,
                    int Sk, int D, int causal, int window, float scale,
                    float softcap, cudaStream_t stream) {
  using C = flash_mma::Cfg<DM>;
  const void* in[] = {q, k, v, dout};
  const int vec = copy_bytes(D, in, 4);
  const size_t smem = flash_mma::dkv_smem<DM>();
  static size_t set = 48 * 1024;
  const cudaError_t err = allow_smem(flash_mma::flash_dkv_mma<DM>, smem,
                                     &set);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH / H * Hkv, (Sk + C::BM - 1) / C::BM, C::NZ);
  flash_mma::flash_dkv_mma<DM><<<grid, flash_mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, Sq, Sk, D,
      causal, window, scale, softcap, vec);
  return cudaGetLastError();
}

// f(std::integral_constant<int, DM>()) for the padded head dim DM of D
// (the next of 16, 32, 64, 128, 256); ``none`` past 256.
template <typename F, typename R>
R by_dm(int D, F f, R none) {
  if (D <= 16) return f(std::integral_constant<int, 16>());
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  if (D <= 256) return f(std::integral_constant<int, 256>());
  return none;
}

}  // namespace

// dtype (of q, k, v, o, do, dq, dk, dv): 0 = float32 (the scalar
// kernels), 1 = bfloat16 (the tensor-core kernels).  The forward writes
// lse when ``lse`` is not null (flash_attention_fwd_lse) and skips it
// otherwise (flash_attention_pallas).  window <= 0: no window.  The
// backward is two launches: dq (B*H, Sq, D), and dk, dv per KV head
// (B*Hkv, Sk, D).  Each returns cudaGetLastError() after its launch (0 on
// success); the Python wrapper raises on anything else.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int H, int Hkv,
                                int Sq, int Sk, int D, int causal,
                                int window, float scale, float softcap,
                                int dtype, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)by_dm(D, [&](auto dm) {
      return fwd<float, decltype(dm)::value>(FWD_ARGS);
    }, cudaErrorInvalidValue);
  if (dtype == 1)
    return (int)by_dm(D, [&](auto dm) {
      return fwd_mma<decltype(dm)::value>(FWD_ARGS);
    }, cudaErrorInvalidValue);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dsum,
                                   void* dq, int BH, int H, int Hkv, int Sq,
                                   int Sk, int D, int causal, int window,
                                   float scale, float softcap, int dtype,
                                   void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)by_dm(D, [&](auto dm) {
      return bwd_dq<float, decltype(dm)::value>(DQ_ARGS);
    }, cudaErrorInvalidValue);
  if (dtype == 1)
    return (int)by_dm(D, [&](auto dm) {
      return dq_mma<decltype(dm)::value>(DQ_ARGS);
    }, cudaErrorInvalidValue);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dsum,
                                    void* dk, void* dv, int BH, int H,
                                    int Hkv, int Sq, int Sk, int D,
                                    int causal, int window, float scale,
                                    float softcap, int dtype,
                                    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)by_dm(D, [&](auto dm) {
      return bwd_dkv<float, decltype(dm)::value>(DKV_ARGS);
    }, cudaErrorInvalidValue);
  if (dtype == 1)
    return (int)by_dm(D, [&](auto dm) {
      return dkv_mma<decltype(dm)::value>(DKV_ARGS);
    }, cudaErrorInvalidValue);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory, in bytes, that the launch of ``kernel`` (0
// forward, 1 dq, 2 dk/dv) asks for at head dim D and dtype; -1 if none.
extern "C" int flash_smem_bytes(int kernel, int dtype, int D) {
  if (kernel < 0 || kernel > 2 || dtype < 0 || dtype > 1 || D < 1) return -1;
  return by_dm(D, [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    const size_t f32[] = {fwd_smem<DM>(), dq_smem<DM>(), dkv_smem<DM>()};
    const size_t b16[] = {flash_mma::fwd_smem<DM>(), flash_mma::dq_smem<DM>(),
                          flash_mma::dkv_smem<DM>()};
    return (int)(dtype == 0 ? f32 : b16)[kernel];
  }, -1);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
