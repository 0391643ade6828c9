// The bf16 flash-attention kernels on Hopper's tensor cores, warp-level:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) on tiles that a two-stage
// cp.async ring brings into shared memory.  flash_attention.cu's header note
// gives the design; this file holds the primitives and the three kernels.
//
// Fragments of mma.m16n8k16 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 row g, k 2t..2t+1; a1 row g + 8; a2 row g,
//     k 8 + 2t; a3 row g + 8, k 8 + 2t.
//   B (16 x 8): b0 k 2t..2t+1, column g; b1 k 8 + 2t.
//   C (16 x 8, fp32): c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8.
// So the C fragments of two neighbouring 8-column tiles are, rounded to
// bf16 in pairs, the A fragment of a 16-deep product over those columns:
// p and ds stay in registers between their two products.
#pragma once
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The masked score -1e9 in log2 units: the forward keeps m and the scores
// there, so that exp(x - m) is 2^ of one difference, and a row that has
// seen only masked keys gets p = 2^0 = 1, as in the TPU kernel.
constexpr float kMasked2 = -1e9f * kLog2e;

// Tiles by padded head dim DM (a multiple of 16).  A block owns BM rows
// (queries in the forward and dq, keys in dk/dv), 16 a warp; a ring stage
// holds BN rows of the other side.  DC: the output columns a block
// computes; at DM 256 two blocks (grid z) split them, each recomputing
// the scores, so that no thread holds more than 64 accumulators a product.
template <int DM> struct Cfg {
  static constexpr int BM = 16 * kWarps;
  static constexpr int BN = DM >= 256 ? 32 : 64;
  static constexpr int SS = DM + 8;   // row stride in shared memory (bf16):
                                      // 8 rows of an ldmatrix hit 8 bank quads
  static constexpr int DC = DM > 128 ? 128 : DM;
  static constexpr int NZ = DM / DC;
  static constexpr int KD = DM / 16;  // k-steps over the head dim
};

// The band of key tiles a query tile [q0, q0 + BQ) reaches, as in
// kernel.py:105-110: [*lo, *hi).  Shared with the fp32 kernels.
__device__ __forceinline__ void key_band(int q0, int BQ, int BK, int Sk,
                                         int causal, int window, int* lo,
                                         int* hi) {
  long long end = (Sk + BK - 1) / BK;
  if (causal) end = min(end, (long long)(q0 + BQ - 1) / BK + 1);
  long long beg = 0;
  if (window > 0) {   // k0 + BK - 1 >= q0 - window + 1
    const long long need = (long long)q0 - window + 2 - BK;
    if (need > 0) beg = (need + BK - 1) / BK;
  }
  *lo = (int)beg;
  *hi = (int)max(end, beg);
}

// The band of query tiles a key tile [k0, k0 + BK) is reached from.
__device__ __forceinline__ void query_band(int k0, int BQ, int BK, int Sq,
                                           int causal, int window, int* lo,
                                           int* hi) {
  long long end = (Sq + BQ - 1) / BQ;
  long long beg = 0;
  if (causal) {       // k0 <= q0 + BQ - 1
    const long long need = (long long)k0 - BQ + 1;
    if (need > 0) beg = (need + BQ - 1) / BQ;
  }
  if (window > 0)     // q0 <= k0 + BK + window - 2
    end = min(end, ((long long)k0 + BK + window - 2) / BQ + 1);
  *lo = (int)beg;
  *hi = (int)max(end, beg);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one 16 x 8 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx: 2 ulp, subnormal results
// flushed to 0); exp2f's subnormal handling costs instructions on every
// score.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of C tiles 2j and 2j + 1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// A operand: rows row0..row0+15, k k0..k0+15 of a row-major tile.
template <int SS>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int row0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, smem_u32(tile + (row0 + (l & 15)) * SS + k0 + (l >> 4) * 8));
}
// B operands of the two 8-column tiles n0.. and n0 + 8.. from a tile whose
// rows are the columns n and whose k runs along the row (K for q k^T):
// b[0], b[1] for n0, b[2], b[3] for n0 + 8.
template <int SS>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* tile,
                                     int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, smem_u32(tile + (n0 + (l & 7) + ((l >> 4) << 3)) * SS + k0 +
                      ((l >> 3) & 1) * 8));
}
// The same from a tile whose rows are k and whose columns n run along the
// row (V for p v): transposed on the way out of shared memory.
template <int SS>
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], const bf16* tile,
                                      int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, smem_u32(tile + (k0 + (l & 15)) * SS + n0 + (l >> 4) * 8));
}

// A warp's 16 rows of a block-fixed tile as A operands, one per k-step:
// held in registers (kReg) or read from shared memory at each use.
template <int KD, int SS, bool kReg> struct ARows;
template <int KD, int SS> struct ARows<KD, SS, true> {
  uint32_t f[KD][4];
  __device__ __forceinline__ void init(const bf16* tile, int row0) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ld_a<SS>(f[kk], tile, row0, kk * 16);
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};
template <int KD, int SS> struct ARows<KD, SS, false> {
  const bf16* tile;
  int row0;
  __device__ __forceinline__ void init(const bf16* t, int r) {
    tile = t;
    row0 = r;
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    ld_a<SS>(a, tile, row0, kk * 16);
  }
};

// Rows [r0, r0 + ROWS) x columns [0, DM) of a row-major (S, D) bf16 matrix
// into a shared tile of row stride DM + 8; zero past S and past D, so a
// padded column never reads stale shared memory.  cp.async of ``vec``
// bytes (16, 8 or 4: the launcher's choice from D and the pointers'
// alignment), asynchronous until the caller's cp_wait; with vec 0 (odd
// D) plain loads and stores, complete at the caller's __syncthreads.
template <int ROWS, int DM>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int S, int D, int vec) {
  constexpr int SS = DM + 8;
  const int tid = threadIdx.x;
  if (vec == 16) {
    constexpr int C = DM / 8;
    for (int i = tid; i < ROWS * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 8;
      const bool ok = r0 + r < S && c < D;
      cp_async16(smem_u32(dst + r * SS + c),
                 ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
    }
  } else if (vec == 8) {
    constexpr int C = DM / 4;
    for (int i = tid; i < ROWS * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 4;
      const bool ok = r0 + r < S && c < D;
      cp_async_ca<8>(smem_u32(dst + r * SS + c),
                     ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 8 : 0);
    }
  } else if (vec == 4) {
    constexpr int C = DM / 2;
    for (int i = tid; i < ROWS * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 2;
      const bool ok = r0 + r < S && c < D;
      cp_async_ca<4>(smem_u32(dst + r * SS + c),
                     ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 4 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DM; i += kThreads) {
      const int r = i / DM, c = i % DM;
      dst[r * SS + c] = (r0 + r < S && c < D)
                            ? src[(size_t)(r0 + r) * D + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// ROWS fp32 values from src[r0..] (lse or dsum rows), zero past S.
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = r0 + i < S;
    cp_async_ca<4>(smem_u32(dst + i), ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ bool seen(int qi, int kj, int causal, int window) {
  return (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// Whether every (query, key) pair of query rows [qa, qa + nq) and keys
// [ka, ka + nk) is visible and in range: then no element is masked.
__device__ __forceinline__ bool all_seen(int qa, int nq, int ka, int nk,
                                         int Sq, int Sk, int causal,
                                         int window) {
  return qa + nq <= Sq && ka + nk <= Sk &&
         (!causal || ka + nk - 1 <= qa) &&
         (window <= 0 || qa + nq - 1 - ka < window);
}

// The maximum and the sum of a lane's part of C rows g (h 0) and g + 8
// (h 1) over NT tiles, as trees rather than one dependent chain.
template <int NT>
__device__ __forceinline__ float rows_max(const float (&c)[NT][4], int h) {
  float r[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) r[j] = fmaxf(c[j][2 * h], c[j][2 * h + 1]);
#pragma unroll
  for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) r[j] = fmaxf(r[j], r[j + w]);
  return r[0];
}
template <int NT>
__device__ __forceinline__ float rows_sum(const float (&c)[NT][4], int h) {
  float r[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) r[j] = c[j][2 * h] + c[j][2 * h + 1];
#pragma unroll
  for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) r[j] += r[j + w];
  return r[0];
}

// Sum over the 4 lanes of a quad (the lanes that share a C row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------------------------------
// Forward.  Grid (B*H, query tiles, NZ); the last query tile first, so the
// longest causal bands start first.
// ---------------------------------------------------------------------------
template <int DM, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int D,
              int causal, int window, float scale, float softcap, int vec) {
  using C = Cfg<DM>;
  constexpr int BM = C::BM, BN = C::BN, SS = C::SS, DC = C::DC, KD = C::KD;
  constexpr int NT = BN / 8, NO = DC / 8;
  const int bh = blockIdx.x, c0 = blockIdx.z * DC;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)kvrow * Sk * D;
  const bf16* vb = v + (size_t)kvrow * Sk * D;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // BM x SS
  bf16* sK = sQ + BM * SS;                    // 2 stages of BN x SS
  bf16* sV = sK + 2 * BN * SS;                // 2 stages of BN x SS

  int lo, hi;
  key_band(q0, BM, BN, Sk, causal, window, &lo, &hi);
  load_rows<BM, DM>(sQ, qb, q0, Sq, D, vec);
  cp_commit();
  if (lo < hi) {
    load_rows<BN, DM>(sK, kb, lo * BN, Sk, D, vec);
    load_rows<BN, DM>(sV, vb, lo * BN, Sk, D, vec);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  ARows<KD, SS, (DM <= 128)> qa;
  qa.init(sQ, warp * 16);

  const int r_lo = q0 + warp * 16, row[2] = {r_lo + g, r_lo + g + 8};
  const float sl = scale * kLog2e;
  const float cin = softcap > 0.f ? scale / softcap : 0.f;
  const float cout = softcap * kLog2e;
  float acc[NO][4], m[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1, k0 = kt * BN;
    cp_wait<0>();      // this tile has landed, for every thread once past
    __syncthreads();   // the barrier, and every warp is done with the other
    if (kt + 1 < hi) {   // stage: the next tile goes there
      load_rows<BN, DM>(sK + (st ^ 1) * BN * SS, kb, k0 + BN, Sk, D, vec);
      load_rows<BN, DM>(sV + (st ^ 1) * BN * SS, vb, k0 + BN, Sk, D, vec);
    }
    cp_commit();
    const bf16* tK = sK + st * BN * SS;
    const bf16* tV = sV + st * BN * SS;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      qa.get(a, kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ld_b<SS>(b, tK, j * 16, kk * 16);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }
    // scale and softcap, in log2 units; the mask where the tile is not
    // wholly visible to this warp's rows; the running max
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = tanhf(s[j][e] * cin) * cout;
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl;
    }
    if (!all_seen(r_lo, 16, k0, BN, 1 << 30, Sk, causal, window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
          if (!seen(row[e >> 1], kj, causal, window)) s[j][e] = kMasked2;
          if (kj >= Sk) s[j][e] = -INFINITY;   // not a key at all
        }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = fmaxf(m[h], quad_max(rows_max(s, h)));
      corr[h] = exp2_fast(m[h] - mx);
      m[h] = mx;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2_fast(s[j][e] - m[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)    // this lane's part of the row sum
      l[h] = l[h] * corr[h] + rows_sum(s, h);
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= corr[e >> 1];
    // o += p v: p in v's type, from registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < NO / 2; ++d) {
        uint32_t b[4];
        ld_bt<SS>(b, tV, kk * 16, c0 + d * 16);
        mma(acc[2 * d], a, b[0], b[1]);
        mma(acc[2 * d + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaxf(quad_sum(l[h]), 1e-30f);
  bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Sq) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + d * 8 + 2 * t4 + e;
        if (col < D)
          ob[(size_t)row[h] * D + col] = __float2bfloat16(acc[d][2 * h + e]
                                                           / l[h]);
      }
    if (kLse && blockIdx.z == 0 && t4 == 0)
      lse[(size_t)bh * Sq + row[h]] = m[h] * kLn2 + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dq.  Grid (B*H, query tiles, NZ), the last query tile first.
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int D,
             int causal, int window, float scale, float softcap, int vec) {
  using C = Cfg<DM>;
  constexpr int BM = C::BM, BN = C::BN, SS = C::SS, DC = C::DC, KD = C::KD;
  constexpr int NT = BN / 8, NO = DC / 8;
  const int bh = blockIdx.x, c0 = blockIdx.z * DC;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvrow = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)kvrow * Sk * D;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // BM x SS
  bf16* sDO = sQ + BM * SS;                   // BM x SS
  bf16* sK = sDO + BM * SS;                   // 2 stages of BN x SS
  bf16* sV = sK + 2 * BN * SS;                // 2 stages of BN x SS

  int lo, hi;
  key_band(q0, BM, BN, Sk, causal, window, &lo, &hi);
  load_rows<BM, DM>(sQ, q + qoff, q0, Sq, D, vec);
  load_rows<BM, DM>(sDO, dout + qoff, q0, Sq, D, vec);
  cp_commit();
  if (lo < hi) {
    load_rows<BN, DM>(sK, k + koff, lo * BN, Sk, D, vec);
    load_rows<BN, DM>(sV, v + koff, lo * BN, Sk, D, vec);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  ARows<KD, SS, false> qa, da;   // registers go to s, dp and dq
  qa.init(sQ, warp * 16);
  da.init(sDO, warp * 16);

  const int r_lo = q0 + warp * 16, row[2] = {r_lo + g, r_lo + g + 8};
  float lse2[2], dsr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Sq;
    lse2[h] = in ? lse[(size_t)bh * Sq + row[h]] * kLog2e : 0.f;
    dsr[h] = in ? dsum[(size_t)bh * Sq + row[h]] : 0.f;
  }
  const float sl = scale * kLog2e;
  const float cin = softcap > 0.f ? scale / softcap : 0.f;
  const float cout = softcap * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1, k0 = kt * BN;
    cp_wait<0>();      // as in the forward: one barrier a tile
    __syncthreads();
    if (kt + 1 < hi) {
      load_rows<BN, DM>(sK + (st ^ 1) * BN * SS, k + koff, k0 + BN, Sk, D,
                        vec);
      load_rows<BN, DM>(sV + (st ^ 1) * BN * SS, v + koff, k0 + BN, Sk, D,
                        vec);
    }
    cp_commit();
    const bf16* tK = sK + st * BN * SS;
    const bf16* tV = sV + st * BN * SS;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], ad[4];
      qa.get(a, kk);
      da.get(ad, kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ld_b<SS>(b, tK, j * 16, kk * 16);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
        ld_b<SS>(b, tV, j * 16, kk * 16);
        mma(dp[2 * j], ad, b[0], b[1]);
        mma(dp[2 * j + 1], ad, b[2], b[3]);
      }
    }
    // p = exp(s - lse), ds = p (dp - dsum) (1 - tanh^2): _bwd_block's
    // algebra; ds = 0 where the pair is masked or out of range
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float th = tanhf(s[j][e] * cin);
          s[j][e] = exp2_fast(fmaf(th, cout, -lse2[e >> 1])) *
                    (dp[j][e] - dsr[e >> 1]) * (1.f - th * th);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2_fast(fmaf(s[j][e], sl, -lse2[e >> 1])) *
                    (dp[j][e] - dsr[e >> 1]);
    }
    if (!all_seen(r_lo, 16, k0, BN, Sq, Sk, causal, window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e >> 1], kj = k0 + j * 8 + 2 * t4 + (e & 1);
          if (!(r < Sq && kj < Sk && seen(r, kj, causal, window)))
            s[j][e] = 0.f;
        }
    }
    // dq += ds k, ds in k's type, from registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < NO / 2; ++d) {
        uint32_t b[4];
        ld_bt<SS>(b, tK, kk * 16, c0 + d * 16);
        mma(acc[2 * d], a, b[0], b[1]);
        mma(acc[2 * d + 1], a, b[2], b[3]);
      }
    }
  }
  bf16* out = dq + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Sq) continue;
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + d * 8 + 2 * t4 + e;
        if (col < D)
          out[(size_t)row[h] * D + col] =
              __float2bfloat16(acc[d][2 * h + e] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv of one KV head.  Grid (B*Hkv, key tiles, NZ).  The
// products run transposed (s^T = k q^T, dp^T = v do^T), so a warp's 16 key
// rows hold p^T and ds^T as A fragments for dv += p^T do and dk += ds^T q.
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv,
              int Sq, int Sk, int D, int causal, int window, float scale,
              float softcap, int vec) {
  using C = Cfg<DM>;
  constexpr int BM = C::BM, BN = C::BN, SS = C::SS, DC = C::DC, KD = C::KD;
  constexpr int NT = BN / 8, NO = DC / 8;
  const int kvrow = blockIdx.x, k0 = blockIdx.y * BM, c0 = blockIdx.z * DC;
  const int b = kvrow / Hkv, hk = kvrow % Hkv, G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t koff = (size_t)kvrow * Sk * D;

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_mma);   // BM x SS
  bf16* sV = sK + BM * SS;                    // BM x SS
  bf16* sQ = sV + BM * SS;                    // 2 stages of BN x SS
  bf16* sDO = sQ + 2 * BN * SS;               // 2 stages of BN x SS
  float* sL = reinterpret_cast<float*>(sDO + 2 * BN * SS);   // 2 x BN
  float* sD = sL + 2 * BN;                                   // 2 x BN

  int lo, hi;
  query_band(k0, BN, BM, Sq, causal, window, &lo, &hi);
  const int nq = hi - lo, n = G * nq;   // (g, query tile) pairs, g outer
  load_rows<BM, DM>(sK, k + koff, k0, Sk, D, vec);
  load_rows<BM, DM>(sV, v + koff, k0, Sk, D, vec);
  cp_commit();
  auto load_stage = [&](int it, int st) {
    const int bh = b * H + hk * G + it / nq, q0 = (lo + it % nq) * BN;
    const size_t qoff = (size_t)bh * Sq * D;
    load_rows<BN, DM>(sQ + st * BN * SS, q + qoff, q0, Sq, D, vec);
    load_rows<BN, DM>(sDO + st * BN * SS, dout + qoff, q0, Sq, D, vec);
    load_vec<BN>(sL + st * BN, lse + (size_t)bh * Sq, q0, Sq);
    load_vec<BN>(sD + st * BN, dsum + (size_t)bh * Sq, q0, Sq);
  };
  if (n > 0) load_stage(0, 0);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  ARows<KD, SS, (DM <= 64)> ka, va;
  ka.init(sK, warp * 16);
  va.init(sV, warp * 16);

  const int kw = k0 + warp * 16, key[2] = {kw + g, kw + g + 8};
  const float sl = scale * kLog2e;
  const float cin = softcap > 0.f ? scale / softcap : 0.f;
  const float cout = softcap * kLog2e;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, q0 = (lo + it % nq) * BN;
    cp_wait<0>();      // as in the forward: one barrier a tile
    __syncthreads();
    if (it + 1 < n) load_stage(it + 1, st ^ 1);
    cp_commit();
    const bf16* tQ = sQ + st * BN * SS;
    const bf16* tDO = sDO + st * BN * SS;
    const float* tL = sL + st * BN;
    const float* tD = sD + st * BN;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], av[4];
      ka.get(a, kk);
      va.get(av, kk);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bq[4];
        ld_b<SS>(bq, tQ, j * 16, kk * 16);
        mma(s[2 * j], a, bq[0], bq[1]);
        mma(s[2 * j + 1], a, bq[2], bq[3]);
        ld_b<SS>(bq, tDO, j * 16, kk * 16);
        mma(dp[2 * j], av, bq[0], bq[1]);
        mma(dp[2 * j + 1], av, bq[2], bq[3]);
      }
    }
    // rows are keys, columns queries: p^T and ds^T, 0 where masked
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int ci = j * 8 + 2 * t4;
      const float2 L = *reinterpret_cast<const float2*>(tL + ci);
      const float2 Ds = *reinterpret_cast<const float2*>(tD + ci);
      const float l2[2] = {L.x * kLog2e, L.y * kLog2e}, dc[2] = {Ds.x, Ds.y};
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float th = tanhf(s[j][e] * cin);
          s[j][e] = exp2_fast(fmaf(th, cout, -l2[e & 1]));
          dp[j][e] = s[j][e] * (dp[j][e] - dc[e & 1]) * (1.f - th * th);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_fast(fmaf(s[j][e], sl, -l2[e & 1]));
          dp[j][e] = s[j][e] * (dp[j][e] - dc[e & 1]);
        }
      }
    }
    if (!all_seen(q0, BN, kw, 16, Sq, Sk, causal, window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + j * 8 + 2 * t4 + (e & 1), kj = key[e >> 1];
          if (!(qi < Sq && kj < Sk && seen(qi, kj, causal, window)))
            s[j][e] = dp[j][e] = 0.f;
        }
    }
    // dv += p^T do, dk += ds^T q, both from registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ap[4], ad[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < NO / 2; ++d) {
        uint32_t bb[4];
        ld_bt<SS>(bb, tDO, kk * 16, c0 + d * 16);
        mma(dva[2 * d], ap, bb[0], bb[1]);
        mma(dva[2 * d + 1], ap, bb[2], bb[3]);
        ld_bt<SS>(bb, tQ, kk * 16, c0 + d * 16);
        mma(dka[2 * d], ad, bb[0], bb[1]);
        mma(dka[2 * d + 1], ad, bb[2], bb[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= Sk) continue;
    bf16* krow = dk + koff + (size_t)key[h] * D;
    bf16* vrow = dv + koff + (size_t)key[h] * D;
#pragma unroll
    for (int d = 0; d < NO; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + d * 8 + 2 * t4 + e;
        if (col < D) {
          krow[col] = __float2bfloat16(dka[d][2 * h + e] * scale);
          vrow[col] = __float2bfloat16(dva[d][2 * h + e]);
        }
      }
  }
}

template <int DM> constexpr size_t fwd_smem() {
  using C = Cfg<DM>;
  return sizeof(bf16) * (size_t)(C::BM + 4 * C::BN) * C::SS;
}
template <int DM> constexpr size_t dq_smem() {
  using C = Cfg<DM>;
  return sizeof(bf16) * (size_t)(2 * C::BM + 4 * C::BN) * C::SS;
}
template <int DM> constexpr size_t dkv_smem() {
  using C = Cfg<DM>;
  return dq_smem<DM>() + sizeof(float) * 4 * C::BN;
}

}  // namespace flash_mma
