// Paged-KV attention over a block table, with the step's K/V scatter (and,
// for int8 pools, its quantize) fused in: the Hopper port of the
// paged-attention family in repro/kernels/paged_attention/kernel.py --
//   paged_attention_update_pallas (_call(fuse=True)), fp and int8 pools;
//   paged_attention_pallas (_call(fuse=False)), the read-only walk, fp and
//   int8 pools.
// One kernel, two compile-time switches: kFuse (write this step's fresh
// rows first) and kQuant (int8 pools with fp32 per-row scales).
//
// What it computes, per request b and kv head h: with kFuse, write this
// step's fresh K/V rows into pool[tables[b, pos // BS], pos % BS, h] (rows
// with pos -1 are not written; with int8 pools each row is quantized here
// first), then attend the S*G query rows of (b, h) -- GQA folded into rows
// r = s*G + g, no K/V repeat -- over the request's logical blocks with
// online softmax (m, l, acc in fp32), causal, sliding-window and softcap
// masks.
//
// Design for a CUDA grid (the TPU kernel carries m/l/acc across a sequential
// grid axis; here nothing carries between blocks):
//   * Split over pages (flash-decoding).  grid (n_tiles * n_split, Hkv, B):
//     a block owns a tile of kRows query rows of (b, h) and one split, a run
//     of `pps` logical blocks (pages), and keeps an online-softmax partial
//     (m, l, acc) of its pages in fp32.  `pps` depends on the block size
//     alone (the wrapper's keys per split), so a split's boundaries, and a
//     row's result, never depend on the batch around it or on the walk's
//     live-block bound; n_split = ceil(nb_live / pps).  With one split the
//     block writes the output itself.  Otherwise each block writes its
//     partial to the workspace, and the last block of (b, h, tile) to
//     finish -- elected by an atomic counter, which it then resets to 0 --
//     merges the partials online in split order, so the result does not
//     depend on the order blocks finish.  A split with no live page leaves
//     (m = -1e9, l = 0, acc = 0), which the merge scales by exactly 0.
//   * Scatter/walk race: the block that reads a page is the one that wrote
//     that page's fresh rows.  Each block writes exactly the fresh rows of
//     (b, h) whose logical page lies in its own split (the last split also
//     owns every page past the walk, written and never read), then
//     __syncthreads, then reads.  The tiles of one (b, h, split) write the
//     same bytes.  Pages are never shared between requests, so no other
//     (b, h) touches them.  The pool pointers carry no __restrict__.
//   * Warps on the keys.  QK: each lane group of LPK lanes takes two keys
//     at a time (each q vector read from shared memory feeds both), its
//     lanes splitting D in 16-byte vectors, and the kRows row sums are
//     added over the group by a butterfly that halves the rows a lane keeps
//     at each shuffle (16 rows over 32 lanes: 16 shuffles, not 80).
//     Softmax: a warp per row, a warp's rows interleaved, max and sum by
//     shuffles over the keys.  PV: each thread keeps kCols output columns
//     of RPT rows in fp32 registers.  Rows past the tile's live ones (8 of
//     16 at gemma-2b decode) are skipped.  The next page is brought into
//     shared memory with cp.async while the current one computes (two
//     stages; one where two do not fit, fp32 D 256 with 64-row pages).
//   * int8 quantize of the fresh rows, a warp per row: scale = amax|x| *
//     fp32(1/127), inv = scale > 0 ? 1/scale : 0 (IEEE division: the build
//     has no fast-math), q = clamp(rint(x * inv), -127, 127) -- the plain
//     ref.quantize_rows, fp32 op for fp32 op, so int8 rows and scales come
//     out bit-equal to the plain scatter's.
//   * Masks and constants as in _paged_kernel: q is scaled by D^-0.5 in
//     fp32; softcap tanh before masking; masked scores are -1e9 (not -inf),
//     so a row that sees only masked keys averages them and a fully padded
//     request gives finite output, never NaN; l is floored at 1e-30 (and
//     the output is acc times its reciprocal, __frcp_rn); blocks
//     past max(maxp, 0) // BS or wholly before minp - window + 1 are
//     skipped (in 64-bit: minp is 2^30 for a request with no live row and
//     window may be 2^30).
//   * Types: q, out and the fresh rows share the model dtype T (fp32 or
//     bf16).  fp pools are T as well; like the TPU kernel (kernel.py:139) p
//     is rounded to T before the PV product.  int8 pools (kQuant): the walk
//     dequantizes each page row in fp32 (int8 * its scale) before QK and
//     before PV, and p stays fp32.
//
// Bound on an H100: bytes.  A decode step reads each live K/V page once
// (2 * live_tokens * D * itemsize per (b, h), plus 8 bytes of scales per
// row with int8 pools) and does 4 * D flops per key per query row, far below
// the ~295 flop/byte ridge.  At decode the time is latency, not bytes:
// splitting the pages over blocks puts one page's latency, not one per
// page, on the critical path and fills more SMs than B * Hkv; the queries'
// loads are issued first, so they overlap the scatter's; the merge brings
// the partials into shared memory in one round of cp.async.  Every K/V
// access is a 16-byte vector.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // query rows (s, g) per tile
constexpr int kPS = kRows + 4;       // p^T row stride (floats): 16-byte rows
constexpr int kCols = 2;             // output columns per thread in PV
constexpr float kNegInf = -1e9f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vectors: every row of q, k_new, v_new and the pools starts on a
// 16-byte boundary (the wrapper checks the base pointers; D * itemsize is
// a multiple of 16 for every head dim the wrapper admits).
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
// Unpack one 16-byte vector of T into fp32, times ``scale``.
__device__ __forceinline__ void unpack(float* dst, uint4 v, float scale,
                                       const float*) {
  dst[0] = __uint_as_float(v.x) * scale;
  dst[1] = __uint_as_float(v.y) * scale;
  dst[2] = __uint_as_float(v.z) * scale;
  dst[3] = __uint_as_float(v.w) * scale;
}
__device__ __forceinline__ void unpack(float* dst, uint4 v, float scale,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x * scale;
    dst[2 * i + 1] = f.y * scale;
  }
}
// Sixteen int8 values times their row's scale, in fp32 (the dequantize of
// the plain version: fp32(q) * scale, one rounding).
__device__ __forceinline__ void unpack(float* dst, uint4 v, float scale,
                                       const int8_t*) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]) * scale;
}

// Two neighbouring values of a page row in fp32 (the PV product's V).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The pools' element type: T, or int8 with kQuant.
template <typename T, bool kQuant> struct Pool { using type = T; };
template <typename T> struct Pool<T, true> { using type = int8_t; };

// Dynamic shared memory, byte offsets (each 16-byte aligned): q * scale
// (kRows x D fp32); nst stages of one K and one V page of head h in the
// pools' type (BS x D each); their scales with int8 pools (nst x 2 x BS
// fp32); p^T (BS x kPS fp32); m, l, corr and the rows' positions (kRows
// each).
struct Smem {
  size_t q, kv, sc, p, ml, total;
};
__host__ __device__ inline Smem layout(int D, int BS, int nst, int psize,
                                       bool quant) {
  Smem s;
  s.q = 0;
  s.kv = s.q + sizeof(float) * kRows * D;
  s.sc = s.kv + (size_t)nst * 2 * BS * D * psize;
  const size_t nsc = quant ? (size_t)nst * 2 * BS : 0;
  s.p = s.sc + (nsc * sizeof(float) + 15) / 16 * 16;
  s.ml = s.p + sizeof(float) * BS * kPS;
  s.total = s.ml + 4 * sizeof(float) * kRows;
  return s;
}

// Sum each of the kRows values of v over the O * 2 lanes of an aligned lane
// group: a butterfly that halves the rows a lane keeps at each shuffle.  On
// return v[0 .. NR - 1] (NR = kRows / min(2 O, kRows)) hold the sums of rows
// base .. base + NR - 1.  Every row's sum is the same tree of fp32 adds
// (pairs of lanes by bit O, then O / 2, ...), whichever rows a lane keeps.
template <int O, int N>
__device__ __forceinline__ void fly(float (&v)[kRows], int lane, int& base) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int Hf = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < Hf; ++i) {
        const float send = up ? v[i] : v[i + Hf];
        const float keep = up ? v[i + Hf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += Hf;
      fly<O / 2, Hf>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      fly<O / 2, 1>(v, lane, base);
    }
  }
}

// k_new/v_new are the fresh rows in T (read only with kFuse), ks_pool and
// vs_pool the fp32 scale pools (NB, BS, Hkv), read and written only with
// kQuant.  ws holds n_split > 1's partials: acc (slots x kRows x D), then
// m and l (slots x 2 x kRows), a slot per (b, h, tile, split); counters one
// int per (b, h, tile), 0 between launches.
template <typename T, int D, bool kQuant, bool kFuse>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
             const T* __restrict__ v_new,
             typename Pool<T, kQuant>::type* k_pool,
             typename Pool<T, kQuant>::type* v_pool, float* ks_pool,
             float* vs_pool, const int* __restrict__ tables,
             const int* __restrict__ positions, T* __restrict__ out,
             float* ws, int* counters, int S, int H, int Hkv, int BS, int MB,
             int nb_live, int n_split, int pps, int nst, int window,
             float scale, float softcap) {
  using P = typename Pool<T, kQuant>::type;
  constexpr int QN = Vec<T>::N;      // T elements per 16-byte vector
  constexpr int QV = D / QN;         // T vectors per head row
  constexpr int VN = Vec<P>::N;      // pool elements per 16-byte vector
  constexpr int DV = D / VN;         // pool vectors per head row
  constexpr int LPK = DV < 32 ? DV : 32;   // QK: lanes per key
  constexpr int NVL = DV / LPK;            // QK: vectors per lane per key
  constexpr int KPW = 32 / LPK;            // QK: keys per warp at a time
  constexpr int NR = kRows / (LPK < kRows ? LPK : kRows);
  constexpr int TPR = D / kCols;           // PV: threads per row group
  constexpr int RPT = kRows / (kThreads / TPR);   // PV: rows per thread
  static_assert(kThreads % TPR == 0 && RPT >= 1, "PV thread layout");
  const int n_tiles = gridDim.x / n_split;
  const int tile = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / Hkv;
  const int SG = S * G;
  const int r0 = tile * kRows;
  const int nrows = min(kRows, SG - r0);   // live rows of this tile

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = layout(D, BS, nst, sizeof(P), kQuant);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  P* kv_s = reinterpret_cast<P*>(smem + L.kv);
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  float* p_s = reinterpret_cast<float*>(smem + L.p);    // [key][row]
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;          // correction exp(m_prev - m_new)
  int* qpos_s = reinterpret_cast<int*>(c_s + kRows);
  __shared__ int maxp_s, minp_s, last_s;

  const int* pos_b = positions + (size_t)b * S;
  const int* tab_b = tables + (size_t)b * MB;
  const size_t row_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)BS * row_stride;

  // 0. This tile's queries, loaded first: their latency overlaps the
  // bounds and the scatter below.
  constexpr int kQL = (kRows * QV + kThreads - 1) / kThreads;
  uint4 qraw[kQL];
#pragma unroll
  for (int k = 0; k < kQL; ++k) {
    const int idx = tid + k * kThreads;
    const int r = idx / QV, d = (idx % QV) * QN;
    const int row = r0 + r;
    qraw[k] = make_uint4(0, 0, 0, 0);   // all-zero bits: 0.0 in fp32 and bf16
    if (idx < kRows * QV && row < SG)
      qraw[k] = ld16(q + (((size_t)b * S + row / G) * H + h * G + row % G) *
                             D + d);
  }
  // 1. Request bounds over all S rows.
  if (warp == 0) {
    int mx = -1, mn = 1 << 30;
    for (int s = lane; s < S; s += 32) {
      const int p = pos_b[s];
      mx = max(mx, p);
      if (p >= 0) mn = min(mn, p);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      maxp_s = mx;
      minp_s = mn;
    }
  }
  // 2. Write the fresh rows whose page lies in this split, and with int8
  // pools quantize them first (a warp per row).
  if constexpr (kFuse) {
    if constexpr (kQuant) {
      constexpr int NQ = (QV + 31) / 32;   // T vectors per lane
      for (int task = warp; task < 2 * S; task += kWarps) {
        const int s = task >> 1;
        const int p = pos_b[s];
        if (p < 0 || min(p / BS / pps, n_split - 1) != split) continue;
        const bool is_v = task & 1;
        const T* src = (is_v ? v_new : k_new) +
                       (((size_t)b * S + s) * Hkv + h) * D;
        float x[NQ][QN];
        float amax = 0.f;
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
          const int vi = lane + 32 * u;
          if (vi < QV) {
            unpack(x[u], ld16(src + vi * QN), 1.f, src);
#pragma unroll
            for (int e = 0; e < QN; ++e) amax = fmaxf(amax, fabsf(x[u][e]));
          }
        }
#pragma unroll
        for (int o = 16; o; o >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const float sc = amax * (1.0f / 127.0f);
        const float inv = sc > 0.f ? 1.0f / sc : 0.f;
        const size_t slot = (size_t)tab_b[p / BS] * BS + p % BS;
        int8_t* dst = (is_v ? v_pool : k_pool) + slot * row_stride +
                      (size_t)h * D;
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
          const int vi = lane + 32 * u;
          if (vi < QV) {
            uint32_t word[QN / 4];
#pragma unroll
            for (int w = 0; w < QN / 4; ++w) word[w] = 0;
#pragma unroll
            for (int e = 0; e < QN; ++e) {
              const float r =
                  fminf(fmaxf(rintf(x[u][e] * inv), -127.f), 127.f);
              word[e / 4] |= (uint32_t)(uint8_t)(int8_t)(int)r
                             << (8 * (e % 4));
            }
            if constexpr (QN == 4) {
              *reinterpret_cast<uint32_t*>(dst + vi * QN) = word[0];
            } else {
              *reinterpret_cast<uint2*>(dst + vi * QN) =
                  make_uint2(word[0], word[1]);
            }
          }
        }
        if (lane == 0) (is_v ? vs_pool : ks_pool)[slot * Hkv + h] = sc;
      }
    } else {
      for (int idx = tid; idx < S * QV; idx += kThreads) {
        const int s = idx / QV, d = (idx % QV) * QN;
        const int p = pos_b[s];
        if (p < 0 || min(p / BS / pps, n_split - 1) != split) continue;
        const size_t dst = (size_t)tab_b[p / BS] * page_stride +
                           (size_t)(p % BS) * row_stride + (size_t)h * D + d;
        const size_t src = (((size_t)b * S + s) * Hkv + h) * D + d;
        st16(k_pool + dst, ld16(k_new + src));
        st16(v_pool + dst, ld16(v_new + src));
      }
    }
  }
  // 3. This tile's scaled queries and the rows' state.
#pragma unroll
  for (int k = 0; k < kQL; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < kRows * QV)
      unpack(q_s + (idx / QV) * D + (idx % QV) * QN, qraw[k], scale, q);
  }
  if (tid < kRows) {
    const int row = r0 + tid;
    qpos_s[tid] = row < SG ? pos_b[row / G] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }
  __syncthreads();   // the fresh rows above are now visible to every thread

  // 4. This split's pages, skipping any wholly before the window.
  const int maxp = maxp_s;
  const int jend = maxp >= 0 ? min(maxp / BS, nb_live - 1) : -1;
  const long long lo = (long long)minp_s - (long long)window + 1;
  int j0 = split * pps;
  const int j1 = min(j0 + pps, jend + 1);
  if (lo > 0) j0 = (int)max((long long)j0, min(lo / BS, (long long)j1));
  const int n = j1 - j0;

  auto issue = [&](int j, int st) {
    const size_t base = (size_t)tab_b[j] * page_stride + (size_t)h * D;
    P* ks = kv_s + (size_t)st * 2 * BS * D;
    P* vs = ks + (size_t)BS * D;
    for (int i = tid; i < BS * DV; i += kThreads) {
      const int c = i / DV, d = (i % DV) * VN;
      const size_t off = base + (size_t)c * row_stride + d;
      cp_async16(ks + c * D + d, k_pool + off);
      cp_async16(vs + c * D + d, v_pool + off);
    }
    if constexpr (kQuant) {
      float* sc = sc_s + st * 2 * BS;
      for (int i = tid; i < 2 * BS; i += kThreads) {
        const size_t slot = ((size_t)tab_b[j] * BS + i % BS) * Hkv + h;
        cp_async4(sc + i, (i < BS ? ks_pool : vs_pool) + slot);
      }
    }
    cp_commit();
  };

  const int col = (tid % TPR) * kCols, rg = tid / TPR;
  float acc[RPT][kCols];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[i][k] = 0.f;

  if (n > 0) issue(j0, 0);
  for (int i = 0; i < n; ++i) {
    const int j = j0 + i, st = nst == 2 ? (i & 1) : 0;
    cp_wait_all();
    __syncthreads();   // page j landed; page j - 1's buffers are free
    if (nst == 2 && i + 1 < n) issue(j + 1, st ^ 1);
    const P* ks = kv_s + (size_t)st * 2 * BS * D;
    const P* vs = ks + (size_t)BS * D;
    const float* ksc = sc_s + st * 2 * BS;
    const float* vsc = ksc + BS;
    // QK: a lane group per key, its lanes over D, two keys a group at a
    // time so each q vector read from shared memory feeds both; rows past
    // the tile's live ones stay 0; idle groups read key BS - 1 and write
    // nothing
    {
      const int grp = lane / LPK, sub = lane % LPK;
      constexpr int kStep = kWarps * KPW;   // keys the block takes at once
      for (int c0 = warp * KPW; c0 < BS; c0 += 2 * kStep) {
        const int c[2] = {c0 + grp, c0 + kStep + grp};
        float v[2][kRows];
        float kscale[2];
        const P* kr[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int cc = c[k] < BS ? c[k] : BS - 1;
          kr[k] = ks + cc * D;
          kscale[k] = kQuant ? ksc[cc] : 1.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[k][r] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < NVL; ++u) {
          const int d = (sub + u * LPK) * VN;
          float kf[2][VN];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            unpack(kf[k], ld16(kr[k] + d), kscale[k], kr[k]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nrows) {
              const float* qr = q_s + r * D + d;
#pragma unroll
              for (int e = 0; e < VN; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  v[k][r] = fmaf(qv.x, kf[k][e], v[k][r]);
                  v[k][r] = fmaf(qv.y, kf[k][e + 1], v[k][r]);
                  v[k][r] = fmaf(qv.z, kf[k][e + 2], v[k][r]);
                  v[k][r] = fmaf(qv.w, kf[k][e + 3], v[k][r]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          int rb = 0;
          fly<LPK / 2, kRows>(v[k], lane, rb);
          if (c[k] < BS) {
            const int kp = j * BS + c[k];
#pragma unroll
            for (int t = 0; t < NR; ++t) {
              const int r = rb + t;
              float s = v[k][t];
              if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
              const int qp = qpos_s[r];
              const bool valid = kp <= qp && qp - kp < window && qp >= 0;
              p_s[c[k] * kPS + r] = valid ? s : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();
    // softmax: a warp per row, its kRows / kWarps rows interleaved, lanes
    // over the page's keys (BS <= 64); rows past the live ones skipped
#pragma unroll
    for (int w = 0; w < kRows / kWarps; ++w) {
      const int r = warp + w * kWarps;
      if (r >= nrows) continue;
      const float m_prev = m_s[r];
      const bool in0 = lane < BS, in1 = lane + 32 < BS;
      const float s0 = in0 ? p_s[lane * kPS + r] : kNegInf;
      const float s1 = in1 ? p_s[(lane + 32) * kPS + r] : kNegInf;
      float mx = fmaxf(m_prev, fmaxf(s0, s1));
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float e0 = in0 ? expf(s0 - mx) : 0.f;
      const float e1 = in1 ? expf(s1 - mx) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      // p in the pool dtype for PV; fp32 against dequantized int8 pages
      if (in0) p_s[lane * kPS + r] = kQuant ? e0 : to_f32(from_f32<T>(e0));
      if (in1)
        p_s[(lane + 32) * kPS + r] = kQuant ? e1 : to_f32(from_f32<T>(e1));
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = mx;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // PV: kCols columns of RPT rows a thread
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const float corr = c_s[rg * RPT + t];
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[t][k] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      float2 vv = ld2(vs + c * D + col);
      if constexpr (kQuant) {
        vv.x *= vsc[c];
        vv.y *= vsc[c];
      }
      const float* pr = p_s + c * kPS + rg * RPT;
      if constexpr (RPT % 4 == 0) {
#pragma unroll
        for (int t = 0; t < RPT; t += 4) {
          if (rg * RPT + t >= nrows) continue;   // rows past the live ones
          const float4 pv = *reinterpret_cast<const float4*>(pr + t);
          const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[t + u][0] = fmaf(pp[u], vv.x, acc[t + u][0]);
            acc[t + u][1] = fmaf(pp[u], vv.y, acc[t + u][1]);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          acc[t][0] = fmaf(pr[t], vv.x, acc[t][0]);
          acc[t][1] = fmaf(pr[t], vv.y, acc[t][1]);
        }
      }
    }
    if (nst == 1 && i + 1 < n) {
      __syncthreads();   // every thread is done with the one stage
      issue(j + 1, 0);
    }
  }

  // 5. One split: normalise and write.  Several: write the partial; the
  // last block of (b, h, tile) combines them in split order.
  if (n_split == 1) {
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const int r = rg * RPT + t;
      if (r < nrows) {
        const int row = r0 + r, s = row / G, g = row % G;
        const float inv = __frcp_rn(fmaxf(l_s[r], 1e-30f));
        T* o = out + (((size_t)b * S + s) * H + h * G + g) * D + col;
        o[0] = from_f32<T>(acc[t][0] * inv);
        o[1] = from_f32<T>(acc[t][1] * inv);
      }
    }
    return;
  }
  const size_t n_slots = (size_t)gridDim.z * Hkv * n_tiles * n_split;
  const size_t first = (((size_t)b * Hkv + h) * n_tiles + tile) * n_split;
  float* wa = ws;                          // [slot][kRows][D]
  float* wm = ws + n_slots * kRows * D;    // [slot][m, l][kRows]
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    const int r = rg * RPT + t;
    if (r < nrows)
      *reinterpret_cast<float2*>(wa + ((first + split) * kRows + r) * D +
                                 col) = make_float2(acc[t][0], acc[t][1]);
  }
  if (tid < nrows) {
    wm[(first + split) * 2 * kRows + tid] = m_s[tid];
    wm[(first + split) * 2 * kRows + kRows + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* count = counters + ((size_t)b * Hkv + h) * n_tiles + tile;
  if (tid == 0) last_s = atomicAdd(count, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // The last block combines.  Chunks of splits' partials (the live rows'
  // acc, then m and l) are copied into shared memory, which the walk no
  // longer needs, with cp.async -- every copy of a chunk in flight at once
  // -- and merged from there, in split order, online: per row M = max(M,
  // m), the running sums scaled by co = exp(M_old - M) and the split's by
  // cn = exp(m - M), from M = -inf, L = 0, acc = 0.  A thread per live row
  // computes a chunk's co and cn; then each thread scales and adds its
  // 16-byte column vectors.  The first split gives co = 0, cn = 1: it is
  // taken as it is; a split with no key of the row (m = -1e9, l = 0, acc =
  // 0) gives co = 1, cn = 0: it changes nothing.  So a row's result is the
  // same whatever n_split is, and equals the one-split path's.
  constexpr int D4 = D / 4;
  constexpr int kVecs = (kRows * D4 + kThreads - 1) / kThreads;
  float* stage = reinterpret_cast<float*>(smem);
  const int split_floats = nrows * D + 2 * kRows;   // acc rows, m, l
  const int per_chunk =
      max(1, (int)(L.ml / (sizeof(float) * (split_floats + 2 * kRows))));
  float* fac = stage + per_chunk * split_floats;    // [split][co, cn][row]
  float mrow = -INFINITY, lrow = 0.f;                // thread tid's row
  float4 a[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n_split; c0 += per_chunk) {
    const int nc = min(per_chunk, n_split - c0);
    for (int jj = 0; jj < nc; ++jj) {
      const size_t slot = first + c0 + jj;
      for (int e = tid * 4; e < split_floats; e += kThreads * 4)
        cp_async16(stage + jj * split_floats + e,
                   e < nrows * D ? wa + slot * kRows * D + e
                                 : wm + slot * 2 * kRows + (e - nrows * D));
    }
    cp_commit();
    cp_wait_all();
    __syncthreads();
    if (tid < nrows) {
      for (int jj = 0; jj < nc; ++jj) {
        const float* sp = stage + jj * split_floats + nrows * D;
        const float m = sp[tid], l = sp[kRows + tid];
        const float mn = fmaxf(mrow, m);
        const float co = expf(mrow - mn), cn = expf(m - mn);
        lrow = fmaf(l, cn, lrow * co);
        mrow = mn;
        fac[jj * 2 * kRows + tid] = co;
        fac[jj * 2 * kRows + kRows + tid] = cn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = tid + k * kThreads, r = v / D4;
      if (r >= nrows) continue;
      for (int jj = 0; jj < nc; ++jj) {
        const float co = fac[jj * 2 * kRows + r];
        const float cn = fac[jj * 2 * kRows + kRows + r];
        const float4 x = *reinterpret_cast<const float4*>(
            stage + jj * split_floats + r * D + (v % D4) * 4);
        a[k].x = fmaf(x.x, cn, a[k].x * co);
        a[k].y = fmaf(x.y, cn, a[k].y * co);
        a[k].z = fmaf(x.z, cn, a[k].z * co);
        a[k].w = fmaf(x.w, cn, a[k].w * co);
      }
    }
    __syncthreads();   // the next chunk reuses the stage
  }
  if (tid < nrows) l_s[tid] = __frcp_rn(fmaxf(lrow, 1e-30f));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = tid + k * kThreads, r = v / D4;
    if (r < nrows) {
      const int row = r0 + r, s = row / G, g = row % G;
      T* o = out + (((size_t)b * S + s) * H + h * G + g) * D + (v % D4) * 4;
      const float inv = l_s[r];
      o[0] = from_f32<T>(a[k].x * inv);
      o[1] = from_f32<T>(a[k].y * inv);
      o[2] = from_f32<T>(a[k].z * inv);
      o[3] = from_f32<T>(a[k].w * inv);
    }
  }
  if (tid == 0) *count = 0;   // ready for the next launch on the stream
}

template <typename T, int D, bool kQuant, bool kFuse>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, void* ks_pool, void* vs_pool,
                   const void* tables, const void* positions, void* out,
                   void* ws, void* counters, int B, int S, int H, int Hkv,
                   int BS, int MB, int nb_live, int n_split, int pps,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  using P = typename Pool<T, kQuant>::type;
  int nst = 2;
  size_t smem = layout(D, BS, 2, sizeof(P), kQuant).total;
  if (smem > kMaxSmem) {
    nst = 1;
    smem = layout(D, BS, 1, sizeof(P), kQuant).total;
  }
  static size_t smem_set = 48 * 1024;   // per instantiation: the default cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_kernel<T, D, kQuant, kFuse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int n_tiles = (S * (H / Hkv) + kRows - 1) / kRows;
  const dim3 grid(n_tiles * n_split, Hkv, B);
  paged_kernel<T, D, kQuant, kFuse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), static_cast<float*>(ks_pool),
      static_cast<float*>(vs_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), S, H, Hkv, BS,
      MB, nb_live, n_split, pps, nst, window, scale, softcap);
  return cudaGetLastError();
}

#define PA_ARGS                                                              \
  q, k_new, v_new, k_pool, v_pool, ks_pool, vs_pool, tables, positions, out, \
      ws, counters, B, S, H, Hkv, BS, MB, nb_live, n_split, pps, window,     \
      scale, softcap, stream

template <typename T, bool kQuant, bool kFuse>
cudaError_t launch_d(int D, const void* q, const void* k_new,
                     const void* v_new, void* k_pool, void* v_pool,
                     void* ks_pool, void* vs_pool, const void* tables,
                     const void* positions, void* out, void* ws,
                     void* counters, int B, int S, int H, int Hkv, int BS,
                     int MB, int nb_live, int n_split, int pps, int window,
                     float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kQuant, kFuse>(PA_ARGS);
    case 64: return launch<T, 64, kQuant, kFuse>(PA_ARGS);
    case 128: return launch<T, 128, kQuant, kFuse>(PA_ARGS);
    case 256: return launch<T, 256, kQuant, kFuse>(PA_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int quant, int fuse, int D, const void* q,
                     const void* k_new, const void* v_new, void* k_pool,
                     void* v_pool, void* ks_pool, void* vs_pool,
                     const void* tables, const void* positions, void* out,
                     void* ws, void* counters, int B, int S, int H, int Hkv,
                     int BS, int MB, int nb_live, int n_split, int pps,
                     int window, float scale, float softcap,
                     cudaStream_t stream) {
  if (quant && fuse) return launch_d<T, true, true>(D, PA_ARGS);
  if (quant) return launch_d<T, true, false>(D, PA_ARGS);
  if (fuse) return launch_d<T, false, true>(D, PA_ARGS);
  return launch_d<T, false, false>(D, PA_ARGS);
}

}  // namespace

// dtype (of q, out and the fresh rows): 0 = float32, 1 = bfloat16.  quant:
// the pools are int8 with fp32 scale pools (else of q's dtype).  fuse:
// quantize (with quant) and scatter k_new / v_new before the walk; the
// read-only walk passes null for both.  n_split splits of pps pages each
// (the wrapper's plan); ws (float32) and counters (int32, zero) as the
// kernel's note says, unused with one split.  Returns cudaGetLastError()
// after the launch (0 on success); the Python wrapper raises on anything
// else.
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* ks_pool, void* vs_pool, const void* tables,
    const void* positions, void* out, void* ws, void* counters, int B, int S,
    int H, int Hkv, int D, int BS, int MB, int nb_live, int n_split, int pps,
    int window, float scale, float softcap, int dtype, int quant, int fuse,
    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)launch_t<float>(quant, fuse, D, PA_ARGS);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(quant, fuse, D, PA_ARGS);
  return (int)cudaErrorInvalidValue;
}

// Query rows per tile (kRows): the wrapper's plan checks it.
extern "C" int paged_attention_rows_per_tile() { return kRows; }

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
