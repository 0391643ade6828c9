// Paged-KV attention over a block table, with the step's K/V scatter fused
// in: the Hopper port of the paged-attention family in
// repro/kernels/paged_attention/kernel.py --
//   paged_attention_update_pallas (_call(fuse=True)), fp and int8 pools;
//   paged_attention_pallas (_call(fuse=False)), the read-only walk, fp and
//   int8 pools.
// One kernel, two compile-time switches: kFuse (scatter this step's fresh
// rows first) and kQuant (int8 pools with fp32 per-row scales).
//
// What it computes, per request b and kv head h: with kFuse, write this
// step's fresh K/V rows into pool[tables[b, pos // BS], pos % BS, h] (rows
// with pos -1 are not written), then attend the S*G query rows of (b, h) --
// GQA folded into rows r = s*G + g, no K/V repeat -- over the request's
// logical blocks with online softmax (m, l, acc in fp32), causal,
// sliding-window and softcap masks.
//
// Design for a CUDA grid (the TPU kernel carries m/l/acc across a sequential
// grid axis; here nothing carries between blocks):
//   * grid (ceil(S*G / kRows), Hkv, B); one block owns a tile of kRows query
//     rows of (b, h) and loops over the request's live logical blocks itself.
//     Each block loads its own table row and positions (no scalar prefetch).
//   * Scatter/walk race: the rows of one (b, h) are tiled over several
//     blocks, so a tile could read a page row another tile has not written
//     yet.  Every block therefore writes ALL fresh rows of its (b, h) before
//     it reads any page (then __syncthreads, which makes the block's global
//     writes visible to all of its threads).  Each row it reads was written
//     by itself first; other tiles write the same bytes.  Pages are never
//     shared between requests, so no other (b, h) touches them.  The pool
//     pointers carry no __restrict__ so loads are never served from the
//     read-only cache.
//   * Masks and constants as in _paged_kernel: q is scaled by D^-0.5 in
//     fp32; softcap tanh before masking; masked scores are -1e9 (not -inf),
//     so a fully padded row gives finite garbage, never NaN; l is floored at
//     1e-30; blocks past max(maxp, 0) // BS or wholly before
//     minp - window + 1 are skipped (in 64-bit: minp is 2^30 for a request
//     with no live row and window may be 2^30).
//   * Types: q and out share the model dtype T (fp32 or bf16).  fp pools are
//     T as well; like the TPU kernel (kernel.py:139) p is rounded to T before
//     the PV product.  int8 pools (kQuant): the wrapper quantizes the fresh
//     rows with the plain version's quantize_rows (as the JAX wrapper does,
//     kernel.py:199-208), so the kernel scatters int8 rows and their fp32
//     scales and the pools are bit-equal to the plain scatter by
//     construction; the walk dequantizes each page row in fp32 (int8 * its
//     scale) before QK and before PV, and p stays fp32 (the TPU kernel's
//     p.astype(v.dtype) with v dequantized to fp32).
//
// Bound on an H100: bytes.  A decode step reads each live K/V page once
// (2 * live_tokens * D * itemsize per (b, h), plus 8 bytes of scales per
// row with int8 pools) and does 4 * D flops per key per query row, far below
// the ~295 flop/byte ridge.  This version is simple and right, not fast.
// What it does about the bytes: every K/V access is a 16-byte vector (8
// bf16, 4 fp32 or 16 int8 values), and each thread issues its share of a
// page's K and V loads (up to 4 + 4 vectors) before storing any, so one
// page costs about one memory latency, not one per element; int8 pools
// halve (bf16) or quarter (fp32) the page bytes.  What it does not do yet:
// fp32 dots are scalar from shared memory, pages are not prefetched while
// the previous one computes, and one block per (b, h, tile) means gemma-2b
// decode (MQA, S*G = 8 rows) fills only B blocks of 132 SMs.  Split-K over
// pages (which the read-only walk could take with no scatter race), wgmma
// and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;          // query rows (s, g) per block
constexpr float kNegInf = -1e9f;

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
// Unpack one 16-byte vector of T into fp32, times ``scale``, to shared memory.
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

// The pools' element type: T, or int8 with kQuant.
template <typename T, bool kQuant> struct Pool { using type = T; };
template <typename T> struct Pool<T, true> { using type = int8_t; };

size_t smem_bytes(int D, int BS) {
  const int DP = D + 1;
  return sizeof(float) *
         (size_t)(kRows * DP + 2 * BS * DP + kRows * BS + 4 * kRows);
}

// k_new/v_new are P (int8 rows with kQuant), ks_new/vs_new their fp32
// scales (B, S, Hkv) and ks_pool/vs_pool the scale pools (NB, BS, Hkv), read
// only with kQuant; k_new, v_new, ks_new and vs_new only with kFuse.
template <typename T, int D, bool kQuant, bool kFuse>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q,
             const typename Pool<T, kQuant>::type* __restrict__ k_new,
             const typename Pool<T, kQuant>::type* __restrict__ v_new,
             const float* __restrict__ ks_new,
             const float* __restrict__ vs_new,
             typename Pool<T, kQuant>::type* k_pool,
             typename Pool<T, kQuant>::type* v_pool, float* ks_pool,
             float* vs_pool, const int* __restrict__ tables,
             const int* __restrict__ positions, T* __restrict__ out, int S,
             int H, int Hkv, int BS, int MB, int nb_live, int window,
             float scale, float softcap) {
  using P = typename Pool<T, kQuant>::type;
  constexpr int DP = D + 1;          // padded row stride: conflict-free QK^T
  constexpr int kAcc = kRows * D / kThreads;
  constexpr int QN = Vec<T>::N;      // q elements per 16-byte vector
  constexpr int QV = D / QN;         // q vectors per head row
  constexpr int VN = Vec<P>::N;      // pool elements per 16-byte vector
  constexpr int DV = D / VN;         // pool vectors per head row
  constexpr int kBatch = 4;          // vectors in flight per thread
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Hkv;
  const int SG = S * G;
  const int r0 = tile * kRows;
  const int nrows = min(kRows, SG - r0);   // live rows of this tile

  extern __shared__ float smem[];
  float* q_s = smem;                 // kRows x DP, q * scale
  float* k_s = q_s + kRows * DP;     // BS x DP, one K page of head h
  float* v_s = k_s + BS * DP;        // BS x DP
  float* p_s = v_s + BS * DP;        // kRows x BS scores, then p
  float* m_s = p_s + kRows * BS;     // kRows running max
  float* l_s = m_s + kRows;          // kRows running sum
  float* c_s = l_s + kRows;          // kRows correction exp(m_prev - m_new)
  int* qpos_s = reinterpret_cast<int*>(c_s + kRows);   // kRows
  __shared__ int maxp_s, minp_s;

  const int* pos_b = positions + (size_t)b * S;
  const int* tab_b = tables + (size_t)b * MB;
  const size_t row_stride = (size_t)Hkv * D;
  const size_t page_stride = (size_t)BS * row_stride;

  // 1. Scatter every fresh row of (b, h) -- all S of them, in every tile
  // -- and, with int8 pools, each row's two scales.
  if constexpr (kFuse) {
    for (int idx = tid; idx < S * DV; idx += kThreads) {
      const int s = idx / DV, d = (idx % DV) * VN;
      const int p = pos_b[s];
      if (p >= 0) {
        const size_t dst = (size_t)tab_b[p / BS] * page_stride +
                           (size_t)(p % BS) * row_stride + (size_t)h * D + d;
        const size_t src = (((size_t)b * S + s) * Hkv + h) * D + d;
        st16(k_pool + dst, ld16(k_new + src));
        st16(v_pool + dst, ld16(v_new + src));
        if constexpr (kQuant) {
          if (d == 0) {
            const size_t slot = (size_t)tab_b[p / BS] * BS + p % BS;
            const size_t from = ((size_t)b * S + s) * Hkv + h;
            ks_pool[slot * Hkv + h] = ks_new[from];
            vs_pool[slot * Hkv + h] = vs_new[from];
          }
        }
      }
    }
  }
  // 2. Request bounds over all S rows, and this tile's scaled queries.
  if (tid == 0) {
    int mx = -1, mn = 1 << 30;
    for (int s = 0; s < S; ++s) {
      const int p = pos_b[s];
      mx = max(mx, p);
      if (p >= 0) mn = min(mn, p);
    }
    maxp_s = mx;
    minp_s = mn;
  }
  for (int idx = tid; idx < kRows * QV; idx += kThreads) {
    const int r = idx / QV, d = (idx % QV) * QN;
    const int row = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);   // all-zero bits: 0.0 in fp32 and bf16
    if (row < SG) {
      const int s = row / G, g = row % G;
      v = ld16(q + (((size_t)b * S + s) * H + h * G + g) * D + d);
    }
    unpack(q_s + r * DP + d, v, scale, q);
  }
  if (tid < kRows) {
    const int row = r0 + tid;
    qpos_s[tid] = row < SG ? pos_b[row / G] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();   // the scatter above is now visible to every thread

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int maxp = maxp_s;
  const int last = max(maxp, 0) / BS;
  const int jend = maxp >= 0 ? min(last, nb_live - 1) : -1;
  const long long lo = (long long)minp_s - (long long)window + 1;
  for (int j = 0; j <= jend; ++j) {
    if ((long long)j * BS + BS - 1 < lo) continue;   // outside every window
    // Load the page: each thread issues up to kBatch 16-byte K and V loads
    // before it stores any, so their latencies overlap.
    const size_t base = (size_t)tab_b[j] * page_stride + (size_t)h * D;
    for (int i0 = tid; i0 < BS * DV; i0 += kThreads * kBatch) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < BS * DV) {
          const size_t off =
              base + (size_t)(i / DV) * row_stride + (i % DV) * VN;
          kr[u] = ld16(k_pool + off);
          vr[u] = ld16(v_pool + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < BS * DV) {
          const int c = i / DV, d = (i % DV) * VN;
          if constexpr (kQuant) {   // each row times its scale
            const size_t sc = ((size_t)tab_b[j] * BS + c) * Hkv + h;
            unpack(k_s + c * DP + d, kr[u], ks_pool[sc], k_pool);
            unpack(v_s + c * DP + d, vr[u], vs_pool[sc], v_pool);
          } else {
            unpack(k_s + c * DP + d, kr[u], 1.f, k_pool);
            unpack(v_s + c * DP + d, vr[u], 1.f, v_pool);
          }
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nrows * BS; idx += kThreads) {
      const int r = idx / BS, c = idx % BS;
      const float* qr = q_s + r * DP;
      const float* kc = k_s + c * DP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kc[d], s);
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int qp = qpos_s[r];
      const int kp = j * BS + c;
      const bool valid = kp <= qp && qp - kp < window && qp >= 0;
      p_s[r * BS + c] = valid ? s : kNegInf;
    }
    __syncthreads();
    if (tid < nrows) {
      float* pr = p_s + tid * BS;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < BS; ++c) m_new = fmaxf(m_new, pr[c]);
      float sum = 0.f;
      for (int c = 0; c < BS; ++c) {
        const float e = expf(pr[c] - m_new);
        sum += e;
        // p in the pool dtype for PV; fp32 against dequantized int8 pages
        pr[c] = kQuant ? e : to_f32(from_f32<T>(e));
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / D, d = e % D;
      if (r >= nrows) continue;          // uniform per warp when D >= 32
      const float* pr = p_s + r * BS;
      float a = acc[i] * c_s[r];
      for (int c = 0; c < BS; ++c) a = fmaf(pr[c], v_s[c * DP + d], a);
      acc[i] = a;
    }
    __syncthreads();   // k_s, v_s and p_s are rewritten next page
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / D, d = e % D;
    const int row = r0 + r;
    if (r < nrows) {
      const int s = row / G, g = row % G;
      const float l = fmaxf(l_s[r], 1e-30f);
      out[(((size_t)b * S + s) * H + h * G + g) * D + d] =
          from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int D, bool kQuant, bool kFuse>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* ks_new, const void* vs_new, void* k_pool,
                   void* v_pool, void* ks_pool, void* vs_pool,
                   const void* tables, const void* positions, void* out,
                   int B, int S, int H, int Hkv, int BS, int MB, int nb_live,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  using P = typename Pool<T, kQuant>::type;
  const size_t smem = smem_bytes(D, BS);
  static size_t smem_set = 48 * 1024;   // per instantiation: the default cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_kernel<T, D, kQuant, kFuse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((S * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
  paged_kernel<T, D, kQuant, kFuse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_new),
      static_cast<const P*>(v_new), static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), static_cast<P*>(k_pool),
      static_cast<P*>(v_pool), static_cast<float*>(ks_pool),
      static_cast<float*>(vs_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), S, H, Hkv,
      BS, MB, nb_live, window, scale, softcap);
  return cudaGetLastError();
}

#define PA_ARGS                                                            \
  q, k_new, v_new, ks_new, vs_new, k_pool, v_pool, ks_pool, vs_pool,      \
      tables, positions, out, B, S, H, Hkv, BS, MB, nb_live, window, scale, \
      softcap, stream

template <typename T, bool kQuant, bool kFuse>
cudaError_t launch_d(int D, const void* q, const void* k_new,
                     const void* v_new, const void* ks_new,
                     const void* vs_new, void* k_pool, void* v_pool,
                     void* ks_pool, void* vs_pool, const void* tables,
                     const void* positions, void* out, int B, int S, int H,
                     int Hkv, int BS, int MB, int nb_live, int window,
                     float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, kQuant, kFuse>(PA_ARGS);
    case 64: return launch<T, 64, kQuant, kFuse>(PA_ARGS);
    case 256: return launch<T, 256, kQuant, kFuse>(PA_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int quant, int fuse, int D, const void* q,
                     const void* k_new, const void* v_new,
                     const void* ks_new, const void* vs_new, void* k_pool,
                     void* v_pool, void* ks_pool, void* vs_pool,
                     const void* tables, const void* positions, void* out,
                     int B, int S, int H, int Hkv, int BS, int MB,
                     int nb_live, int window, float scale, float softcap,
                     cudaStream_t stream) {
  if (quant && fuse) return launch_d<T, true, true>(D, PA_ARGS);
  if (quant) return launch_d<T, true, false>(D, PA_ARGS);
  if (fuse) return launch_d<T, false, true>(D, PA_ARGS);
  return launch_d<T, false, false>(D, PA_ARGS);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16.  quant: the pools are
// int8 with fp32 scale pools (else of q's dtype).  fuse: scatter k_new /
// v_new (and with quant their scales ks_new / vs_new) before the walk; the
// read-only walk passes null for all four.  Returns cudaGetLastError()
// after the launch (0 on success); the Python wrapper raises on anything
// else.
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* ks_new,
    const void* vs_new, void* k_pool, void* v_pool, void* ks_pool,
    void* vs_pool, const void* tables, const void* positions, void* out,
    int B, int S, int H, int Hkv, int D, int BS, int MB, int nb_live,
    int window, float scale, float softcap, int dtype, int quant, int fuse,
    void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)launch_t<float>(quant, fuse, D, PA_ARGS);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(quant, fuse, D, PA_ARGS);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
