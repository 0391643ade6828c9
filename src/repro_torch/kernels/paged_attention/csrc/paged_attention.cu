// Paged-KV attention with the step's K/V scatter fused in: the Hopper port of
// repro/kernels/paged_attention/kernel.py::paged_attention_update_pallas
// (_call(fuse=True) -> _paged_kernel).
//
// What it computes, per request b and kv head h: write this step's fresh K/V
// rows into pool[tables[b, pos // BS], pos % BS, h] (rows with pos -1 are not
// written), then attend the S*G query rows of (b, h) -- GQA folded into rows
// r = s*G + g, no K/V repeat -- over the request's logical blocks with online
// softmax (m, l, acc in fp32), causal, sliding-window and softcap masks.
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
//   * Types: pools, q, k_new, v_new and out share one dtype (fp32 or bf16).
//     Scores, softmax and acc are fp32; like the TPU kernel (kernel.py:139)
//     p is rounded to the pool dtype before the PV product.
//
// Bound on an H100: bytes.  A decode step reads each live K/V page once
// (2 * live_tokens * D * itemsize per (b, h)) and does 4 * D flops per key
// per query row, far below the ~295 flop/byte ridge.  This version is simple
// and right, not fast.  What it does about the bytes: every global access is
// a 16-byte vector, and each thread issues its share of a page's K and V
// loads (up to 4 + 4 vectors) before storing any, so one page costs about
// one memory latency, not one per element.  What it does not do yet: fp32
// dots are scalar from shared memory, pages are not prefetched while the
// previous one computes, and one block per (b, h, tile) means gemma-2b
// decode (MQA, S*G = 8 rows) fills only B blocks of 132 SMs.  Split-K over
// pages, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

size_t smem_bytes(int D, int BS) {
  const int DP = D + 1;
  return sizeof(float) *
         (size_t)(kRows * DP + 2 * BS * DP + kRows * BS + 4 * kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_update_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, T* k_pool, T* v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions, T* __restrict__ out,
                    int S, int H, int Hkv, int BS, int MB, int nb_live,
                    int window, float scale, float softcap) {
  constexpr int DP = D + 1;          // padded row stride: conflict-free QK^T
  constexpr int kAcc = kRows * D / kThreads;
  constexpr int VN = Vec<T>::N;      // elements per 16-byte vector
  constexpr int DV = D / VN;         // vectors per head row
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

  // 1. Scatter every fresh row of (b, h) -- all S of them, in every tile.
  for (int idx = tid; idx < S * DV; idx += kThreads) {
    const int s = idx / DV, d = (idx % DV) * VN;
    const int p = pos_b[s];
    if (p >= 0) {
      const size_t dst = (size_t)tab_b[p / BS] * page_stride +
                         (size_t)(p % BS) * row_stride + (size_t)h * D + d;
      const size_t src = (((size_t)b * S + s) * Hkv + h) * D + d;
      st16(k_pool + dst, ld16(k_new + src));
      st16(v_pool + dst, ld16(v_new + src));
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
  for (int idx = tid; idx < kRows * DV; idx += kThreads) {
    const int r = idx / DV, d = (idx % DV) * VN;
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
          unpack(k_s + c * DP + d, kr[u], 1.f, k_pool);
          unpack(v_s + c * DP + d, vr[u], 1.f, v_pool);
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
        pr[c] = to_f32(from_f32<T>(e));   // p in the pool dtype for PV
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, const void* tables,
                   const void* positions, void* out, int B, int S, int H,
                   int Hkv, int BS, int MB, int nb_live, int window,
                   float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, BS);
  static size_t smem_set = 48 * 1024;   // per instantiation: the default cap
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_update_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((S * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
  paged_update_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), S, H, Hkv,
      BS, MB, nb_live, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_new,
                     const void* v_new, void* k_pool, void* v_pool,
                     const void* tables, const void* positions, void* out,
                     int B, int S, int H, int Hkv, int BS, int MB,
                     int nb_live, int window, float scale, float softcap,
                     cudaStream_t stream) {
#define PA_LAUNCH(DIM)                                                      \
  return launch<T, DIM>(q, k_new, v_new, k_pool, v_pool, tables, positions, \
                        out, B, S, H, Hkv, BS, MB, nb_live, window, scale,  \
                        softcap, stream)
  switch (D) {
    case 16: PA_LAUNCH(16);
    case 64: PA_LAUNCH(64);
    case 256: PA_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int paged_attention_update(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* tables, const void* positions, void* out,
    int B, int S, int H, int Hkv, int D, int BS, int MB, int nb_live,
    int window, float scale, float softcap, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k_new, v_new, k_pool, v_pool, tables,
                                positions, out, B, S, H, Hkv, BS, MB,
                                nb_live, window, scale, softcap, st);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k_new, v_new, k_pool, v_pool,
                                        tables, positions, out, B, S, H, Hkv,
                                        BS, MB, nb_live, window, scale,
                                        softcap, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
