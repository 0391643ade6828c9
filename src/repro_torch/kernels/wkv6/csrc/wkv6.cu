// RWKV-6 recurrence: the Hopper port of
// repro/kernels/wkv6/kernel.py::wkv_pallas (body _wkv_kernel).
//
// What it computes, for every (batch row b, head h), from S = 0:
//
//   out_t = r_t . S + (r_t . (u * k_t)) v_t        (S before the update)
//   S    <- diag(w_t) S + k_t v_t^T
//
// with S a D x D fp32 state, in fp32 whatever the inputs' type, and out_t
// written in r's type.  No final state leaves the kernel and there is no
// gradient, as in the TPU kernel.
//
// Design.  The TPU kernel keeps S in VMEM and walks the tokens in chunks
// over a sequential grid axis.  Here nothing carries between blocks, and
// one (b, h) alone is far too little work for an SM (rwkv6-1.6b prefills
// at B 1 x H 32), so each head's state is split:
//
//   * Column j of S evolves on its own,
//       S[:, j] <- w * S[:, j] + k v_j,   out_j = sum_i r_i S[i, j] + bonus v_j,
//     so a block owns kC = 16 columns of one (b, h) (D / 16 blocks a head:
//     128 blocks of 4 warps for rwkv6-1.6b at B 1 x H 32 x D 64).  A lane
//     keeps 4 rows (8 at D 128) of 2 columns in registers from the first
//     token to the last, so each r, k, w it reads serves two columns; the
//     kR = D / 4 lanes of a column pair are neighbours in one warp (lane g
//     takes rows 4 g .. 4 g + 3, so they read r, k, w as consecutive
//     16-byte vectors).
//   * The only dependence from token to token is the update, one FMA per
//     element.  The dot r . S does not feed back, so a lane runs kR tokens'
//     updates and partial dots one after another, unrolled, and the kR
//     lanes then add each column's kR partials in one reduce-scatter over
//     shuffles (kR - 1 exchanges; lane g ends with token g's dot).
//   * The bonus r . (u * k) needs no state: it is computed once per token,
//     for the whole staged chunk, while the chunk's r and k are turned into
//     fp32 (a thread per 16 bytes of a token's r and k, a butterfly over the
//     lanes of the token), before the walk.
//   * A chunk of kT tokens of r, k (all D rows) and v (the block's 16
//     columns) comes in by 16-byte cp.async copies into one of two raw
//     buffers while the block walks the chunk before it, and is turned into
//     fp32 once for all the block's lanes; an fp32 w is copied straight
//     into one of two fp32 buffers (a bf16 w goes the raw way).  The block
//     takes 108.5 KiB of shared memory at D 64, so two fit on an SM.  The
//     outputs of a chunk are staged in shared memory and written as
//     16-byte rows.
//   * Inputs are read by stride from the model's (B, S, H, D) layout, each
//     tensor with its own strides and the last axis contiguous, so no
//     transposed copy is made; the wrapper passes tensors whose rows start
//     on 16-byte boundaries.  r, k, v are fp32 or bf16 (one type), w fp32
//     or bf16: the model's decay is fp32 beside bf16 r, k, v.
//   * No atomics, no order that depends on timing: the output is the same,
//     bit for bit, from one call to the next.  Tokens past S in the last
//     chunk are zero-filled; they only change the state after the last
//     token, which no one reads, and their outputs are not written.
//
// Bound on an H100: about 5 D^2 fp32 operations per token and head (the
// dot product and the update), against 2 or 4 bytes per element of r, k, v,
// w and out: 160 to 320 operations a byte at D 64, above fp32's ridge of
// 67e12 / 3.35e12 = 20, so operations bound it.  Per token a lane issues 3
// LDS.128 and an LDS.64, 24 FMA/FMUL for its 8 elements and about 8
// instructions of the two reduce-scatters: about 4.5 instructions per
// state element and token, against the bound's 2.5 FMA-issue slots, with
// one warp for each of an SM's four schedulers at B 1: the walk is bound
// by latency there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Layout {                       // element strides of r, k, v, w
  long long b[4], s[4], h[4];
};

template <int D>
struct Tile {
  static constexpr int kRows = D >= 128 ? 8 : 4;        // state rows a lane
  static constexpr int kCols = 2;                       // columns a lane
  static constexpr int kR = D / kRows;                  // lanes a column
  static constexpr int kC = 16;                         // columns a block
  static constexpr int kThreads = kR * kC / kCols;
  static constexpr int kT = D >= 128 ? 32 : 64;         // tokens a chunk
  static_assert(kRows % 4 == 0 && kR >= 2 && kR <= 16, "lanes a column");
  static_assert(kThreads % 32 == 0 && kT % kR == 0 && kC % 8 == 0 &&
                kC % kCols == 0, "block shape");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// 16 bytes of fp32 or bf16 at src (shared) as fp32 values
__device__ __forceinline__ void widen16(const float* src, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  x[0] = bf16_lo(a.x); x[1] = bf16_hi(a.x); x[2] = bf16_lo(a.y);
  x[3] = bf16_hi(a.y); x[4] = bf16_lo(a.z); x[5] = bf16_hi(a.z);
  x[6] = bf16_lo(a.w); x[7] = bf16_hi(a.w);
}
template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

// 8 fp32 outputs at src (shared) to dst (global) in T
__device__ __forceinline__ void narrow8(const float* src, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void narrow8(const float* src,
                                        __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(src[0], src[1]), pack_bf16(src[2], src[3]),
                 pack_bf16(src[4], src[5]), pack_bf16(src[6], src[7]));
}

// kT rows of kElems values of X from token t0 (row t at src + t *
// s_stride) into dst (kT x kElems, shared) by 16-byte copies; tokens past
// S read nothing and write zeros
template <int kElems, int kT, int kNT, typename X>
__device__ __forceinline__ void copy_rows(X* dst, const X* src,
                                          long long s_stride, int t0, int S,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(X), kCpr = kElems / kPer;
  constexpr int kN = kT * kCpr;
#pragma unroll
  for (int j = 0; j < (kN + kNT - 1) / kNT; ++j) {
    const int i = tid + j * kNT;
    if (kN % kNT == 0 || i < kN) {
      const int tok = i / kCpr, part = i % kCpr;
      const bool in = t0 + tok < S;
      cp_async16(dst + tok * kElems + part * kPer,
                 in ? src + (t0 + tok) * s_stride + part * kPer : src,
                 in ? 16 : 0);
    }
  }
}

// n values of X (raw, shared) to fp32 (shared), 16 bytes a step
template <int kN, int kNT, typename X>
__device__ __forceinline__ void widen_all(float* dst, const X* src,
                                          int tid) {
  constexpr int kPer = 16 / sizeof(X);
#pragma unroll
  for (int j = 0; j < (kN / kPer + kNT - 1) / kNT; ++j) {
    const int i = tid + j * kNT;
    if ((kN / kPer) % kNT == 0 || i < kN / kPer) {
      float x[kPer];
      widen16(src + i * kPer, x);
      store_f32<kPer>(dst + i * kPer, x);
    }
  }
}

// Reduce-scatter of the kR partial dots p[0 .. kR-1] (token q's partial in
// p[q]) over the kR lanes of a column, lane g = lane % kR: halving steps of
// kS exchanges, lanes with bit kS of g keeping the upper half.  Lane g ends
// with token g's full dot in p[0].
template <int kS, int kR>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float (&p)[kR], int g) {
    const bool upper = (g & kS) != 0;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float send = upper ? p[i] : p[i + kS];
      const float keep = upper ? p[i + kS] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, kS);
    }
    ReduceScatter<kS / 2, kR>::run(p, g);
  }
};
template <int kR>
struct ReduceScatter<0, kR> {
  static __device__ __forceinline__ void run(float (&)[kR], int) {}
};

// The block's shared memory: two raw buffers, each [r kT x D][k kT x D]
// [v kT x kC] in TI and, for bf16 w, [w kT x D]; then fp32 r, k, w (two
// buffers of w when it is fp32: the copies land there directly), v, the
// staged outputs, the bonus and u.
template <typename TI, typename TW, int D>
struct Smem {
  using Tl = Tile<D>;
  static constexpr bool kWDirect = std::is_same<TW, float>::value;
  static constexpr size_t kRaw = (size_t)Tl::kT *
      ((2 * D + Tl::kC) * sizeof(TI) + (kWDirect ? 0 : D * sizeof(TW)));
  static constexpr size_t kF32 = sizeof(float) *
      ((size_t)Tl::kT * ((kWDirect ? 4 : 3) * D + 2 * Tl::kC) + Tl::kT + D);
  static constexpr size_t kBytes = 2 * kRaw + kF32;
};

template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
wkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
            const TI* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, TI* __restrict__ out, int S, int H,
            Layout lay) {
  using Tl = Tile<D>;
  constexpr int R = Tl::kR, C = Tl::kC, T = Tl::kT, NT = Tl::kThreads;
  constexpr int RW = Tl::kRows;                 // state rows a lane
  constexpr int CW = Tl::kCols;                 // state columns a lane
  constexpr int NCB = D / C;                    // column blocks a head
  constexpr int VI = 16 / sizeof(TI);           // r, k values a 16-byte step
  constexpr int PT = D / VI;                    // such steps a token
  static_assert(PT <= 32 && NT % PT == 0 && (T * PT) % NT == 0,
                "a token's steps in one warp, every lane busy");
  using Sm = Smem<TI, TW, D>;
  constexpr bool kWDirect = Sm::kWDirect;
  extern __shared__ __align__(16) unsigned char wsm[];
  float* rs = reinterpret_cast<float*>(wsm + 2 * Sm::kRaw);    // [T][D]
  float* ks = rs + T * D;                                      // [T][D]
  float* ws = ks + T * D;                          // [1 or 2][T][D]
  float* vs = ws + (kWDirect ? 2 : 1) * T * D;                 // [T][C]
  float* os = vs + T * C;                                      // [T][C]
  float* bonus_s = os + T * C;                                 // [T]
  float* us = bonus_s + T;                                     // [D]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / NCB, cb = blockIdx.x % NCB;
  const int b = bh / H, h = bh % H, c0 = cb * C;
  const TI* rp = r + b * lay.b[0] + h * lay.h[0];
  const TI* kp = k + b * lay.b[1] + h * lay.h[1];
  const TI* vp = v + b * lay.b[2] + h * lay.h[2] + c0;
  const TW* wp = w + b * lay.b[3] + h * lay.h[3];
  TI* op = out + ((long long)b * S * H + h) * D + c0;
  const long long o_step = (long long)H * D;
  for (int i = tid; i < D; i += NT) us[i] = u[h * D + i];

  auto r_raw = [&](int buf) {
    return reinterpret_cast<TI*>(wsm + buf * Sm::kRaw);
  };
  auto w_raw = [&](int buf) {            // bf16 w: after r, k and v
    return reinterpret_cast<TW*>(r_raw(buf) + (2 * D + C) * T);
  };
  auto issue = [&](int chunk, int buf) {  // r, k, v and a bf16 w
    const int t0 = chunk * T;
    TI* rr = r_raw(buf);
    copy_rows<D, T, NT>(rr, rp, lay.s[0], t0, S, tid);
    copy_rows<D, T, NT>(rr + T * D, kp, lay.s[1], t0, S, tid);
    copy_rows<C, T, NT>(rr + 2 * T * D, vp, lay.s[2], t0, S, tid);
    if constexpr (!kWDirect)
      copy_rows<D, T, NT>(w_raw(buf), wp, lay.s[3], t0, S, tid);
  };
  auto issue_w = [&](int chunk) {         // an fp32 w, into its buffer
    copy_rows<D, T, NT>(reinterpret_cast<TW*>(ws + (chunk & 1) * T * D), wp,
                        lay.s[3], chunk * T, S, tid);
  };
  auto write_out = [&](int chunk) {       // os -> out, 8 columns a thread
    const int t0 = chunk * T;
    for (int i = tid; i < T * (C / 8); i += NT) {
      const int tok = i / (C / 8), part = i % (C / 8);
      if (t0 + tok < S)
        narrow8(os + tok * C + part * 8, op + (t0 + tok) * o_step + part * 8);
    }
  };

  // the lane's rows: float4 slots g + R * j (j < RW / 4) of a token's D
  // values, each 4 rows of columns col .. col + CW - 1
  const int col = (tid / R) * CW, g = tid % R;
  float st[CW][RW];
#pragma unroll
  for (int x = 0; x < CW; ++x)
#pragma unroll
    for (int i = 0; i < RW; ++i) st[x][i] = 0.f;

  // Copy groups, in commit order: {chunk 0, w of chunk 0}, {chunk 1},
  // then in each step c: {w of chunk c + 1} (fp32 w: its buffer is free
  // once the walk of chunk c - 1 is done) and {chunk c + 2}.  At the top of
  // step c only the last group, chunk c + 1, may still be in flight.
  const int n_chunks = (S + T - 1) / T;
  issue(0, 0);
  if constexpr (kWDirect) issue_w(0);
  cp_commit();
  if (n_chunks > 1) issue(1, 1);
  cp_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<1>();
    __syncthreads();        // chunk c landed; the walk of chunk c - 1 is done
    if constexpr (kWDirect) {
      if (c + 1 < n_chunks) issue_w(c + 1);
      cp_commit();
    }
    if (c > 0) write_out(c - 1);
    {
      // r and k to fp32, and the bonus r . (u * k) of every token: a
      // thread takes VI rows of one token, the PT lanes of a token add
      // their partial sums by a butterfly
      const TI* r_in = r_raw(c & 1);
      const TI* k_in = r_in + T * D;
      const int part = tid % PT;          // the same on every step
#pragma unroll
      for (int j = 0; j < T * PT / NT; ++j) {
        const int i = tid + j * NT;       // token i / PT, rows part * VI ..
        float xr[VI], xk[VI];
        widen16(r_in + i * VI, xr);
        widen16(k_in + i * VI, xk);
        store_f32<VI>(rs + i * VI, xr);
        store_f32<VI>(ks + i * VI, xk);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VI; ++e)
          s = fmaf(xr[e], us[part * VI + e] * xk[e], s);
#pragma unroll
        for (int o = PT / 2; o >= 1; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (part == 0) bonus_s[i / PT] = s;
      }
      widen_all<T * C, NT>(vs, k_in + T * D, tid);
      if constexpr (!kWDirect) widen_all<T * D, NT>(ws, w_raw(c & 1), tid);
    }
    __syncthreads();        // fp32 chunk and bonus ready; raw buffer free
    if (c + 2 < n_chunks) issue(c + 2, c & 1);
    cp_commit();
    // the walk: R tokens at a time, then one reduce-scatter
    const float* wc = ws + (kWDirect ? (c & 1) * T * D : 0);
    for (int tg = 0; tg < T; tg += R) {
      float p[CW][R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = tg + q;
        const float4* r4 = reinterpret_cast<const float4*>(rs + t * D);
        const float4* k4 = reinterpret_cast<const float4*>(ks + t * D);
        const float4* w4 = reinterpret_cast<const float4*>(wc + t * D);
        float rr[RW], kk[RW], ww[RW];
#pragma unroll
        for (int j = 0; j < RW / 4; ++j) {
          const float4 a = r4[g + R * j], bk = k4[g + R * j],
                       bw = w4[g + R * j];
          rr[4 * j] = a.x; rr[4 * j + 1] = a.y;
          rr[4 * j + 2] = a.z; rr[4 * j + 3] = a.w;
          kk[4 * j] = bk.x; kk[4 * j + 1] = bk.y;
          kk[4 * j + 2] = bk.z; kk[4 * j + 3] = bk.w;
          ww[4 * j] = bw.x; ww[4 * j + 1] = bw.y;
          ww[4 * j + 2] = bw.z; ww[4 * j + 3] = bw.w;
        }
#pragma unroll
        for (int x = 0; x < CW; ++x) {           // the lane's columns
          const float vj = vs[t * C + col + x];
          float dot = 0.f;                        // on S before the update
#pragma unroll
          for (int i = 0; i < RW; ++i) dot = fmaf(rr[i], st[x][i], dot);
#pragma unroll
          for (int i = 0; i < RW; ++i)
            st[x][i] = fmaf(ww[i], st[x][i], kk[i] * vj);
          p[x][q] = dot;
        }
      }
      const int t = tg + g;
#pragma unroll
      for (int x = 0; x < CW; ++x) {
        ReduceScatter<R / 2, R>::run(p[x], g);
        os[t * C + col + x] = fmaf(bonus_s[t], vs[t * C + col + x], p[x][0]);
      }
    }
  }
  __syncthreads();
  write_out(n_chunks - 1);
}

template <typename TI, typename TW, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, int B, int S,
                   int H, const Layout& lay, cudaStream_t stream) {
  using Tl = Tile<D>;
  constexpr size_t smem = Smem<TI, TW, D>::kBytes;
  static_assert(smem <= 232448, "more shared memory than a block has");
  static bool smem_set = false;   // per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<TI, TW, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  wkv6_kernel<TI, TW, D><<<B * H * (D / Tl::kC), Tl::kThreads, smem,
                           stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<TI*>(out), S, H, lay);
  return cudaGetLastError();
}

template <typename TI, typename TW>
cudaError_t launch_d(int D, const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* out, int B, int S,
                     int H, const Layout& lay, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TI, TW, 16>(r, k, v, w, u, out, B, S, H, lay, stream);
    case 32: return launch<TI, TW, 32>(r, k, v, w, u, out, B, S, H, lay, stream);
    case 64: return launch<TI, TW, 64>(r, k, v, w, u, out, B, S, H, lay, stream);
    case 128: return launch<TI, TW, 128>(r, k, v, w, u, out, B, S, H, lay, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, s,
// h) of r, k, v and w in that order; every row (one token of one head)
// must start on a 16-byte boundary.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a head dim or dtype it is not built
// for).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* out, int B,
                           int S, int H, int D, int in_dtype, int w_dtype,
                           const long long* strides, void* stream) {
  Layout lay;
  for (int i = 0; i < 4; ++i) {
    lay.b[i] = strides[3 * i];
    lay.s[i] = strides[3 * i + 1];
    lay.h[i] = strides[3 * i + 2];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && w_dtype == 0)
    return launch_d<float, float>(D, r, k, v, w, u, out, B, S, H, lay, st);
  if (in_dtype == 1 && w_dtype == 0)
    return launch_d<__nv_bfloat16, float>(D, r, k, v, w, u, out, B, S, H,
                                          lay, st);
  if (in_dtype == 0 && w_dtype == 1)
    return launch_d<float, __nv_bfloat16>(D, r, k, v, w, u, out, B, S, H,
                                          lay, st);
  if (in_dtype == 1 && w_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, r, k, v, w, u, out, B,
                                                  S, H, lay, st);
  return cudaErrorInvalidValue;
}

// The block for head dim D: the columns of one head's state it owns and
// its threads.  Returns 0, or -1 for a head dim the kernel is not built
// for.  A call launches B * H * D / columns blocks.
extern "C" int wkv6_block_shape(int D, int* columns, int* threads) {
  switch (D) {
#define WKV_SHAPE(N)                                   \
  case N:                                              \
    *columns = Tile<N>::kC;                            \
    *threads = Tile<N>::kThreads;                      \
    return 0;
    WKV_SHAPE(16) WKV_SHAPE(32) WKV_SHAPE(64) WKV_SHAPE(128)
#undef WKV_SHAPE
    default:
      return -1;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
