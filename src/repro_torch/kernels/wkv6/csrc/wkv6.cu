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
// over a sequential grid axis.  Here nothing carries between blocks, so one
// block owns one (b, h) and walks every token itself.  Column j of S evolves
// on its own,
//
//   S[:, j] <- w * S[:, j] + k v_j,     out_j = sum_i r_i S[i, j] + bonus v_j,
//
// so thread j of the block's D threads keeps column j in D registers for
// the whole sequence: the state never touches memory.  The block stages a
// chunk of kStage / D tokens' r, k, v and w in shared memory as fp32 (one
// coalesced row of D values per token and tensor), then steps through the
// chunk one token at a time; every thread reads r, k, w and u of the token
// as broadcast 16-byte loads and does its D steps of the dot product (four
// partial sums), the bonus dot r . (u * k) (the same in every thread) and
// the column update.  Inputs are read by stride from the model's (B, S, H, D)
// layout, each tensor with its own strides and the last axis contiguous, so
// no transposed copy is made.  r, k, v are fp32 or bf16 (one type), w fp32
// or bf16: the model's decay is fp32 beside bf16 r, k, v.
//
// Bound on an H100: about 5 D^2 fp32 operations per token and head (the
// dot product and the update), against 2 or 4 bytes per element of r, k, v,
// w and out: 160 to 320 operations a byte at D 64, above fp32's ridge of
// 67e12 / 3.35e12 = 20, so operations bound it.  This version is simple,
// not fast: B * H blocks of D threads (32 blocks for 132 SMs at B 1 and
// rwkv6-1.6b's 32 heads), each walking S tokens in order, scalar FMA with
// one chain of dependent sums per token.  Splitting the columns over more
// blocks, or the chunked-parallel form on the tensor cores, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStage = 2048;          // fp32 values per staged tensor

struct Layout {                       // element strides of r, k, v, w
  long long b[4], s[4], h[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TI, typename TW, int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
            const TI* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, TI* __restrict__ out, int S, int H,
            Layout lay) {
  constexpr int T = kStage / D;       // tokens per staged chunk
  __shared__ __align__(16) float sr[T * D];
  __shared__ __align__(16) float sk[T * D];
  __shared__ __align__(16) float sv[T * D];
  __shared__ __align__(16) float sw[T * D];
  __shared__ __align__(16) float su[D];

  const int b = blockIdx.x / H, h = blockIdx.x % H, j = threadIdx.x;
  const TI* rp = r + b * lay.b[0] + h * lay.h[0] + j;
  const TI* kp = k + b * lay.b[1] + h * lay.h[1] + j;
  const TI* vp = v + b * lay.b[2] + h * lay.h[2] + j;
  const TW* wp = w + b * lay.b[3] + h * lay.h[3] + j;
  TI* op = out + ((long long)b * S * H + h) * D + j;
  const long long o_step = (long long)H * D;
  su[j] = u[h * D + j];

  float col[D];                       // col[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < D; ++i) col[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();                  // the last chunk's reads are done
    for (int c = 0; c < n; ++c) {
      const long long t = t0 + c;
      sr[c * D + j] = to_f32(rp[t * lay.s[0]]);
      sk[c * D + j] = to_f32(kp[t * lay.s[1]]);
      sv[c * D + j] = to_f32(vp[t * lay.s[2]]);
      sw[c * D + j] = to_f32(wp[t * lay.s[3]]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float4* r4 = reinterpret_cast<const float4*>(sr + c * D);
      const float4* k4 = reinterpret_cast<const float4*>(sk + c * D);
      const float4* w4 = reinterpret_cast<const float4*>(sw + c * D);
      const float4* u4 = reinterpret_cast<const float4*>(su);
      const float vj = sv[c * D + j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, bonus = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        a0 = fmaf(rq.x, col[4 * q + 0], a0);
        a1 = fmaf(rq.y, col[4 * q + 1], a1);
        a2 = fmaf(rq.z, col[4 * q + 2], a2);
        a3 = fmaf(rq.w, col[4 * q + 3], a3);
        bonus = fmaf(rq.x, uq.x * kq.x, bonus);
        bonus = fmaf(rq.y, uq.y * kq.y, bonus);
        bonus = fmaf(rq.z, uq.z * kq.z, bonus);
        bonus = fmaf(rq.w, uq.w * kq.w, bonus);
        col[4 * q + 0] = fmaf(col[4 * q + 0], wq.x, kq.x * vj);
        col[4 * q + 1] = fmaf(col[4 * q + 1], wq.y, kq.y * vj);
        col[4 * q + 2] = fmaf(col[4 * q + 2], wq.z, kq.z * vj);
        col[4 * q + 3] = fmaf(col[4 * q + 3], wq.w, kq.w * vj);
      }
      store(op + (t0 + c) * o_step, ((a0 + a1) + (a2 + a3)) + bonus * vj);
    }
  }
}

template <typename TI, typename TW, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, int B, int S,
                   int H, const Layout& lay, cudaStream_t stream) {
  wkv6_kernel<TI, TW, D><<<B * H, D, 0, stream>>>(
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
// h) of r, k, v and w in that order.  Returns cudaGetLastError() after the
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

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
