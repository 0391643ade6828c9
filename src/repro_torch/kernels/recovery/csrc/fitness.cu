// CATopt fitness for a population: the Hopper port of
// repro/kernels/recovery/kernel.py::fitness_sq_pallas (body _fitness_kernel).
//
// What it computes, for individuals p of w (P, m) against the industry-loss
// matrix IL (E, m) and the target recovery (E,):
//
//   sq[p] = sum_e (clip(IL[e,:] . w[p,:] - att, 0, limit) - target[e])^2
//
// a matrix product (E x m) . (m x P) whose (E, P) result never reaches device
// memory: the clip, the error and its square stay in registers and only the
// sum over events leaves the block.
//
// Design for a CUDA grid (the TPU kernel accumulates sq across a sequential
// grid axis over E; here blocks run in parallel and in no order):
//   * grid (ceil(E / kBE), ceil(P / kBP)); a block owns kBE events x kBP
//     individuals and loops over m in chunks of kBK, staging both tiles in
//     shared memory (transposed, so a thread reads its 8 events and its 4
//     individuals of one k as 16-byte vectors).  Each of the 256 threads
//     holds an 8 x 4 tile of dot products in registers, accumulated with
//     fp32 FMA: no TF32, the result is held to fp32 references.
//   * Epilogue per thread: clip, subtract the target, square and add over
//     its 8 events; then the 16 thread rows of a column are added in a fixed
//     order through shared memory and the block writes one partial per
//     individual to partial[e_tile, p].  A second kernel adds the e_tile
//     partials of each individual in order.  No atomics: the GA sorts and
//     compares fitness values (tournaments, elites), so a run must not
//     depend on the order in which atomics land.  Each sq[p] is a function
//     of row p alone, whatever P is or where p sits in its tile.
//   * Edges: loads outside E, m or P read 0 and the epilogue skips events
//     past E, so ragged shapes need no padding and any att (also att < 0,
//     where a zero-padded event would add clip(-att, 0, limit)^2) is right.
//   * The clip is written with comparisons, so a NaN passes through as in
//     jnp.clip and torch.clamp.
//
// Bound on an H100: operations.  At the paper's scale (E 8192, m 2048,
// P 200) the call does 2 E m P = 6.7 GFLOP over 64 MiB of IL: 100 flop per
// byte, above fp32's ridge of 67e12 / 3.35e12 = 20, so 0.10 ms at the card's
// 67 TFLOP/s fp32 peak against 0.02 ms for the bytes.  This version is the
// simple register-tiled SGEMM: scalar global loads, no cp.async or TMA
// pipeline, no tensor cores.  3xTF32 wgmma is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBE = 128;                            // events per block
constexpr int kBP = 64;                             // individuals per block
constexpr int kBK = 16;                             // m per shared chunk
constexpr int kTM = 8;                              // events per thread
constexpr int kTN = 4;                              // individuals per thread
constexpr int kRowsT = kBE / kTM;                   // 16 thread rows
constexpr int kColsT = kBP / kTN;                   // 16 thread columns
constexpr int kThreads = kRowsT * kColsT;           // 256
constexpr int kPad = 4;                             // keeps rows 16-byte aligned
constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kThreads)
fitness_partial_kernel(const float* __restrict__ il,
                       const float* __restrict__ w,
                       const float* __restrict__ target, float att,
                       float limit, int E, int m, int P,
                       float* __restrict__ partial) {
  __shared__ __align__(16) float As[kBK][kBE + kPad];   // As[k][e]
  __shared__ __align__(16) float Bs[kBK][kBP + kPad];   // Bs[k][p]
  __shared__ float red[kRowsT][kBP];

  const int tid = threadIdx.x;
  const int tx = tid % kColsT, ty = tid / kColsT;
  const int e0 = blockIdx.x * kBE, p0 = blockIdx.y * kBP;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBK) {
    // neighbouring threads read neighbouring k of one row
#pragma unroll
    for (int i = 0; i < kBE * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int e = e0 + r, k = k0 + c;
      As[c][r] = (e < E && k < m) ? il[(size_t)e * m + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBP * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int p = p0 + r, k = k0 + c;
      Bs[c][r] = (p < P && k < m) ? w[(size_t)p * m + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) part[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int e = e0 + ty * kTM + i;
    if (e < E) {
      const float t = target[e];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float x = acc[i][j] - att;
        const float rec = x < 0.f ? 0.f : (x > limit ? limit : x);
        const float d = rec - t;
        part[j] = fmaf(d, d, part[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) red[ty][tx * kTN + j] = part[j];
  __syncthreads();
  if (tid < kBP && p0 + tid < P) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsT; ++r) s += red[r][tid];
    partial[(size_t)blockIdx.x * P + p0 + tid] = s;
  }
}

// sq[p] = sum over e tiles of partial[t, p], in tile order.
__global__ void __launch_bounds__(kReduceThreads)
fitness_reduce_kernel(const float* __restrict__ partial, int n_tiles, int P,
                      float* __restrict__ out) {
  const int p = blockIdx.x * kReduceThreads + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * P + p];
  out[p] = s;
}

}  // namespace

extern "C" {

// Scratch ``partial`` holds ceil(E / fitness_block_events()) x P floats.
// Returns the CUDA error of the launches (0 when both were accepted).
int fitness_sq(const float* il, const float* w, const float* target,
               float att, float limit, int E, int m, int P, float* partial,
               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((E + kBE - 1) / kBE, (P + kBP - 1) / kBP);
  fitness_partial_kernel<<<grid, kThreads, 0, s>>>(il, w, target, att, limit,
                                                   E, m, P, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fitness_reduce_kernel<<<(P + kReduceThreads - 1) / kReduceThreads,
                          kReduceThreads, 0, s>>>(partial, grid.x, P, out);
  return static_cast<int>(cudaGetLastError());
}

int fitness_block_events() { return kBE; }

const char* fitness_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
