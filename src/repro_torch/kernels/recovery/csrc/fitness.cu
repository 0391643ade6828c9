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
//
// The narrow kernel, for P <= kNarrowP (the GA's polish calls at P 4).
// There the wide tile computes 64 individuals for 4, and the call is bound
// by bytes: 64 MiB of IL, 0.02 ms.  fitness_narrow_kernel streams IL once
// over all SMs: a block owns kNE events and brings chunks of kNK
// region-perils of IL and w into shared memory with 16-byte cp.async
// (4-byte where m is not a multiple of 4) kNStages deep; a thread per
// (event, individual) runs its dot product as one fp32 FMA chain, the P
// threads of an event reading its IL row as one broadcast.  It gives each row
// p the same sq[p], bit for bit, as the wide kernel, which the GA needs
// (the polish's values are compared with the population's) and which
// test_cuda_fitness_deterministic_and_row_local checks:
//   1. each dot is one fmaf chain over k = 0 .. m-1 from +0 (zero padding
//      past m leaves the sq unchanged);
//   2. per 128-event tile, each run of 8 consecutive events adds
//      fmaf(d, d, part) in event order from 0, skipping events past E;
//   3. the 16 runs of a tile are added in order from 0;
//   4. the tiles are added in order from 0.
// The narrow kernel does 1 and 2 (a thread sums a run's 8 errors, staged in
// shared memory) and writes each run's sum to runs[E / 8, P];
// fitness_runs_reduce does 3 and 4.  No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kNarrowP = 8;                         // the narrow kernel's P
constexpr int kNE = 64;                             // narrow: events a block
constexpr int kNK = 128;                            // narrow: m per stage
constexpr int kNStages = 3;                         // narrow: cp.async depth
constexpr int kNStride = kNK + 4;                   // rows: 16-byte aligned,
                                                    // 4 banks apart
constexpr int kRunsPerTile = kBE / kTM;             // 16

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


__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

size_t narrow_smem_bytes(int P) {
  return sizeof(float) * (size_t)kNStages * (kNE + P) * kNStride;
}

// runs[g * P + p] = the sum over run g (events 8 g .. 8 g + 7 below E) of
// the squared error of individual p, in the wide kernel's order.  A block
// of kNE * P threads: thread (e, p) = (tid / P, tid % P) runs one dot
// product, so an SM holds P times the warps a thread per event would give
// it (the chains are latency-bound: each is one FMA after another).
// kVec16: m % 4 == 0 and IL, w 16-byte aligned.
template <int P, bool kVec16>
__global__ void __launch_bounds__(kNE * kNarrowP)
fitness_narrow_kernel(const float* __restrict__ il,
                      const float* __restrict__ w,
                      const float* __restrict__ target, float att,
                      float limit, int E, int m, float* __restrict__ runs) {
  constexpr int kT = kNE * P;                       // threads
  extern __shared__ __align__(16) float nsm[];
  float* il_s = nsm;                                // [stage][kNE][kNStride]
  float* w_s = nsm + kNStages * kNE * kNStride;     // [stage][P][kNStride]
  __shared__ float d_s[kNE * kNarrowP];             // the epilogue's errors
  const int tid = threadIdx.x, el = tid / P, p = tid % P;
  const int e0 = blockIdx.x * kNE;
  const int nk = (m + kNK - 1) / kNK;

  // chunk kc of IL rows e0 .. e0 + kNE - 1 and of w into stage st; past E
  // or m the copies read nothing and write zeros
  auto issue = [&](int kc, int st) {
    const int k0 = kc * kNK;
    float* is = il_s + st * kNE * kNStride;
    float* ws = w_s + st * P * kNStride;
    if constexpr (kVec16) {
      for (int i = tid; i < kNE * (kNK / 4); i += kT) {
        const int r = i / (kNK / 4), c = (i % (kNK / 4)) * 4;
        const bool in = e0 + r < E && k0 + c < m;
        cp_async16(is + r * kNStride + c,
                   in ? il + (size_t)(e0 + r) * m + k0 + c : il, in ? 16 : 0);
      }
      for (int i = tid; i < P * (kNK / 4); i += kT) {
        const int q = i / (kNK / 4), c = (i % (kNK / 4)) * 4;
        const bool in = k0 + c < m;
        cp_async16(ws + q * kNStride + c,
                   in ? w + (size_t)q * m + k0 + c : w, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kNE * kNK; i += kT) {
        const int r = i / kNK, c = i % kNK;
        const bool in = e0 + r < E && k0 + c < m;
        cp_async4(is + r * kNStride + c,
                  in ? il + (size_t)(e0 + r) * m + k0 + c : il, in ? 4 : 0);
      }
      for (int i = tid; i < P * kNK; i += kT) {
        const int q = i / kNK, c = i % kNK;
        const bool in = k0 + c < m;
        cp_async4(ws + q * kNStride + c,
                  in ? w + (size_t)q * m + k0 + c : w, in ? 4 : 0);
      }
    }
  };

  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kNStages - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kNStages - 2>();
    __syncthreads();   // chunk kc landed; chunk kc - 1's stage is free
    if (kc + kNStages - 1 < nk)
      issue(kc + kNStages - 1, (kc + kNStages - 1) % kNStages);
    cp_commit();
    const int st = kc % kNStages;
    const float* row = il_s + st * kNE * kNStride + el * kNStride;
    const float* wr = w_s + st * P * kNStride + p * kNStride;
#pragma unroll 8
    for (int k = 0; k < kNK; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + k);
      const float4 b = *reinterpret_cast<const float4*>(wr + k);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  }

  // the wide kernel's epilogue: each error, then each run of 8 events
  // summed in event order by one thread
  const int e = e0 + el;
  const float x = acc - att;
  const float rec = x < 0.f ? 0.f : (x > limit ? limit : x);
  d_s[tid] = rec - (e < E ? target[e] : 0.f);
  __syncthreads();
  if (tid < (kNE / kTM) * P) {
    const int run = tid / P, q = tid % P;
    const int re = e0 + run * kTM;
    if (re < E) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        if (re + i < E) {
          const float d = d_s[(run * kTM + i) * P + q];
          part = fmaf(d, d, part);
        }
      }
      runs[(size_t)(re / kTM) * P + q] = part;
    }
  }
}

// sq[p] = sum over tiles t in order of (sum over the tile's 16 runs in
// order of runs[g, p], 0 past the last run): the wide kernel's steps 3 and
// 4.  One block per individual.
__global__ void __launch_bounds__(kReduceThreads)
fitness_runs_reduce(const float* __restrict__ runs, int n_runs, int n_tiles,
                    int P, float* __restrict__ out) {
  __shared__ float tile_s[kReduceThreads];
  const int p = blockIdx.x, tid = threadIdx.x;
  float total = 0.f;
  for (int t0 = 0; t0 < n_tiles; t0 += kReduceThreads) {
    const int t = t0 + tid;
    if (t < n_tiles) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kRunsPerTile; ++r) {
        const int g = t * kRunsPerTile + r;
        s += g < n_runs ? runs[(size_t)g * P + p] : 0.f;
      }
      tile_s[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      const int n = min(kReduceThreads, n_tiles - t0);
      for (int i = 0; i < n; ++i) total += tile_s[i];
    }
    __syncthreads();
  }
  if (tid == 0) out[p] = total;
}

template <int P>
cudaError_t launch_narrow(const float* il, const float* w,
                          const float* target, float att, float limit, int E,
                          int m, int vec16, float* runs, float* out,
                          cudaStream_t s) {
  const size_t smem = narrow_smem_bytes(P);
  static bool smem_set = false;   // per instantiation
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fitness_narrow_kernel<P, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fitness_narrow_kernel<P, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int blocks = (E + kNE - 1) / kNE;
  if (vec16)
    fitness_narrow_kernel<P, true><<<blocks, kNE * P, smem, s>>>(
        il, w, target, att, limit, E, m, runs);
  else
    fitness_narrow_kernel<P, false><<<blocks, kNE * P, smem, s>>>(
        il, w, target, att, limit, E, m, runs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_runs = (E + kTM - 1) / kTM, n_tiles = (E + kBE - 1) / kBE;
  fitness_runs_reduce<<<P, kReduceThreads, 0, s>>>(runs, n_runs, n_tiles, P,
                                                  out);
  return cudaGetLastError();
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

// The narrow kernel, for 1 <= P <= fitness_narrow_max_p().  Scratch
// ``runs`` holds ceil(E / fitness_run_events()) x P floats; vec16: m % 4 ==
// 0 and il, w start on 16-byte boundaries.  Returns the CUDA error of the
// launches (0 when both were accepted).
int fitness_sq_narrow(const float* il, const float* w, const float* target,
                      float att, float limit, int E, int m, int P, int vec16,
                      float* runs, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
#define FIT_NARROW(N)                                                    \
  case N:                                                                \
    return static_cast<int>(launch_narrow<N>(il, w, target, att, limit, E, \
                                             m, vec16, runs, out, s));
    FIT_NARROW(1) FIT_NARROW(2) FIT_NARROW(3) FIT_NARROW(4)
    FIT_NARROW(5) FIT_NARROW(6) FIT_NARROW(7) FIT_NARROW(8)
#undef FIT_NARROW
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int fitness_narrow_max_p() { return kNarrowP; }

int fitness_run_events() { return kTM; }

const char* fitness_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
