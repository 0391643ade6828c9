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
//   * grid (ceil(E / kBE), ceil(P / kBP)); a block owns kBE = 128 events x
//     kBP = 112 individuals (two tiles cover the GA's P 200 with 24 columns
//     to spare) and walks m in chunks of kBK = 32, brought into shared
//     memory by 16-byte cp.async copies (4-byte where m is not a multiple
//     of 4 or a base is not 16-byte aligned) kStages = 4 deep, so three
//     chunks are in flight while the FMAs run on the fourth.  The tiles
//     keep global memory's row-major layout (a 16-byte copy is 4 k of one
//     row) with each row's 16-byte chunks permuted by an XOR of the row, so
//     the 16 event rows and 2 individual rows a warp reads at one k land in
//     distinct banks (2 and 1 wavefronts: the least for their bytes).
//   * Each of the 256 threads holds an 8 x 7 tile of dot products (8
//     consecutive events, one run, x 7 individuals) in registers: per 4 k,
//     15 LDS.128 for 224 fp32 FMAs.  8 warps a block, 2 on each of an SM's 4
//     schedulers, and 128 blocks for the paper's E 8192, P 200: one wave on
//     132 SMs.  (A tile of 104 as 13 individuals a thread leaves one warp
//     a scheduler and ran far slower on the card; 8 x 8 at 128, warps of
//     8 x 4 thread tiles, 3 stages or 64 k a stage were no faster.)  fp32
//     FMA, no TF32: the result is held to fp32 references.
//   * Epilogue per thread: clip, subtract the target, square and add over
//     its 8 events; then the 16 thread rows of a column are added in a fixed
//     order through shared memory and the block writes one partial per
//     individual to partial[e_tile, p].  A second kernel adds the e_tile
//     partials of each individual in order.  No atomics: the GA sorts and
//     compares fitness values (tournaments, elites), so a run must not
//     depend on the order in which atomics land.  Each sq[p] is a function
//     of row p alone, whatever P is or where p sits in its tile.
//   * Edges: copies outside E, m or P write 0 and the epilogue skips events
//     past E, so ragged shapes need no padding and any att (also att < 0,
//     where a zero-padded event would add clip(-att, 0, limit)^2) is right.
//   * The clip is written with comparisons, so a NaN passes through as in
//     jnp.clip and torch.clamp.
//
// Bound on an H100: operations.  At the paper's scale (E 8192, m 2048,
// P 200) the call does 2 E m P = 6.7 GFLOP over 64 MiB of IL: 100 flop per
// byte, above fp32's ridge of 67e12 / 3.35e12 = 20, so 0.10 ms at the card's
// 67 TFLOP/s fp32 peak against 0.02 ms for the bytes.  The FMAs stay on the
// SIMT cores in one chain per dot: split-k, TF32 or 3xTF32 would change the
// bits the narrow kernel must reproduce (below).
//
// The narrow kernel, for P <= kNarrowP (the GA's polish calls at P 4).
// There the wide tile computes 112 individuals for 4, and the call is bound
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
constexpr int kBP = 112;                            // individuals per block
constexpr int kBK = 32;                             // m per stage
constexpr int kStages = 4;                          // cp.async depth
constexpr int kTM = 8;                              // events per thread
constexpr int kTN = 7;                              // individuals per thread
constexpr int kRowsT = kBE / kTM;                   // 16 thread rows
constexpr int kColsT = kBP / kTN;                   // 16 thread columns
constexpr int kThreads = kRowsT * kColsT;           // 256
constexpr int kQuads = kBK / 4;                     // 16-byte chunks a row
constexpr int kReduceThreads = 128;
constexpr int kNarrowP = 8;                         // the narrow kernel's P
constexpr int kNE = 64;                             // narrow: events a block
constexpr int kNK = 128;                            // narrow: m per stage
constexpr int kNStages = 3;                         // narrow: cp.async depth
constexpr int kNStride = kNK + 4;                   // rows: 16-byte aligned,
                                                    // 4 banks apart
constexpr int kRunsPerTile = kBE / kTM;             // 16
static_assert((kQuads & (kQuads - 1)) == 0 && kQuads >= 8,
              "the swizzle permutes a power of two of chunks a row");
static_assert(kBE * kQuads % kThreads == 0 && kBE * kBK % kThreads == 0 &&
              kBP * kBK % kThreads == 0, "copies split evenly");

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

// Where element (row, k) of a stage's tile sits: rows of kBK floats, the
// 16-byte chunk k / 4 moved to (k / 4) ^ swz.  Event rows take swz = the
// thread row e / 8, individual rows p (both mod kQuads): see the header
// note.
__device__ __forceinline__ int a_at(int e, int k) {
  return e * kBK + ((((k >> 2) ^ (e >> 3)) & (kQuads - 1)) << 2) + (k & 3);
}
__device__ __forceinline__ int b_at(int p, int k) {
  return p * kBK + ((((k >> 2) ^ p) & (kQuads - 1)) << 2) + (k & 3);
}

size_t wide_smem_bytes() {
  return sizeof(float) * (size_t)kStages * (kBE + kBP) * kBK;
}

// kVec16: m % 4 == 0 and IL, w 16-byte aligned.
template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
fitness_partial_kernel(const float* __restrict__ il,
                       const float* __restrict__ w,
                       const float* __restrict__ target, float att,
                       float limit, int E, int m, int P,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) float wsm[];
  float* As = wsm;                                  // [stage][kBE][kBK]
  float* Bs = wsm + kStages * kBE * kBK;            // [stage][kBP][kBK]
  __shared__ float red[kRowsT][kBP];

  const int tid = threadIdx.x;
  const int ty = tid % kRowsT, tx = tid / kRowsT;   // a warp: 16 ty x 2 tx
  const int e0 = blockIdx.x * kBE, p0 = blockIdx.y * kBP;
  const int nk = (m + kBK - 1) / kBK;

  // chunk kc of IL rows e0 .. e0 + kBE - 1 and of w rows p0 .. p0 + kBP - 1
  // into stage st; past E, P or m the copies read nothing and write zeros
  auto issue = [&](int kc, int st) {
    const int k0 = kc * kBK;
    float* as = As + st * kBE * kBK;
    float* bs = Bs + st * kBP * kBK;
    if constexpr (kVec16) {
#pragma unroll
      for (int u = 0; u < kBE * kQuads / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / kQuads, k = k0 + (i % kQuads) * 4;
        const bool in = e0 + r < E && k < m;
        cp_async16(as + a_at(r, k - k0),
                   in ? il + (size_t)(e0 + r) * m + k : il, in ? 16 : 0);
      }
#pragma unroll
      for (int u = 0; u < (kBP * kQuads + kThreads - 1) / kThreads; ++u) {
        const int i = tid + u * kThreads;
        if (i >= kBP * kQuads) break;
        const int r = i / kQuads, k = k0 + (i % kQuads) * 4;
        const bool in = p0 + r < P && k < m;
        cp_async16(bs + b_at(r, k - k0),
                   in ? w + (size_t)(p0 + r) * m + k : w, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBE * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        const bool in = e0 + r < E && k < m;
        cp_async4(as + a_at(r, k - k0),
                  in ? il + (size_t)(e0 + r) * m + k : il, in ? 4 : 0);
      }
      for (int i = tid; i < kBP * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        const bool in = p0 + r < P && k < m;
        cp_async4(bs + b_at(r, k - k0),
                  in ? w + (size_t)(p0 + r) * m + k : w, in ? 4 : 0);
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kStages - 2>();
    __syncthreads();   // chunk kc landed; chunk kc - 1's stage is free
    if (kc + kStages - 1 < nk)
      issue(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_commit();
    const int st = kc % kStages;
    const float* as = As + st * kBE * kBK;
    const float* bs = Bs + st * kBP * kBK;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + a_at(ty * kTM + i,
                                                          4 * q));
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + b_at(tx * kTN + j,
                                                          4 * q));
      // k = 4q .. 4q + 3 in order: one FMA chain per dot
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
  }
  cp_wait<0>();

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

// Scratch ``partial`` holds ceil(E / fitness_block_events()) x P floats;
// vec16: m % 4 == 0 and il, w start on 16-byte boundaries.  Returns the
// CUDA error of the launches (0 when both were accepted).
int fitness_sq(const float* il, const float* w, const float* target,
               float att, float limit, int E, int m, int P, int vec16,
               float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = wide_smem_bytes();
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fitness_partial_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fitness_partial_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((E + kBE - 1) / kBE, (P + kBP - 1) / kBP);
  if (vec16)
    fitness_partial_kernel<true><<<grid, kThreads, smem, s>>>(
        il, w, target, att, limit, E, m, P, partial);
  else
    fitness_partial_kernel<false><<<grid, kThreads, smem, s>>>(
        il, w, target, att, limit, E, m, P, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fitness_reduce_kernel<<<(P + kReduceThreads - 1) / kReduceThreads,
                          kReduceThreads, 0, s>>>(partial, grid.x, P, out);
  return static_cast<int>(cudaGetLastError());
}

int fitness_block_events() { return kBE; }

int fitness_block_individuals() { return kBP; }

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
