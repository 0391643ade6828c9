// Copy one physical page over another in every layer of every pool of a
// paged KV cache, in one launch: the Hopper port of
// repro/kernels/paged_attention/kernel.py::copy_page_pallas
// (_copy_page_kernel), the serving engine's copy-on-write primitive.
//
// What it computes: for up to kMaxPools contiguous pools (L, NB, ...) that
// share L and NB and may differ in element type and page bytes (K and V
// pools; with int8 pages also their fp32 scale pools), the bytes of page
// src are copied over page dst in each of the L layers of each pool, in
// place; every other page is left as it was.  One pool is copy_page_pallas
// itself; several are what one copy-on-write needs, in one launch where the
// TPU runs one kernel a pool.
//
// Design for a CUDA grid (the TPU kernel has one grid step per layer, the
// page ids arriving as scalar prefetch):
//   * the pools travel by value (a Pools struct of bases, page bytes and
//     word widths), so a launch needs no descriptor upload.  The ids are either
//     host ints passed by value (the wrapper checked them) or a 2-element
//     int32 device array {src, dst} read by every block (no host sync).
//     Every block checks them: src == dst or an id outside [0, NB) copies
//     nothing in any pool and sets *err to 1 (the wrapper reads that flag
//     where it is asked to);
//   * grid (chunks of every pool, L): blockIdx.x runs over the pools' chunks
//     one pool after the other (Pools::first), blockIdx.y over the layers; a
//     block copies one chunk of one layer's page of one pool;
//   * a chunk moves in words of the widest of 16, 8, 4, 2 or 1 bytes that
//     divides the pool's base and page size (a 12-byte page takes 4-byte
//     words), kWords words a thread, every load issued before any store;
//   * src != dst, so a chunk's source and destination never overlap.
// A one-thread bulk asynchronous copy of each 4 KiB chunk (cp.async.bulk
// global -> shared on an mbarrier, then shared -> global) was measured
// against these words at gemma-2b's cache and was no faster (PERF.md §6,
// row 3), so it is not kept.
//
// Bound on an H100: bytes, 2 * L * sum(page_bytes) (read src, write dst).
// Over gemma-2b's cache (18 layers, block 16, one kv head of 256) a COW moves
// 2 x 147456 bytes of bf16 K and V pages, 0.176 us at 3.35 TB/s, or 2 x
// (73728 + 1152) bytes of int8 pages and scales, 0.089 us: far below one
// launch.  So the design removes launches and host work: one launch per
// copy-on-write over every pool, the ids by value, no upload.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPools = 4;
constexpr int kThreads = 64;          // a block
constexpr int kWords = 4;             // words a thread

// The pools of one launch.  width[p] is pool p's word in bytes; a block
// copies a chunk of kThreads * kWords words, and pool p's chunks are blocks
// first[p] .. first[p + 1] - 1 of grid x.
struct Pools {
  char* base[kMaxPools];
  long long page_bytes[kMaxPools];
  int width[kMaxPools];
  int first[kMaxPools + 1];
  int n;
};

template <int W> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

// The block's threads: bytes (a multiple of W) in words of W bytes, kWords
// a thread, all loads before any store.
template <int W>
__device__ __forceinline__ void copy_words(char* to, const char* from,
                                           long long bytes) {
  using V = typename Word<W>::type;
  const V* f = reinterpret_cast<const V*>(from);
  V* t = reinterpret_cast<V*>(to);
  const long long n = bytes / W;
  V v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long i = threadIdx.x + (long long)k * kThreads;
    if (i < n) v[k] = f[i];
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long i = threadIdx.x + (long long)k * kThreads;
    if (i < n) t[i] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
copy_pages_kernel(const Pools pools, int NB, int src, int dst,
                  const int* __restrict__ ids, int* __restrict__ err) {
  if (ids != nullptr) {
    src = ids[0];
    dst = ids[1];
  }
  if (src == dst || src < 0 || dst < 0 || src >= NB || dst >= NB) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *err = 1;
    return;
  }
  const int x = blockIdx.x;
  int p = 0;
  while (p + 1 < pools.n && x >= pools.first[p + 1]) ++p;
  const long long pb = pools.page_bytes[p];
  const long long chunk = (long long)kThreads * kWords * pools.width[p];
  const long long off = (long long)(x - pools.first[p]) * chunk;
  const long long bytes = pb - off < chunk ? pb - off : chunk;
  char* layer = pools.base[p] + (long long)blockIdx.y * NB * pb;
  const char* from = layer + (long long)src * pb + off;
  char* to = layer + (long long)dst * pb + off;
  switch (pools.width[p]) {
    case 16: return copy_words<16>(to, from, bytes);
    case 8: return copy_words<8>(to, from, bytes);
    case 4: return copy_words<4>(to, from, bytes);
    case 2: return copy_words<2>(to, from, bytes);
    default: return copy_words<1>(to, from, bytes);
  }
}

}  // namespace

// bases[i]: pool i, contiguous (L, NB, ...) of page_bytes[i] bytes a page,
// i < n_pools <= 4.  ids: device int32 {src, dst}, or null to take src and
// dst as given.  err: device int32 flag, set to 1 for bad ids.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int copy_pages_launch(void* const* bases,
                                 const long long* page_bytes, int n_pools,
                                 int L, int NB, int src, int dst,
                                 const void* ids, void* err,
                                 void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_pools < 1 || n_pools > kMaxPools || L <= 0 || L > 65535 || NB <= 0)
    return (int)cudaErrorInvalidValue;
  Pools pools = {};
  pools.n = n_pools;
  long long blocks = 0;
  for (int i = 0; i < n_pools; ++i) {
    const long long pb = page_bytes[i];
    if (pb <= 0 || bases[i] == nullptr) return (int)cudaErrorInvalidValue;
    const unsigned long long align =
        (unsigned long long)pb | reinterpret_cast<uintptr_t>(bases[i]);
    const int w = align % 16 == 0 ? 16 : align % 8 == 0 ? 8
                  : align % 4 == 0 ? 4 : align % 2 == 0 ? 2 : 1;
    pools.base[i] = static_cast<char*>(bases[i]);
    pools.page_bytes[i] = pb;
    pools.width[i] = w;
    pools.first[i] = (int)blocks;
    const long long chunk = (long long)kThreads * kWords * w;
    blocks += (pb + chunk - 1) / chunk;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  pools.first[n_pools] = (int)blocks;
  const dim3 grid((unsigned)blocks, L);
  copy_pages_kernel<<<grid, kThreads, 0, stream>>>(
      pools, NB, src, dst, static_cast<const int*>(ids),
      static_cast<int*>(err));
  return (int)cudaGetLastError();
}

extern "C" const char* copy_page_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
