// Copy one physical page over another in every layer of a stacked pool: the
// Hopper port of repro/kernels/paged_attention/kernel.py::copy_page_pallas
// (_copy_page_kernel), the serving engine's copy-on-write primitive.
//
// What it computes: for a contiguous pool (L, NB, ...) of any element type,
// the bytes of page src are copied over page dst in each of the L layers, in
// place; every other page is left as it was.  The same launch serves the K
// and V pools and, with int8 pages, their fp32 scale pools: it moves bytes.
//
// Design for a CUDA grid (the TPU kernel has one grid step per layer, the
// page ids arriving as scalar prefetch):
//   * the ids are read from a 2-element int32 device array {src, dst}, so no
//     host sync is needed and one build serves every copy.  The kernel
//     checks them itself: src == dst or an id outside [0, NB) copies nothing
//     and sets *err to 1 (the wrapper reads that flag where it is asked to);
//   * grid (ceil(vectors / kThreads), L): a block copies kThreads vectors of
//     one layer's page, one per thread;
//   * vectors are 16 bytes where the page size and the pool's base address
//     allow, else the widest of 8, 4, 2 or 1 bytes that divides both (the
//     tail case: every page then starts on that width).
//
// Bound on an H100: bytes, 2 * L * page_bytes (read src, write dst).  A
// gemma-2b K page is 16 x 256 bf16 = 8 KiB per layer, 18 layers: 147 KiB per
// pool, a few microseconds at 3.35 TB/s, so the launch itself dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int W> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

template <int W>
__global__ void __launch_bounds__(kThreads)
copy_page_kernel(char* pool, const int* __restrict__ ids,
                 int* __restrict__ err, int NB, long long page_bytes) {
  using V = typename Word<W>::type;
  const int src = ids[0], dst = ids[1];
  if (src == dst || src < 0 || dst < 0 || src >= NB || dst >= NB) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *err = 1;
    return;
  }
  const long long nvec = page_bytes / W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  char* layer = pool + (long long)blockIdx.y * NB * page_bytes;
  const V* from = reinterpret_cast<const V*>(layer + src * page_bytes);
  V* to = reinterpret_cast<V*>(layer + dst * page_bytes);
  to[i] = from[i];
}

template <int W>
cudaError_t launch(void* pool, const void* ids, void* err, int L, int NB,
                   long long page_bytes, cudaStream_t stream) {
  const long long nvec = page_bytes / W;
  const dim3 grid((unsigned)((nvec + kThreads - 1) / kThreads), L);
  copy_page_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<char*>(pool), static_cast<const int*>(ids),
      static_cast<int*>(err), NB, page_bytes);
  return cudaGetLastError();
}

}  // namespace

// pool: contiguous (L, NB, ...) of page_bytes bytes per page; ids: device
// int32 {src, dst}; err: device int32 flag, set to 1 for bad ids.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int copy_page_launch(void* pool, const void* ids, void* err,
                                int L, int NB, long long page_bytes,
                                void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (L <= 0 || NB <= 0 || page_bytes <= 0) return (int)cudaErrorInvalidValue;
  const unsigned long long align =
      (unsigned long long)page_bytes | reinterpret_cast<uintptr_t>(pool);
  if (align % 16 == 0) return (int)launch<16>(pool, ids, err, L, NB,
                                              page_bytes, stream);
  if (align % 8 == 0) return (int)launch<8>(pool, ids, err, L, NB,
                                            page_bytes, stream);
  if (align % 4 == 0) return (int)launch<4>(pool, ids, err, L, NB,
                                            page_bytes, stream);
  if (align % 2 == 0) return (int)launch<2>(pool, ids, err, L, NB,
                                            page_bytes, stream);
  return (int)launch<1>(pool, ids, err, L, NB, page_bytes, stream);
}

extern "C" const char* copy_page_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
