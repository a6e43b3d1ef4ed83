// The feature-probe matrix: small kernels, each the Hopper form of one of
// the Mosaic features that the JAX package's probe matrix exercises. Four
// are here, behind a plain C interface; smem-output and blocked-2d are in
// probe_ops.cu, launched by PyTorch operators (probe_ops.cpp).
//
// Replaces four pallas_calls of arrow1_tpu/kernels/tpu_probes.py
// (run_probes). Each computes what its TPU probe computes, with the
// mechanism that corresponds to the probed feature:
//
//   blocked-1d         2 * x over 1-D blocks of 1024: one block per block;
//   manual-dma-matmul  per row, the inclusive count of odd values (the
//                      TPU's (x % 2) @ upper-triangular product): the tile
//                      arrives in shared memory by cp.async (the TPU's
//                      manual DMA), one warp scans each row, and the tile
//                      leaves from shared memory;
//   cumsum-1d          inclusive int32 cumsum: one block, a block scan;
//   dma-in-when        cp.async of each [8, 128] tile into shared memory,
//                      stored to the output only on even tiles (the TPU's
//                      DMA under pl.when).
//
// Bound on the H100: each probe moves 16 KB in and at most 16 KB out, a
// few nanoseconds at 3.35 TB/s; its time is the launch. They exist to show
// that each mechanism builds, launches and computes the right values.

#include <cstdint>

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;    // blocked-1d's block, cumsum's threads
constexpr int kRows = 8;        // a 2-D tile is [kRows, kLanes] int32
constexpr int kLanes = 128;
constexpr int kTileElems = kRows * kLanes;
constexpr unsigned kFullWarp = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
double_1d_kernel(const int* __restrict__ x, int* __restrict__ o) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  o[i] = 2 * x[i];
}

// The block's [kRows, kLanes] tile into shared memory by cp.async, 16
// bytes a thread; returns after the copy has landed and every thread of
// the block can see it. Launched with kTileElems / 4 threads.
__device__ __forceinline__ void tile_to_shared(const int* __restrict__ x,
                                               int* tile) {
  const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
  __pipeline_memcpy_async(tile + 4 * threadIdx.x, x + base + 4 * threadIdx.x,
                          16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

constexpr int kCopyThreads = kTileElems / 4;  // 256: one 16-byte copy each

__global__ void __launch_bounds__(kCopyThreads)
dma_scan_kernel(const int* __restrict__ x, int* __restrict__ o) {
  __shared__ __align__(16) int tile[kTileElems];
  tile_to_shared(x, tile);
  // one warp per row (8 warps, 8 rows), four values a lane
  const int lane = threadIdx.x & 31;
  int* row = tile + (threadIdx.x >> 5) * kLanes;
  int v[4];
  int local = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    local += row[4 * lane + k] & 1;   // x mod 2 (floor mod, as in JAX)
    v[k] = local;
  }
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, incl, d);
    if (lane >= d) incl += up;
  }
  const int before = incl - local;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) row[4 * lane + k] = before + v[k];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
  reinterpret_cast<int4*>(o + base)[threadIdx.x] =
      reinterpret_cast<const int4*>(tile)[threadIdx.x];
}

__global__ void __launch_bounds__(kCopyThreads)
dma_when_kernel(const int* __restrict__ x, int* __restrict__ o) {
  __shared__ __align__(16) int tile[kTileElems];
  tile_to_shared(x, tile);
  if (blockIdx.x % 2 == 0) {
    const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
    reinterpret_cast<int4*>(o + base)[threadIdx.x] =
        reinterpret_cast<const int4*>(tile)[threadIdx.x];
  }
}

__global__ void __launch_bounds__(kBlock)
cumsum_kernel(const int* __restrict__ x, long long n, int* __restrict__ o) {
  __shared__ int warp_tot[kBlock / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long start = 0; start < n; start += kBlock) {
    const long long i = start + threadIdx.x;
    const int v = i < n ? x[i] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullWarp, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_tot[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFullWarp, w, d);
        if (lane >= d) w += up;
      }
      warp_tot[lane] = w;
    }
    __syncthreads();
    const int out = carry + (warp ? warp_tot[warp - 1] : 0) + incl;
    if (i < n) o[i] = out;
    __syncthreads();  // every thread has read carry and warp_tot
    if (threadIdx.x == kBlock - 1) carry = out;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Every entry takes int32 device buffers and launches on `stream`, never
// synchronises, and returns cudaGetLastError(). The 2-D probes take
// [rows, 128] with rows a positive multiple of 8 and 16-byte aligned
// buffers; blocked-1d takes n a positive multiple of 1024.

int a1t_probe_blocked_1d(const void* x, int64_t n, void* o, void* stream) {
  if (n <= 0 || n % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  double_1d_kernel<<<static_cast<unsigned>(n / kBlock), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(o));
  return static_cast<int>(cudaGetLastError());
}

int a1t_probe_dma_matmul(const void* x, int64_t rows, void* o,
                         void* stream) {
  if (rows <= 0 || rows % kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dma_scan_kernel<<<static_cast<unsigned>(rows / kRows), kCopyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(o));
  return static_cast<int>(cudaGetLastError());
}

int a1t_probe_cumsum_1d(const void* x, int64_t n, void* o, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cumsum_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), n, static_cast<int*>(o));
  return static_cast<int>(cudaGetLastError());
}

int a1t_probe_dma_in_when(const void* x, int64_t rows, void* o,
                          void* stream) {
  if (rows <= 0 || rows % kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dma_when_kernel<<<static_cast<unsigned>(rows / kRows), kCopyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
