// The feature-probe matrix: small kernels, each the Hopper form of one of
// the Mosaic features that the JAX package's probe matrix exercises. Two
// are here, behind a plain C interface; blocked-1d, blocked-2d, cumsum-1d
// and smem-output are in probe_ops.cu, launched by PyTorch operators
// (probe_ops.cpp). Neither of these two has one PyTorch call that
// computes its output.
//
// Replaces two pallas_calls of arrow1_tpu/kernels/tpu_probes.py
// (run_probes). Each computes what its TPU probe computes, with the
// mechanism that corresponds to the probed feature:
//
//   manual-dma-matmul  per row, the inclusive count of odd values (the
//                      TPU's (x % 2) @ upper-triangular product): the tile
//                      arrives in shared memory by cp.async (the TPU's
//                      manual DMA), one warp scans each row, and the tile
//                      leaves from shared memory;
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

constexpr int kRows = 8;        // a 2-D tile is [kRows, kLanes] int32
constexpr int kLanes = 128;
constexpr int kTileElems = kRows * kLanes;
constexpr unsigned kFullWarp = 0xffffffffu;

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

}  // namespace

extern "C" {

// Both entries take int32 device buffers of [rows, 128], rows a positive
// multiple of 8, 16-byte aligned; each launches on `stream`, never
// synchronises, and returns cudaGetLastError().

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
