// Device side of the two probes that run as PyTorch operators
// (probe_ops.cpp registers them as torch.ops.a1t.*): smem-output and
// blocked-2d. The other four probes are in probes.cu, behind ctypes.
//
// Replaces the pallas_calls of arrow1_tpu/kernels/tpu_probes.py:100
// (smem-output, sum(x) into a 1-element output) and :50 (blocked-2d,
// 2 * x over [8, 128] tiles).
//
// Bound on the H100: 16 KB in and at most 16 KB out, a few nanoseconds at
// 3.35 TB/s; a call costs its launch and the host code around it. So the
// host code went to C++ (probe_ops.cpp), and the kernels use one 16-byte
// load per thread where they can, with no extra launch:
//   smem-output  one block: int4 loads over the 16-byte-aligned middle of
//                x, scalar loads for the head and the tail, a warp-shuffle
//                reduction, one shared-memory stage, and one int32 store
//                (no memset: the block writes its only output). int32
//                arithmetic wraps, as the TPU's int32 sum does;
//   blocked-2d   one block per [8, 128] tile, laid out as 8 rows of 32
//                int4 lanes: 256 threads, one 16-byte load and store each.
// This file includes no PyTorch header: only probe_ops.cpp does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 1024;
constexpr int kRows = 8;          // a tile is [kRows, kLanes] int32
constexpr int kLanes = 128;
constexpr int kVecLanes = kLanes / 4;   // int4 lanes of a row
constexpr unsigned kFullWarp = 0xffffffffu;

// Sums wrap modulo 2^32: unsigned arithmetic, stored as int32.
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const int* __restrict__ x, long long n, long long head,
           int* __restrict__ o) {
  __shared__ unsigned warp_sum[kSumThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned s = 0;
  // x + head is 16-byte aligned; head < 4 values before it, < 4 after
  // the last whole int4
  const long long n4 = (n - head) / 4;
  const int4* __restrict__ x4 = reinterpret_cast<const int4*>(x + head);
  for (long long i = threadIdx.x; i < n4; i += kSumThreads) {
    const int4 v = x4[i];
    s += static_cast<unsigned>(v.x) + static_cast<unsigned>(v.y) +
         static_cast<unsigned>(v.z) + static_cast<unsigned>(v.w);
  }
  if (threadIdx.x < head) s += static_cast<unsigned>(x[threadIdx.x]);
  const long long tail = head + 4 * n4;
  if (tail + threadIdx.x < n) {
    s += static_cast<unsigned>(x[tail + threadIdx.x]);
  }
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFullWarp, s, d);
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum[lane];
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFullWarp, s, d);
    if (lane == 0) o[0] = static_cast<int>(s);
  }
}

// x and o 16-byte aligned, [rows, kLanes] with rows a multiple of kRows;
// launched with dim3(kVecLanes, kRows), one tile a block.
__global__ void __launch_bounds__(kVecLanes * kRows)
double_tile_kernel(const int4* __restrict__ x, int4* __restrict__ o) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kRows + threadIdx.y) *
          kVecLanes + threadIdx.x;
  int4 v = x[i];
  // 2 * v modulo 2^32, as int32 arithmetic wraps
  v.x = static_cast<int>(2u * static_cast<unsigned>(v.x));
  v.y = static_cast<int>(2u * static_cast<unsigned>(v.y));
  v.z = static_cast<int>(2u * static_cast<unsigned>(v.z));
  v.w = static_cast<int>(2u * static_cast<unsigned>(v.w));
  o[i] = v;
}

}  // namespace

extern "C" {

// Both launch on `stream`, never synchronise, and return
// cudaGetLastError(). The caller (probe_ops.cpp) has checked the inputs.

// n > 0 int32 values at x (4-byte aligned); the sum into o[0].
int a1t_probe_ops_sum(const int* x, int64_t n, int* o, void* stream) {
  const long long head =
      ((16 - reinterpret_cast<uintptr_t>(x) % 16) % 16) / 4;
  sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, head < n ? head : n, o);
  return static_cast<int>(cudaGetLastError());
}

// rows > 0, a multiple of 8; x and o 16-byte aligned.
int a1t_probe_ops_double_2d(const int* x, int64_t rows, int* o,
                            void* stream) {
  double_tile_kernel<<<static_cast<unsigned>(rows / kRows),
                       dim3(kVecLanes, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
