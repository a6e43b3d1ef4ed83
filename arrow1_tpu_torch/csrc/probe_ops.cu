// Device side of the four probes that run as PyTorch operators
// (probe_ops.cpp registers them as torch.ops.a1t.*): blocked-1d,
// blocked-2d, cumsum-1d and smem-output. The other two probes are in
// probes.cu, behind ctypes.
//
// Replaces the pallas_calls of arrow1_tpu/kernels/tpu_probes.py:41
// (blocked-1d, 2 * x over 1-D blocks of 1024), :50 (blocked-2d, 2 * x over
// [8, 128] tiles), :90 (cumsum-1d, the inclusive int32 cumsum of x) and
// :100 (smem-output, sum(x) into a 1-element output).
//
// Bound on the H100: 16 KB in and at most 16 KB out, a few nanoseconds at
// 3.35 TB/s; a call costs its launch and the host code around it. So the
// host code is C++ (probe_ops.cpp), and the kernels use one 16-byte load
// per thread where they can, with no extra launch:
//   blocked-1d,  one kernel over n / 4 int4 lanes, 256 a block: one
//   blocked-2d   16-byte load and store a thread. A [8k, 128] tile row
//                order is the same memory as a 1-D array of 1024k values,
//                so both probes launch it;
//   cumsum-1d    one block of 1024 threads walks 4096-value tiles: each
//                thread loads an int4 and scans its four values in
//                registers, a shuffle scan runs over the thread totals,
//                one shared-memory stage holds the 32 warp totals, which
//                warp 0 scans, and each thread stores an int4. That is two
//                barriers a tile (two buffers of warp totals, so the next
//                tile needs no third); the carry between tiles stays in
//                registers. A misaligned view takes its < 4 head values
//                and its < 4 tail values one by one, as the sum does;
//   smem-output  one block: int4 loads over the 16-byte-aligned middle of
//                x, scalar loads for the head and the tail, a warp-shuffle
//                reduction, one shared-memory stage, and one int32 store
//                (no memset: the block writes its only output).
// int32 arithmetic wraps, as the TPU's does: sums are unsigned here.
// This file includes no PyTorch header: only probe_ops.cpp does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 1024;
constexpr int kScanThreads = 1024;
constexpr int kDoubleThreads = 256;   // int4 lanes a block: 1024 values
constexpr unsigned kFullWarp = 0xffffffffu;

// Values before the first 16-byte boundary at or after p, at most n.
long long head_of(const int* p, long long n) {
  const long long head =
      ((16 - reinterpret_cast<uintptr_t>(p) % 16) % 16) / 4;
  return head < n ? head : n;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v,
                                                        int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

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

// Inclusive cumsum of n > 0 values, one block of kScanThreads. x + head
// is 16-byte aligned; o + head is too when vec_out, else the body's
// values are stored one by one.
__global__ void __launch_bounds__(kScanThreads)
cumsum_kernel(const int* __restrict__ x, long long n, long long head,
              bool vec_out, int* __restrict__ o) {
  __shared__ unsigned warp_tot[2][kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // every thread keeps the running total (the same in all of them)
  unsigned carry = 0;
  for (long long i = 0; i < head; ++i) {
    carry += static_cast<unsigned>(x[i]);
    if (i == threadIdx.x) o[i] = static_cast<int>(carry);
  }
  const long long n4 = (n - head) / 4;
  const int4* __restrict__ x4 = reinterpret_cast<const int4*>(x + head);
  int* __restrict__ ob = o + head;
  int buf = 0;
  for (long long base = 0; base < n4; base += kScanThreads, buf ^= 1) {
    const long long i = base + threadIdx.x;
    int4 v = make_int4(0, 0, 0, 0);
    if (i < n4) v = x4[i];
    // the thread's four values, scanned in registers
    const unsigned a = static_cast<unsigned>(v.x);
    const unsigned b = a + static_cast<unsigned>(v.y);
    const unsigned c = b + static_cast<unsigned>(v.z);
    const unsigned d = c + static_cast<unsigned>(v.w);
    const unsigned incl = warp_inclusive_scan(d, lane);
    if (lane == 31) warp_tot[buf][warp] = incl;
    __syncthreads();
    if (warp == 0) {
      warp_tot[buf][lane] = warp_inclusive_scan(warp_tot[buf][lane], lane);
    }
    __syncthreads();
    // values before this thread's four: earlier tiles, warps and lanes
    const unsigned before =
        carry + (warp ? warp_tot[buf][warp - 1] : 0u) + (incl - d);
    if (i < n4) {
      const int4 out = make_int4(static_cast<int>(before + a),
                                 static_cast<int>(before + b),
                                 static_cast<int>(before + c),
                                 static_cast<int>(before + d));
      if (vec_out) {
        reinterpret_cast<int4*>(ob)[i] = out;
      } else {
        ob[4 * i] = out.x;
        ob[4 * i + 1] = out.y;
        ob[4 * i + 2] = out.z;
        ob[4 * i + 3] = out.w;
      }
    }
    // the next tile writes the other buffer, so this read needs no third
    // barrier: a thread reaches this buffer again only after every thread
    // has passed the next tile's first barrier
    carry += warp_tot[buf][kScanThreads / 32 - 1];
  }
  const long long tail = head + 4 * n4;
  for (long long i = tail; i < n; ++i) {
    carry += static_cast<unsigned>(x[i]);
    if (i - tail == threadIdx.x) o[i] = static_cast<int>(carry);
  }
}

// x and o 16-byte aligned, n4 int4 lanes, n4 a multiple of
// kDoubleThreads: one block per 1024 values.
__global__ void __launch_bounds__(kDoubleThreads)
double_kernel(const int4* __restrict__ x, int4* __restrict__ o) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kDoubleThreads + threadIdx.x;
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

// Each launches on `stream`, never synchronises, and returns
// cudaGetLastError(). The caller (probe_ops.cpp) has checked the inputs.

// n > 0 int32 values at x (4-byte aligned); the sum into o[0].
int a1t_probe_ops_sum(const int* x, int64_t n, int* o, void* stream) {
  sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, head_of(x, n), o);
  return static_cast<int>(cudaGetLastError());
}

// n > 0 int32 values at x and o (4-byte aligned); the inclusive cumsum.
int a1t_probe_ops_cumsum(const int* x, int64_t n, int* o, void* stream) {
  const long long head = head_of(x, n);
  const bool vec_out = reinterpret_cast<uintptr_t>(o + head) % 16 == 0;
  cumsum_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, head, vec_out, o);
  return static_cast<int>(cudaGetLastError());
}

// n > 0, a multiple of 1024; x and o 16-byte aligned.
int a1t_probe_ops_double(const int* x, int64_t n, int* o, void* stream) {
  double_kernel<<<static_cast<unsigned>(n / (4 * kDoubleThreads)),
                  kDoubleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
