// K4: per probe key, the number of keys of a small sorted build array that
// are smaller, and the number that are equal (unsigned 64-bit order).
//
// Replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/hashtable.py:broadcast_probe (_bprobe_kernel). The TPU
// kernel splits each key into sign-flipped i32 words, keeps the build keys
// as scalars in SMEM and compares every [128, 128] probe tile against all T
// build keys by broadcast: T compares per probe. Hopper compares 64-bit
// integers natively, so each block loads the T <= 2048 build keys (16 KB at
// T = 2048) into shared memory with 16-byte loads and each thread runs two
// branch-free binary searches per probe key over them (lower and upper
// bound, ceil(log2 T) steps each, 11 at T = 2048): lo is the lower bound
// and count the difference of the two. Keys are compared as unsigned long
// long, never as long long.
//
// Bound on the H100: memory bytes. Each probe reads its key (8 bytes) and
// writes lo and count (4 + 4 bytes); the build keys are read once per block
// from L2. Threads take two probe keys at a time (one 16-byte load, two
// 8-byte stores), so each warp keeps four independent searches in flight.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTMax = 2048;

// Number of keys in sorted s[0, T) that are < x (kUpper false) or <= x
// (kUpper true). T >= 1. The invariant: the answer lies in
// [base, base + len]; each step halves len with a select, not a branch.
template <bool kUpper>
__device__ __forceinline__ int search(const unsigned long long* s, int T,
                                      unsigned long long x) {
  int base = 0;
  int len = T;
  while (len > 1) {
    const int half = len >> 1;
    const unsigned long long v = s[base + half];
    const bool right = kUpper ? (v <= x) : (v < x);
    base = right ? base + half : base;
    len -= half;
  }
  const unsigned long long v = s[base];
  return base + static_cast<int>(kUpper ? (v <= x) : (v < x));
}

__device__ __forceinline__ void probe_one(const unsigned long long* s, int T,
                                          unsigned long long x, int* lo,
                                          int* cnt) {
  const int l = search<false>(s, T, x);
  *lo = l;
  *cnt = search<true>(s, T, x) - l;
}

// build and probe start on 16 bytes; lo and cnt on 8.
__global__ void __launch_bounds__(kThreads)
broadcast_probe_kernel(const unsigned long long* __restrict__ build, int T,
                       const unsigned long long* __restrict__ probe,
                       int64_t n, int* __restrict__ lo,
                       int* __restrict__ cnt) {
  __shared__ __align__(16) unsigned long long sb[kTMax];
  const ulonglong2* b2 = reinterpret_cast<const ulonglong2*>(build);
  for (int i = threadIdx.x; i < T / 2; i += blockDim.x) {
    const ulonglong2 v = b2[i];
    sb[2 * i] = v.x;
    sb[2 * i + 1] = v.y;
  }
  if ((T & 1) && threadIdx.x == 0) sb[T - 1] = build[T - 1];
  __syncthreads();

  const int64_t pairs = n / 2;
  const ulonglong2* p2 = reinterpret_cast<const ulonglong2*>(probe);
  int2* lo2 = reinterpret_cast<int2*>(lo);
  int2* cnt2 = reinterpret_cast<int2*>(cnt);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < pairs; i += stride) {
    const ulonglong2 x = p2[i];
    int2 l, c;
    probe_one(sb, T, x.x, &l.x, &c.x);
    probe_one(sb, T, x.y, &l.y, &c.y);
    lo2[i] = l;
    cnt2[i] = c;
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0)
    probe_one(sb, T, probe[n - 1], &lo[n - 1], &cnt[n - 1]);
}

}  // namespace

extern "C" {

// build: T sorted u64 keys (1 <= T <= 2048), probe: n u64 keys (n >= 1),
// both starting on 16 bytes; lo, cnt: int32[n] on the device, starting on
// 8 bytes. Launches on `stream`, never synchronises; returns the CUDA
// error code (cudaErrorInvalidValue for a T outside [1, 2048]).
int a1t_broadcast_probe(const unsigned long long* build, int64_t T,
                        const unsigned long long* probe, int64_t n, int* lo,
                        int* cnt, void* stream) {
  if (T < 1 || T > kTMax || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, broadcast_probe_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one thread per probe pair, no more blocks than stay resident
  const int64_t need = ((n + 1) / 2 + kThreads - 1) / kThreads;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < resident ? need : resident);
  broadcast_probe_kernel<<<grid, kThreads, 0, s>>>(
      build, static_cast<int>(T), probe, n, lo, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
