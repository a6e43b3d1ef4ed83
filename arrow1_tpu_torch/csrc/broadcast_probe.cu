// K4: per probe key, the number of keys of a small sorted build array that
// are smaller, and the number that are equal (unsigned 64-bit order).
//
// Replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/hashtable.py:broadcast_probe (_bprobe_kernel). The TPU
// kernel splits each key into sign-flipped i32 words, keeps the build keys
// as scalars in SMEM and compares every [128, 128] probe tile against all T
// build keys by broadcast: T compares per probe. Hopper compares 64-bit
// integers natively, so each block builds a small search table in shared
// memory and each probe key takes one short search of it. Keys are compared
// as unsigned long long, never as long long.
//
// Bound on the H100: memory bytes. Each probe reads its key (8 bytes) and
// writes lo and count (4 + 4 bytes); the build keys are read once per block
// from L2. The design keeps the search short enough that the loads are
// the limit:
//
//   - one search per key: a run-end table beside the keys gives, at the
//     first index of each run of equal keys, the first index past it, so
//     count = run_end[lo] - lo where s[lo] == x, and no second search for
//     the upper bound;
//   - a radix directory over the build's key range: the range [s[0],
//     s[T-1]] is cut into 2^12 buckets of equal width (x - s[0] shifted
//     right), and each bucket's entry holds the first index of its keys
//     and the first index past them. A key outside the range resolves at
//     once; any other key reads its entry and searches only its bucket. On
//     keys spread over their range a bucket holds 0-2 keys; a build whose
//     keys crowd into one bucket falls back to a search of that bucket,
//     one binary search of at most 11 steps at T = 2048;
//   - each thread takes four keys at a time (two 16-byte loads, two
//     16-byte stores) and runs their four searches interleaved, and the
//     next four keys' loads are in flight while it searches: a thread's
//     first loads are issued before its block builds the table;
//   - the grid is the blocks that stay resident (two a SM), each building
//     its table once; the table is built in parallel with no search per
//     bucket: the first key of each bucket marks it, and a block-wide
//     suffix minimum fills the empty buckets.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTMax = 2048;
constexpr int kDirBits = 12;
constexpr int kBuckets = 1 << kDirBits;
constexpr int kPerThread = kBuckets / kThreads;  // directory entries
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kBuckets % kThreads == 0, "whole directory entries a thread");
static_assert(kTMax < (1 << 16), "indices fit a directory entry's halves");

struct Table {  // 36,928 bytes of static shared memory
  unsigned long long keys[kTMax];
  // bucket b: its first key's index (low 16 bits) and the first index
  // past its keys (high 16 bits)
  unsigned dir[kBuckets];
  // at the first index of each run of equal keys: the first index past it
  unsigned short run_end[kTMax];
  unsigned warp_min[kWarps];
};

// The directory's view of the build: keys in [first, last] fall into
// bucket (x - first) >> shift, which is below kBuckets.
struct Range {
  unsigned long long first;
  unsigned long long last;
  int shift;
  int T;
};

__device__ __forceinline__ unsigned bucket(const Range& r,
                                           unsigned long long x) {
  return static_cast<unsigned>((x - r.first) >> r.shift);
}

// Lower bounds of K keys at once, interleaved: for each j, the answer lies
// in [lo[j], lo[j] + len[j]]. The keys take the same steps, halving powers
// of two from the largest len's top bit down to 1 (they add up to at least
// any len); a key takes a step where it stays inside its range and lands
// on a smaller key.
template <int K>
__device__ __forceinline__ void search(const unsigned long long* s,
                                       const unsigned long long (&x)[K],
                                       int (&lo)[K], const int (&len)[K]) {
  int end[K];
  int most = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    end[j] = lo[j] + len[j];
    most = max(most, len[j]);
  }
  for (int step = most ? 1 << (31 - __clz(most)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = lo[j] + step - 1;
      if (i < end[j] && s[i] < x[j]) lo[j] += step;
    }
  }
}

// (lo, count) of four keys.
__device__ __forceinline__ void probe4(const Table& t, const Range& r,
                                       const unsigned long long (&x)[4],
                                       int (&lo)[4], int (&cnt)[4]) {
  int len[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    len[j] = 0;
    if (x[j] < r.first) {
      lo[j] = 0;
    } else if (x[j] > r.last) {
      lo[j] = r.T;
    } else {
      const unsigned e = t.dir[bucket(r, x[j])];
      lo[j] = static_cast<int>(e & 0xffffu);
      len[j] = static_cast<int>(e >> 16) - lo[j];
    }
  }
  search(t.keys, x, lo, len);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cnt[j] = lo[j] < r.T && t.keys[lo[j]] == x[j]
                 ? t.run_end[lo[j]] - lo[j]
                 : 0;
  }
}

// The directory from its marks (t.dir[b]: the index of bucket b's first
// key, or T where it has none): entry b becomes the least mark at or past
// b, and the entry after it, packed. A thread holds kPerThread consecutive
// entries; a suffix minimum runs over them, then over the lanes, then over
// the warps. Every thread writes only the entries it read.
__device__ __forceinline__ void build_directory(Table& t, int T) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = threadIdx.x * kPerThread;
  unsigned m[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) m[j] = t.dir[b0 + j];
#pragma unroll
  for (int j = kPerThread - 2; j >= 0; --j) m[j] = min(m[j], m[j + 1]);
  unsigned inc = m[0];  // the least mark of lanes [lane, 32)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_down_sync(kFullWarp, inc, off);
    if (lane + off < 32) inc = min(inc, v);
  }
  unsigned after = __shfl_down_sync(kFullWarp, inc, 1);
  if (lane == 31) after = static_cast<unsigned>(T);
  if (lane == 0) t.warp_min[warp] = inc;
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) after = min(after, t.warp_min[w]);
  // after: the least mark past this thread's entries, the entry b0 + 8
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned next = j + 1 < kPerThread ? min(m[j + 1], after) : after;
    t.dir[b0 + j] = min(m[j], after) | next << 16;
  }
}

// build and probe start on 16 bytes, lo and cnt on 16.
__global__ void __launch_bounds__(kThreads, 2)
broadcast_probe_kernel(const unsigned long long* __restrict__ build, int T,
                       const unsigned long long* __restrict__ probe,
                       long long n, int* __restrict__ lo,
                       int* __restrict__ cnt) {
  __shared__ Table t;
  const long long nquads = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const ulonglong2* p2 = reinterpret_cast<const ulonglong2*>(probe);
  // this thread's first four keys load while the block builds its table
  ulonglong2 na = {0, 0}, nb = {0, 0};
  if (q < nquads) {
    na = __ldg(p2 + 2 * q);
    nb = __ldg(p2 + 2 * q + 1);
  }

  const ulonglong2* b2 = reinterpret_cast<const ulonglong2*>(build);
  for (int i = threadIdx.x; i < T / 2; i += kThreads) {
    const ulonglong2 v = __ldg(b2 + i);
    t.keys[2 * i] = v.x;
    t.keys[2 * i + 1] = v.y;
  }
  if ((T & 1) && threadIdx.x == 0) t.keys[T - 1] = build[T - 1];
  for (int b = threadIdx.x; b < kBuckets; b += kThreads) {
    t.dir[b] = static_cast<unsigned>(T);  // no key marks it yet
  }
  __syncthreads();
  Range r;
  r.first = t.keys[0];
  r.last = t.keys[T - 1];
  r.T = T;
  const int bits = 64 - __clzll(static_cast<long long>(r.last - r.first));
  r.shift = bits > kDirBits ? bits - kDirBits : 0;
  // the first key of each bucket marks it (one writer a bucket)
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const unsigned b = bucket(r, t.keys[i]);
    if (i == 0 || bucket(r, t.keys[i - 1]) != b) t.dir[b] = i;
  }
  __syncthreads();
  build_directory(t, T);
  __syncthreads();
  // the last key of each run finds the run's first in its bucket
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const unsigned long long k = t.keys[i];
    if (i + 1 == T || t.keys[i + 1] != k) {
      const unsigned long long x[1] = {k};
      int first[1] = {static_cast<int>(t.dir[bucket(r, k)] & 0xffffu)};
      const int len[1] = {i - first[0]};
      search(t.keys, x, first, len);
      t.run_end[first[0]] = static_cast<unsigned short>(i + 1);
    }
  }
  __syncthreads();

  int4* lo4 = reinterpret_cast<int4*>(lo);
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  for (; q < nquads; q += stride) {
    const unsigned long long x[4] = {na.x, na.y, nb.x, nb.y};
    const long long next = q + stride;
    if (next < nquads) {  // in flight while this thread searches
      na = __ldg(p2 + 2 * next);
      nb = __ldg(p2 + 2 * next + 1);
    }
    int l[4], c[4];
    probe4(t, r, x, l, c);
    lo4[q] = make_int4(l[0], l[1], l[2], l[3]);
    cnt4[q] = make_int4(c[0], c[1], c[2], c[3]);
  }
  // the last n % 4 keys, one a thread of the first block
  const long long i = 4 * nquads + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const unsigned long long x[4] = {probe[i], probe[i], probe[i],
                                     probe[i]};
    int l[4], c[4];
    probe4(t, r, x, l, c);
    lo[i] = l[0];
    cnt[i] = c[0];
  }
}

// Blocks of the kernel that fit the card at once, asked of the runtime
// once per device (a query costs microseconds a call).
cudaError_t resident_blocks(int* blocks) {
  static std::mutex mu;
  static int seen[64] = {};  // 0: not asked yet
  const std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (seen[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, broadcast_probe_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    seen[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = seen[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// build: T sorted u64 keys (1 <= T <= 2048), probe: n u64 keys (n >= 1),
// both starting on 16 bytes; lo, cnt: int32[n] on the device, starting on
// 16 bytes. Launches on `stream`, never synchronises; returns the CUDA
// error code (cudaErrorInvalidValue for a T outside [1, 2048]).
int a1t_broadcast_probe(const unsigned long long* build, int64_t T,
                        const unsigned long long* probe, int64_t n, int* lo,
                        int* cnt, void* stream) {
  if (T < 1 || T > kTMax || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a thread takes four keys a step; no more blocks than stay resident
  const int64_t need = (n / 4 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(need < 1 ? 1
                                    : need < resident ? need : resident);
  broadcast_probe_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      build, static_cast<int>(T), probe, n, lo, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
