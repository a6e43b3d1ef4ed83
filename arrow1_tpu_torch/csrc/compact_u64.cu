// Order-preserving compaction of 64-bit columns by a bool mask, in one
// pass with a decoupled look-back.
//
// Replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/compaction.py:compact_u64 (_compaction_kernel). That
// kernel walks the 1024-row tiles in grid order, computes positions with a
// triangular matrix product, routes 16-bit planes through one-hot products
// on the MXU and flushes aligned 1024-row tiles from a VMEM carry, because
// Mosaic has no cumsum and no exact 64-bit route, and its grid steps run
// one after another. Hopper's blocks run in no order, so the carried
// (base, rem) becomes a single-pass decoupled look-back over tiles:
//
//   1. a block takes its tile from an atomic ticket, not from blockIdx, so
//      it only ever waits on tiles whose blocks already run: no deadlock,
//      whatever the schedule;
//   2. it counts its kept rows with warp ballots and publishes the count
//      as (flag AGGREGATE, count), flag and value packed in ONE 64-bit
//      word, stored with release semantics;
//   3. its first warp reads the words of the 32 tiles before it with
//      acquire loads (never hoisted out of the spin loop), until one of
//      them holds an inclusive prefix, publishes its own inclusive prefix,
//      and the block stores each kept row at prefix + rank;
//   4. the last tile writes the total count.
//
// Bound on the H100: memory bytes. The least traffic is one read of the
// mask (1 byte a row) and of every column (8 bytes a row) and one write of
// each kept row (8 bytes a column); the status words add 8 bytes per 4096
// rows. The look-back is a chain of L2 round trips, hidden by the other
// tiles in flight.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                       // rows per thread
constexpr int kTileRows = kThreads * kSteps;     // 4096 rows a tile
constexpr int kMaxCols = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// status word: flag in the top two bits, the count or prefix below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagInclusive = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

struct ColumnSet {  // passed by value: 516 bytes of kernel parameters
  const unsigned long long* src[kMaxCols];
  unsigned long long* dst[kMaxCols];
  int ncols;
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The exclusive prefix of `tile`, by the first warp, once `aggregate` (this
// tile's count) is published. Lane i looks at tile - 1 - i - window.
__device__ __forceinline__ long long look_back(
    unsigned long long* status, long long tile, long long aggregate) {
  const int lane = threadIdx.x & 31;
  long long exclusive = 0;
  long long last = tile - 1;  // the nearest predecessor not yet summed
  while (true) {
    const long long j = last - lane;
    unsigned long long word = kFlagInclusive;  // before tile 0: prefix 0
    if (j >= 0) {
      do {
        word = load_acquire(status + j);
      } while ((word >> 62) == 0);
    }
    const unsigned incl = __ballot_sync(kFullWarp,
                                        (word >> 62) == (kFlagInclusive >> 62));
    // sum the lanes up to and including the nearest inclusive one
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(word & kValueMask) : 0;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullWarp, v, d);
    exclusive += v;
    if (incl) break;
    last -= 32;
  }
  if (lane == 0) {
    store_release(status + tile,
                  kFlagInclusive | static_cast<unsigned long long>(
                                       exclusive + aggregate));
  }
  return exclusive;
}

__global__ void __launch_bounds__(kThreads)
compact_u64_kernel(const uint8_t* __restrict__ mask, long long n,
                   long long ntiles, const ColumnSet cols,
                   unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ ticket,
                   int* __restrict__ count) {
  __shared__ long long s_tile;
  __shared__ long long s_exclusive;
  __shared__ int s_warp[kSteps][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(ticket, 1ull));
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long first = tile * kTileRows;

  // count: one ballot per step, the kept bits kept in a register
  unsigned kept_bits = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long row = first + s * kThreads + threadIdx.x;
    const bool k = row < n && mask[row] != 0;
    kept_bits |= static_cast<unsigned>(k) << s;
    const unsigned ballot = __ballot_sync(kFullWarp, k);
    if (lane == 0) s_warp[s][warp] = __popc(ballot);
  }
  __syncthreads();

  if (warp == 0) {
    // the tile's count, lane w of the warp adding up warp w's steps
    int c = 0;
    if (lane < kWarps) {
      for (int s = 0; s < kSteps; ++s) c += s_warp[s][lane];
    }
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFullWarp, c, d);
    const long long aggregate = c;
    long long exclusive = 0;
    if (tile == 0) {
      if (lane == 0) {
        store_release(status, kFlagInclusive |
                                  static_cast<unsigned long long>(aggregate));
      }
    } else {
      if (lane == 0) {
        store_release(status + tile,
                      kFlagAggregate |
                          static_cast<unsigned long long>(aggregate));
      }
      __syncwarp();
      exclusive = look_back(status, tile, aggregate);
    }
    if (lane == 0) {
      s_exclusive = exclusive;
      if (tile == ntiles - 1) *count = static_cast<int>(exclusive + aggregate);
    }
  }
  __syncthreads();

  // place: each kept row at exclusive + rows kept before it in the tile
  long long out = s_exclusive;
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long row = first + s * kThreads + threadIdx.x;
    const bool k = (kept_bits >> s) & 1u;
    const unsigned ballot = __ballot_sync(kFullWarp, k);
    int before = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[s][w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (k) {
      const long long pos = out + before + __popc(ballot & lanes_below);
      for (int c = 0; c < cols.ncols; ++c) cols.dst[c][pos] = cols.src[c][row];
    }
    out += total;
  }
}

}  // namespace

extern "C" {

int64_t a1t_compact_u64_tile_rows() { return kTileRows; }
int64_t a1t_compact_u64_max_cols() { return kMaxCols; }

// Compacts ncols (<= kMaxCols) 64-bit columns of n rows by mask (bool, one
// byte per row) into dsts[i][0 .. count), in row order; *count (int32) =
// kept rows. srcs and dsts are host arrays of ncols device pointers.
// status is device scratch of ntiles = ceil(n / tile_rows) + 1 words
// (the last one is the ticket), ALL ZERO at the launch. n must be > 0.
// Launches on `stream`, never synchronises, and returns
// cudaGetLastError().
int a1t_compact_u64(const void* mask, int64_t n, const void* const* srcs,
                    void* const* dsts, int64_t ncols, void* status,
                    void* count, void* stream) {
  if (ncols > kMaxCols || ncols < 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  ColumnSet set;
  set.ncols = static_cast<int>(ncols);
  for (int i = 0; i < set.ncols; ++i) {
    set.src[i] = static_cast<const unsigned long long*>(srcs[i]);
    set.dst[i] = static_cast<unsigned long long*>(dsts[i]);
  }
  auto* words = static_cast<unsigned long long*>(status);
  compact_u64_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, ntiles, set, words,
      words + ntiles, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
