// Single-pass decoupled look-back over tiles, shared by the one-pass
// compactions (compact_u64.cu, fused_filter_project.cu).
//
// A block takes each tile from an atomic ticket (never from blockIdx), so
// it only ever waits on tiles that blocks already running hold: no
// deadlock, whatever the schedule. Once it knows the tile's aggregate (its
// kept rows), it
//
//   1. stores (AGGREGATE, count), flag and value packed in ONE 64-bit
//      status word, with release semantics (tile 0 stores its inclusive
//      prefix at once): announce();
//   2. reads the words of the 32 tiles before it with acquire loads
//      (never hoisted out of the spin loop) and sums them back to the
//      nearest one that holds an inclusive prefix: exclusive_prefix(),
//      by one warp;
//   3. stores (INCLUSIVE, prefix + count) and returns the exclusive
//      prefix in every lane of that warp.
//
// publish() does all three. A tile taken but not yet announced holds up
// every later tile, so a block takes a ticket only for the tile it will
// count next, and announces it as soon as it is counted: taking several
// tickets at once chains the blocks' look-backs one behind another.
// The status words and the ticket must be zero when the kernel starts.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace a1t {
namespace lookback {

// status word: flag in the top two bits, the count or prefix below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagInclusive = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

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

// Step 1: one lane stores this tile's aggregate (tile 0: its inclusive
// prefix).
__device__ __forceinline__ void announce(unsigned long long* status,
                                         long long tile,
                                         long long aggregate) {
  store_release(status + tile,
                (tile == 0 ? kFlagInclusive : kFlagAggregate) |
                    static_cast<unsigned long long>(aggregate));
}

// Steps 2 and 3, by all 32 lanes of one warp once announce() has run for
// `tile`: the exclusive prefix of `tile`, in every lane. Lane i looks at
// tile - 1 - i - window.
__device__ __forceinline__ long long exclusive_prefix(
    unsigned long long* status, long long tile, long long aggregate) {
  constexpr unsigned kFullWarp = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (tile == 0) return 0;
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
    const unsigned incl = __ballot_sync(
        kFullWarp, (word >> 62) == (kFlagInclusive >> 62));
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

// All three steps, by one whole warp.
__device__ __forceinline__ long long publish(unsigned long long* status,
                                             long long tile,
                                             long long aggregate) {
  if ((threadIdx.x & 31) == 0) announce(status, tile, aggregate);
  __syncwarp();
  return exclusive_prefix(status, tile, aggregate);
}

}  // namespace lookback
}  // namespace a1t
