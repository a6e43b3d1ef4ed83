// Two-pass, order-preserving stream compaction skeleton shared by the
// compaction kernel (compaction.cu) and the fused filter+project kernel
// (fused_filter_project.cu).
//
//   pass 1  count_block: each CTA counts the kept rows of its block of
//           kRowsPerBlock rows (warp ballots and popcounts).
//   scan    exclusive_scan_kernel: one CTA turns the per-block counts into
//           per-block output offsets and the total count, looping over
//           the counts kScanThreads at a time.
//   pass 2  rank_block: each CTA walks its block again, kThreads rows per
//           step, ranks every kept row (ballot, popcount of the lanes
//           below, warp totals in shared memory) and hands it to `emit`
//           with its output position base + rank.
//
// Rows are visited with consecutive threads on consecutive rows, so every
// load and store of a column is coalesced. The count never leaves the
// device. Nothing here synchronises with the host.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace a1t {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 4096;
constexpr int kSteps = kRowsPerBlock / kThreads;
constexpr int kScanThreads = 1024;
constexpr unsigned kFullWarp = 0xffffffffu;

inline int64_t num_blocks(int64_t n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// Pass 1: block_counts[blockIdx.x] = kept rows of this CTA's block.
template <class Keep>
__device__ __forceinline__ void count_block(int64_t n, const Keep& keep,
                                            int64_t* block_counts) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  int kept = 0;  // the same in every lane of the warp
  for (int step = 0; step < kSteps; ++step) {
    const int64_t row = first + step * kThreads + threadIdx.x;
    const bool k = row < n && keep(row);
    kept += __popc(__ballot_sync(kFullWarp, k));
  }
  if (lane == 0) warp_sums[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    block_counts[blockIdx.x] = total;
  }
}

// Exclusive scan of the block counts into offsets; *total = their sum.
// Launched with one CTA of kScanThreads threads.
__global__ void __launch_bounds__(kScanThreads)
exclusive_scan_kernel(const int64_t* __restrict__ counts, int64_t nblocks,
                      int64_t* __restrict__ offsets,
                      int64_t* __restrict__ total) {
  __shared__ int64_t warp_tot[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t start = 0; start < nblocks; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const int64_t v = i < nblocks ? counts[i] : 0;
    int64_t incl = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t up = __shfl_up_sync(kFullWarp, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp totals
      int64_t w = warp_tot[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t up = __shfl_up_sync(kFullWarp, w, d);
        if (lane >= d) w += up;
      }
      warp_tot[lane] = w;
    }
    __syncthreads();
    const int64_t excl = carry + (warp ? warp_tot[warp - 1] : 0) + incl - v;
    if (i < nblocks) offsets[i] = excl;
    __syncthreads();  // every thread has read carry and warp_tot
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Pass 2: emit(row, position) for every kept row of this CTA's block, in
// row order, positions starting at out_base. The warp totals are double
// buffered, so one barrier per step suffices: a buffer is written again
// two steps later, after every thread has passed the barrier between.
template <class Keep, class Emit>
__device__ __forceinline__ void rank_block(int64_t n, int64_t out_base,
                                           const Keep& keep,
                                           const Emit& emit) {
  __shared__ int warp_cnt[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  int64_t out = out_base;
  for (int step = 0; step < kSteps; ++step) {
    const int64_t row = first + step * kThreads + threadIdx.x;
    const bool k = row < n && keep(row);
    const unsigned ballot = __ballot_sync(kFullWarp, k);
    if (lane == 0) warp_cnt[step & 1][warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[step & 1][w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (k) emit(row, out + before + __popc(ballot & lanes_below));
    out += total;
  }
}

}  // namespace a1t
