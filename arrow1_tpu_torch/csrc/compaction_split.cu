// Split compaction of 64-bit columns by a bool mask: positions within each
// 1024-row tile (kernel A), then placement (kernel B).
//
// Replaces the JAX package's Pallas kernels
// arrow1_tpu/kernels/compaction_split.py:compact_split: _positions_kernel
// (a triangular matrix product per tile, since Mosaic has no cumsum) and
// _place_kernel (one-hot matrix products over 16-bit planes and a VMEM
// carry of partial tiles, flushed as aligned 1024-row DMAs in grid order).
// The split stays, because it is what this design is; between the kernels
// the per-tile bases are a cumsum over the tile counts in torch, as they
// were XLA glue in the reference. On Hopper:
//
//   kernel A  one block of 1024 threads per tile: a block-wide inclusive
//             scan of the mask (warp ballots, then a scan of the 32 warp
//             totals) writes pos[j] = inclusive count - 1 for every row;
//   kernel B  one block per tile: every kept row j of tile t goes straight
//             to bases[t] + pos[j], for every column in one launch. No
//             carry and no aligned flush: Hopper stores each row where it
//             belongs.
//
// Bound on the H100: memory bytes. Kernel A reads the mask and writes pos
// (1 + 4 bytes a row); kernel B reads the mask, pos and every column and
// writes each kept row. Materialising pos costs 8 bytes a row more than a
// kernel that recomputes ranks (compaction.cu, compact_u64.cu).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // the contract's tile: one thread a row
constexpr int kWarps = kTile / 32;
constexpr int kMaxCols = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

struct ColumnSet {  // passed by value: 516 bytes of kernel parameters
  const unsigned long long* src[kMaxCols];
  unsigned long long* dst[kMaxCols];
  int ncols;
};

__global__ void __launch_bounds__(kTile)
positions_kernel(const uint8_t* __restrict__ mask, int* __restrict__ pos) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kTile +
                        threadIdx.x;
  const bool k = mask[row] != 0;
  const unsigned ballot = __ballot_sync(kFullWarp, k);
  const int within = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the 32 warp totals
    int w = warp_tot[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullWarp, w, d);
      if (lane >= d) w += up;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  pos[row] = (warp ? warp_tot[warp - 1] : 0) + within - 1;
}

__global__ void __launch_bounds__(kTile)
place_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ pos,
             const int* __restrict__ bases, const ColumnSet cols) {
  const long long row = static_cast<long long>(blockIdx.x) * kTile +
                        threadIdx.x;
  if (mask[row] == 0) return;
  const long long dst = static_cast<long long>(bases[blockIdx.x]) + pos[row];
  for (int c = 0; c < cols.ncols; ++c) cols.dst[c][dst] = cols.src[c][row];
}

}  // namespace

extern "C" {

int64_t a1t_compaction_split_tile() { return kTile; }
int64_t a1t_compaction_split_max_cols() { return kMaxCols; }

// Kernel A: pos[j] (int32) = kept rows of j's tile up to and including j,
// minus 1, for all n rows; n must be a positive multiple of the tile.
int a1t_compaction_split_positions(const void* mask, int64_t n, void* pos,
                                   void* stream) {
  if (n <= 0 || n % kTile) return static_cast<int>(cudaErrorInvalidValue);
  positions_kernel<<<static_cast<unsigned>(n / kTile), kTile, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// Kernel B: each kept row j of tile t of ncols (<= kMaxCols) 64-bit
// columns goes to dsts[c][bases[t] + pos[j]]. bases: int32, one per tile
// (exclusive). srcs and dsts are host arrays of device pointers.
int a1t_compaction_split_place(const void* mask, int64_t n, const void* pos,
                               const void* bases, const void* const* srcs,
                               void* const* dsts, int64_t ncols,
                               void* stream) {
  if (n <= 0 || n % kTile || ncols < 0 || ncols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ColumnSet set;
  set.ncols = static_cast<int>(ncols);
  for (int i = 0; i < set.ncols; ++i) {
    set.src[i] = static_cast<const unsigned long long*>(srcs[i]);
    set.dst[i] = static_cast<unsigned long long*>(dsts[i]);
  }
  place_kernel<<<static_cast<unsigned>(n / kTile), kTile, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int*>(pos),
      static_cast<const int*>(bases), set);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
