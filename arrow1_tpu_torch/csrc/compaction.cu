// Order-preserving stream compaction by a bool mask (K2).
//
// Replaces the JAX package's Pallas compaction family behind
// arrow1_tpu/kernels/compaction_v4.py:compact (compact_v14, compact_v7,
// compact_v4, compact_v12). Those kernels route 32-bit word planes through
// lane butterflies and one-hot matrix products because the TPU has no
// scatter; Hopper stores each kept row straight to its position, so none
// of that is carried over.
//
// Bound on the H100: memory bytes. The least traffic is one read of the
// mask and of every column and one write of count x (sum of widths); this
// design reads the mask twice (once per pass), which at 1 byte per row
// against 8-byte columns costs a few percent. The arithmetic per row is a
// ballot and two popcounts. Every column of a call rides one pass-2
// launch (up to kMaxCols; more are taken kMaxCols at a time), so the mask
// is read twice per call, not twice per column.

#include "two_pass.cuh"

namespace {

using namespace a1t;

constexpr int kMaxCols = 64;

struct ColumnSet {  // passed by value: 1284 bytes of kernel parameters
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];
  int ncols;
};

struct MaskKeep {
  const uint8_t* mask;
  __device__ __forceinline__ bool operator()(int64_t row) const {
    return mask[row] != 0;
  }
};

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n,
             int64_t* __restrict__ block_counts) {
  count_block(n, MaskKeep{mask}, block_counts);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
               const int64_t* __restrict__ offsets, const ColumnSet cols,
               int64_t out_len) {
  rank_block(n, offsets[blockIdx.x], MaskKeep{mask},
             [&](int64_t row, int64_t pos) {
               if (pos >= out_len) return;
               for (int c = 0; c < cols.ncols; ++c) {
                 switch (cols.width[c]) {
                   case 8:
                     static_cast<uint64_t*>(cols.dst[c])[pos] =
                         static_cast<const uint64_t*>(cols.src[c])[row];
                     break;
                   case 4:
                     static_cast<uint32_t*>(cols.dst[c])[pos] =
                         static_cast<const uint32_t*>(cols.src[c])[row];
                     break;
                   case 2:
                     static_cast<uint16_t*>(cols.dst[c])[pos] =
                         static_cast<const uint16_t*>(cols.src[c])[row];
                     break;
                   default:
                     static_cast<uint8_t*>(cols.dst[c])[pos] =
                         static_cast<const uint8_t*>(cols.src[c])[row];
                 }
               }
             });
}

}  // namespace

extern "C" {

int64_t a1t_compact_rows_per_block() { return kRowsPerBlock; }

// Compacts ncols columns of n rows by mask (bool, one byte per row) into
// dsts[i][0 .. min(count, out_len)), in row order; *count = kept rows.
// srcs, dsts and widths are host arrays of ncols entries; widths are
// element sizes in bytes (1, 2, 4 or 8). block_counts and offsets are
// device scratch of num_blocks(n) int64 each. n must be > 0. Launches on
// `stream`, never synchronises, and returns cudaGetLastError().
int a1t_compact(const void* mask, int64_t n, const void* const* srcs,
                void* const* dsts, const int64_t* widths, int64_t ncols,
                int64_t out_len, int64_t* block_counts, int64_t* offsets,
                int64_t* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = num_blocks(n);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  count_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      m, n, block_counts);
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(block_counts, nblocks,
                                                   offsets, count);
  for (int64_t c0 = 0; c0 < ncols; c0 += kMaxCols) {
    ColumnSet set;
    set.ncols = static_cast<int>(ncols - c0 < kMaxCols ? ncols - c0
                                                       : kMaxCols);
    for (int i = 0; i < set.ncols; ++i) {
      set.src[i] = srcs[c0 + i];
      set.dst[i] = dsts[c0 + i];
      set.width[i] = static_cast<int>(widths[c0 + i]);
    }
    scatter_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
        m, n, offsets, set, out_len);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
