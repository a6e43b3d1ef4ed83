// Fused predicate + projection compaction (K1), the flagship
// filter+project: keep rows where f > thresh and v > vthr, and emit
// (key, v * 2.0 + f) for them in row order.
//
// Replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/compaction_v15.py:compact_fused driven with the
// closure arrow1_tpu/kernels/fused_ops.py:flagship_filter_project. That
// kernel carried i64 as two i32 word planes, f64 as a float-float pair
// (kernels/dd.py), and sized its output window per grid step with a band
// and an overflow flag for a re-plan. Hopper has native i64 and f64 and
// this kernel sizes its output exactly (pass 1 counts, a scan places each
// block), so none of that remains and there is no overflow to report.
//
// Bound on the H100: memory bytes. The least traffic is one read of key,
// v and f (24 bytes a row) and one write of 16 bytes a kept row. This
// design reads v and f once more in pass 1 (16 bytes a row) to count
// before it places. The arithmetic is one compare pair, one multiply and
// one add a row.
//
// Rounding: the projection is written with __dmul_rn and __dadd_rn so
// that the compiler cannot contract it into a fused multiply-add. v * 2.0
// is exact, so an FMA could not change this projection, but the plain
// PyTorch version rounds after each operation and the kernel must round
// the same way for any projection a later lowering puts here.

#include "two_pass.cuh"

namespace {

using namespace a1t;

struct FlagshipKeep {
  const int64_t* v;
  const double* f;
  double thresh;
  long long vthr;
  __device__ __forceinline__ bool operator()(int64_t row) const {
    return f[row] > thresh && v[row] > vthr;
  }
};

__global__ void __launch_bounds__(kThreads)
count_kernel(FlagshipKeep keep, int64_t n, int64_t* __restrict__ counts) {
  count_block(n, keep, counts);
}

__global__ void __launch_bounds__(kThreads)
project_kernel(FlagshipKeep keep, const int64_t* __restrict__ key,
               int64_t n, const int64_t* __restrict__ offsets,
               int64_t* __restrict__ key_out,
               double* __restrict__ proj_out, int64_t out_len) {
  rank_block(n, offsets[blockIdx.x], keep, [&](int64_t row, int64_t pos) {
    if (pos >= out_len) return;
    key_out[pos] = key[row];
    proj_out[pos] = __dadd_rn(
        __dmul_rn(__ll2double_rn(keep.v[row]), 2.0), keep.f[row]);
  });
}

}  // namespace

extern "C" {

int64_t a1t_filter_project_rows_per_block() { return kRowsPerBlock; }

// key, v: int64[n]; f: float64[n]; n > 0. Writes the kept rows' key and
// v * 2.0 + f to key_out/proj_out[0 .. min(count, out_len)) in row order
// and *count = kept rows. block_counts and offsets are device scratch of
// num_blocks(n) int64 each. Launches on `stream`, never synchronises, and
// returns cudaGetLastError().
int a1t_filter_project(const int64_t* key, const int64_t* v, const double* f,
                       int64_t n, double thresh, long long vthr,
                       int64_t* key_out, double* proj_out, int64_t out_len,
                       int64_t* block_counts, int64_t* offsets,
                       int64_t* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = num_blocks(n);
  const FlagshipKeep keep{v, f, thresh, vthr};
  count_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      keep, n, block_counts);
  exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(block_counts, nblocks,
                                                   offsets, count);
  project_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
      keep, key, n, offsets, key_out, proj_out, out_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
