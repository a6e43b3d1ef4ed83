// Dense-group accumulators over a stream of group ids: K3 and segsum v1.
//
// K3, a1t_segment_sums, replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/segsum2.py:segment_sums_mxu: per group g < G, the
// number of rows (occupancy), and per column the number of live rows and
// the sum of the live values, exact mod 2^64. The TPU factors a one-hot
// matrix through base-128 digits, splits values into 8-bit planes and
// carries u32 pairs so that bf16/f32 products stay exact; Hopper has
// native 64-bit integer atomics, so each row adds its value to its group
// directly and the wraparound of unsigned 64-bit addition is the mod 2^64.
// Integer addition commutes, so the result is the same in any order.
//
// segsum v1, a1t_segment_sum_count, replaces
// arrow1_tpu/kernels/segsum.py:segment_sum_count: f32 sums and f32 counts
// of the live rows per group. Its sums depend on the order of the
// atomics; its counts are exact below 2^24 per group.
//
// Bound on the H100: memory bytes. Each row reads its group id (4 bytes)
// and, per column, a value (8 bytes) and a live byte; the outputs are a
// few slots of G. Design: while G x slots fits the block's shared memory
// (up to the card's opt-in limit, 227 KB on the H100), every block keeps
// private accumulators there, grid-strides over its rows with shared
// atomics, and flushes its nonzero slots into the output with global
// atomics. Larger G adds straight into global memory (the L2 atomics).
// Hot groups serialise on their shared-memory slot; warp-aggregated
// atomics are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 32;
constexpr int kMaxSlots = 2 * kMaxCols + 1;

struct ColumnSet {  // passed by value: 1040 bytes of kernel parameters
  const int64_t* vals[kMaxCols];  // nullptr: count-only column
  const uint8_t* live[kMaxCols];  // nullptr: every row is live
  int cnt_slot[kMaxCols];         // local slot of the live count, or -1
  int sum_slot[kMaxCols];         // local slot of the sum, or -1
  int out_slot[kMaxSlots];        // local slot -> row of the output
  int ncols;
  int nslots;
  int occ_slot;                   // local slot of the occupancy, or -1
};

template <bool kPrivate>
__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const int32_t* __restrict__ gid, int64_t n, int64_t G,
                    const ColumnSet cs,
                    unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  if (kPrivate) {
    for (int64_t i = threadIdx.x; i < cs.nslots * G; i += blockDim.x)
      acc[i] = 0ull;
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < n; row += stride) {
    const int64_t g = gid[row];
    if (g < 0 || g >= G) continue;  // dead rows count nowhere
    auto add = [&](int slot, unsigned long long v) {
      if (kPrivate)
        atomicAdd(&acc[slot * G + g], v);
      else
        atomicAdd(&out[cs.out_slot[slot] * G + g], v);
    };
    if (cs.occ_slot >= 0) add(cs.occ_slot, 1ull);
    for (int c = 0; c < cs.ncols; ++c) {
      if (cs.live[c] != nullptr && cs.live[c][row] == 0) continue;
      if (cs.cnt_slot[c] >= 0) add(cs.cnt_slot[c], 1ull);
      if (cs.sum_slot[c] >= 0)
        add(cs.sum_slot[c], static_cast<unsigned long long>(cs.vals[c][row]));
    }
  }
  if (kPrivate) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < cs.nslots * G; i += blockDim.x) {
      const unsigned long long v = acc[i];
      if (v != 0ull) atomicAdd(&out[cs.out_slot[i / G] * G + i % G], v);
    }
  }
}

template <bool kPrivate>
__global__ void __launch_bounds__(kThreads)
segment_sum_count_kernel(const int32_t* __restrict__ gid,
                         const float* __restrict__ vals,
                         const uint8_t* __restrict__ live, int64_t n,
                         int64_t G, float* __restrict__ sums,
                         float* __restrict__ counts) {
  extern __shared__ float facc[];  // [sums G | counts G]
  if (kPrivate) {
    for (int64_t i = threadIdx.x; i < 2 * G; i += blockDim.x) facc[i] = 0.f;
    __syncthreads();
  }
  float* s = kPrivate ? facc : sums;
  float* c = kPrivate ? facc + G : counts;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < n; row += stride) {
    const int64_t g = gid[row];
    if (g < 0 || g >= G || live[row] == 0) continue;
    atomicAdd(&s[g], vals[row]);
    atomicAdd(&c[g], 1.f);
  }
  if (kPrivate) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < G; i += blockDim.x) {
      if (facc[G + i] != 0.f) {
        atomicAdd(&sums[i], facc[i]);
        atomicAdd(&counts[i], facc[G + i]);
      }
    }
  }
}

// Blocks for a grid-stride launch: as many as stay resident on the card
// (by the occupancy calculator at this shared-memory size), no more than
// the rows need.
template <typename Kernel>
int grid_for(Kernel kernel, int64_t n, size_t smem, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
  if (*err != cudaSuccess) return 0;
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  return static_cast<int>(need < resident ? need : resident);
}

// Shared memory a block may opt in to on the current device.
cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  *bytes = static_cast<size_t>(optin);
  return err;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int64_t n, size_t smem, cudaStream_t s,
                   const int32_t* gid, int64_t G, const ColumnSet& cs,
                   unsigned long long* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = grid_for(kernel, n, smem, &err);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(gid, n, G, cs, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. gid: int32[n]; rows with gid outside [0, G) count nowhere. For
// column i (host arrays of ncols entries): vals[i] is int64[n] or null
// (count-only), live[i] is bool[n] or null (all live), cnt_slot[i] and
// sum_slot[i] are rows of `out` or -1. `out` is a zeroed device uint64
// [nslots, G] buffer whose row 0 receives the occupancy. Columns are taken
// kMaxCols at a time; each launch adds its slots into `out`. n > 0, G > 0.
// Launches on `stream`, never synchronises; returns the CUDA error code.
int a1t_segment_sums(const int32_t* gid, int64_t n, int64_t G,
                     const int64_t* const* vals,
                     const uint8_t* const* live, const int64_t* cnt_slot,
                     const int64_t* sum_slot, int64_t ncols,
                     unsigned long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t c0 = 0;
  do {  // the first launch also counts the occupancy (ncols may be 0)
    ColumnSet cs;
    const int64_t take = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    cs.ncols = static_cast<int>(take);
    cs.nslots = 0;
    cs.occ_slot = -1;
    if (c0 == 0) {
      cs.occ_slot = cs.nslots;
      cs.out_slot[cs.nslots++] = 0;
    }
    for (int i = 0; i < cs.ncols; ++i) {
      const int64_t c = c0 + i;
      cs.vals[i] = vals[c];
      cs.live[i] = live[c];
      cs.cnt_slot[i] = -1;
      cs.sum_slot[i] = -1;
      if (cnt_slot[c] >= 0) {
        cs.cnt_slot[i] = cs.nslots;
        cs.out_slot[cs.nslots++] = static_cast<int>(cnt_slot[c]);
      }
      if (sum_slot[c] >= 0) {
        cs.sum_slot[i] = cs.nslots;
        cs.out_slot[cs.nslots++] = static_cast<int>(sum_slot[c]);
      }
    }
    const size_t smem = static_cast<size_t>(cs.nslots) *
                        static_cast<size_t>(G) * sizeof(unsigned long long);
    if (cs.nslots > 0) {
      err = smem <= optin
                ? launch(segment_sums_kernel<true>, n, smem, s, gid, G, cs,
                         out)
                : launch(segment_sums_kernel<false>, n, 0, s, gid, G, cs,
                         out);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    c0 += take;
  } while (c0 < ncols);
  return static_cast<int>(cudaGetLastError());
}

// segsum v1. gid: int32[n], vals: float32[n], live: bool[n]; rows with gid
// outside [0, G) or not live count nowhere. sums and counts: zeroed
// float32[G] on the device. n > 0, G > 0. Launches on `stream`, never
// synchronises; returns the CUDA error code.
int a1t_segment_sum_count(const int32_t* gid, const float* vals,
                          const uint8_t* live, int64_t n, int64_t G,
                          float* sums, float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(G) * sizeof(float);
  const bool priv = smem <= optin;
  void (*kernel)(const int32_t*, const float*, const uint8_t*, int64_t,
                 int64_t, float*, float*) =
      priv ? &segment_sum_count_kernel<true>
           : &segment_sum_count_kernel<false>;
  const size_t bytes = priv ? smem : 0;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = grid_for(kernel, n, bytes, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, s>>>(gid, vals, live, n, G, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
