// Fused predicate + projection compaction (K1), the flagship
// filter+project: keep rows where f > thresh and v > vthr, and emit
// (key, v * 2.0 + f) for them in row order.
//
// Replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/compaction_v15.py:compact_fused driven with the
// closure arrow1_tpu/kernels/fused_ops.py:flagship_filter_project. That
// kernel carried i64 as two i32 word planes, f64 as a float-float pair
// (kernels/dd.py), and sized its output window per grid step with a band
// and an overflow flag for a re-plan. Hopper has native i64 and f64, and
// this kernel places every kept row exactly, so none of that remains and
// there is no overflow to report.
//
// Bound on the H100: memory bytes. The least traffic is one read of key,
// v and f (24 bytes a row) and one write of 16 bytes a kept row; the
// arithmetic is one compare pair, one multiply and one add a row. The
// design reads each row once:
//
//   - persistent blocks, one an SM, take tiles of kTileRows rows from an
//     atomic ticket, one at a time;
//   - each tile's three columns are staged in shared memory with 16-byte
//     cp.async (8-byte copies for a column whose address is not 16-byte
//     aligned, a zero-filled half at a ragged end), in two buffers: the
//     next tile's loads are in flight while this tile is looked back,
//     compacted and written;
//   - a warp owns 32 * kRowsPerThread consecutive rows of the tile (lane l
//     reads rows l, l + 32, ...: no bank conflicts), ranks them with one
//     ballot a step, and one block scan of the warp totals ranks the
//     tile: one barrier, not one a step;
//   - the tile's output base comes from the decoupled look-back of
//     lookback.cuh, while the warps compact their kept keys and
//     projections in place in shared memory. A block counts and announces
//     the next tile as soon as it lands, before it writes this tile out,
//     so a later tile never waits on a write. The block then writes the
//     kept rows out contiguously, clipped at out_len.
//
// Rounding: the projection is written with __dmul_rn and __dadd_rn so
// that the compiler cannot contract it into a fused multiply-add. v * 2.0
// is exact, so an FMA could not change this projection, but the plain
// PyTorch version rounds after each operation and the kernel must round
// the same way for any projection a later lowering puts here.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

namespace lookback = a1t::lookback;

// One block an SM with two 96 KB buffers: on the H100 this beat two
// blocks an SM with half the tile, and rings of three or four buffers of
// smaller tiles (PERF.md).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kWarpRows = 32 * kRowsPerThread;
constexpr int kTileRows = kThreads * kRowsPerThread;     // 4096
constexpr int kStageBytes = 3 * kTileRows * 8;           // key, v, f
constexpr int kStages = 2;  // one buffer written out, one loading
constexpr int kSmemBytes = kStages * kStageBytes;        // 192 KB
constexpr unsigned kFullWarp = 0xffffffffu;

struct Inputs {
  const int64_t* key;
  const int64_t* v;
  const double* f;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Stage rows [first, first + rows) of one 8-byte column into dst.
__device__ __forceinline__ void stage_column(char* dst, const void* column,
                                             long long first, int rows) {
  const char* src = static_cast<const char*>(column) + first * 8;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = threadIdx.x; 2 * c < rows; c += kThreads) {
      const int bytes = rows - 2 * c >= 2 ? 16 : 8;
      cp_async16(dst + 16 * c, src + 16 * c, bytes);
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      cp_async8(dst + 8 * r, src + 8 * r);
    }
  }
}

__device__ __forceinline__ int tile_rows(long long tile, long long n) {
  const long long left = n - tile * kTileRows;
  return static_cast<int>(left < kTileRows ? left : kTileRows);
}

// Issue the copies of `tile` into `stage` (none for a tile past the end)
// and commit them as one group: every call commits one group.
__device__ __forceinline__ void stage_tile(char* stage, const Inputs& in,
                                           long long tile, long long ntiles,
                                           long long n) {
  if (tile < ntiles) {
    const long long first = tile * kTileRows;
    const int rows = tile_rows(tile, n);
    stage_column(stage, in.key, first, rows);
    stage_column(stage + kTileRows * 8, in.v, first, rows);
    stage_column(stage + 2 * kTileRows * 8, in.f, first, rows);
  }
  cp_async_commit();
}

// This thread's rows of a staged tile, in registers: key, projection and
// the warp's ballot of kept rows, step by step; `before` = kept rows of
// the warps before this one, `total` = kept rows of the tile.
struct Ranked {
  int64_t key[kRowsPerThread];
  double proj[kRowsPerThread];
  unsigned ballot[kRowsPerThread];
  int before;
  int total;
};

__device__ __forceinline__ void rank_tile(const char* stage, int rows,
                                          double thresh, long long vthr,
                                          int* s_warp, Ranked& t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t* skey = reinterpret_cast<const int64_t*>(stage);
  const int64_t* sv = skey + kTileRows;
  const double* sf = reinterpret_cast<const double*>(sv + kTileRows);
  int warp_kept = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = warp * kWarpRows + j * 32 + lane;
    const int64_t vv = sv[r];
    const double ff = sf[r];
    t.key[j] = skey[r];
    t.proj[j] = __dadd_rn(__dmul_rn(__ll2double_rn(vv), 2.0), ff);
    t.ballot[j] = __ballot_sync(kFullWarp,
                                r < rows && ff > thresh && vv > vthr);
    warp_kept += __popc(t.ballot[j]);
  }
  if (lane == 0) s_warp[warp] = warp_kept;
  __syncthreads();  // the warp totals are in
  t.before = 0;
  t.total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    t.before += w < warp ? c : 0;
    t.total += c;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
filter_project_kernel(Inputs in, long long n, long long ntiles,
                      double thresh, long long vthr,
                      int64_t* __restrict__ key_out,
                      double* __restrict__ proj_out, long long out_len,
                      unsigned long long* __restrict__ status,
                      unsigned long long* __restrict__ ticket,
                      int64_t* __restrict__ count) {
  extern __shared__ __align__(16) char smem[];
  __shared__ long long s_ring[kStages];  // the tile in each buffer
  __shared__ int s_warp[kWarps];
  __shared__ long long s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the first tile, counted and announced before the block takes another
  if (threadIdx.x == 0) {
    s_ring[0] = static_cast<long long>(atomicAdd(ticket, 1ull));
  }
  __syncthreads();
  long long tile = s_ring[0];
  if (tile >= ntiles) return;
  stage_tile(smem, in, tile, ntiles, n);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  Ranked t;
  rank_tile(smem, tile_rows(tile, n), thresh, vthr, s_warp, t);
  if (threadIdx.x == 0) lookback::announce(status, tile, t.total);

  for (int i = 0;; ++i) {
    const int cur = i % kStages;
    const int nxt = (i + 1) % kStages;
    char* stage = smem + cur * kStageBytes;
    // the next tile goes to the buffer the last one was written out of
    if (threadIdx.x == 0) {
      s_ring[nxt] = static_cast<long long>(atomicAdd(ticket, 1ull));
    }
    __syncthreads();
    const long long next = s_ring[nxt];
    stage_tile(smem + nxt * kStageBytes, in, next, ntiles, n);
    // compact the kept rows in place (a kept row's slot is never above
    // its own row) while the first warp looks back
    int64_t* skey = reinterpret_cast<int64_t*>(stage);
    double* sf = reinterpret_cast<double*>(stage + 2 * kTileRows * 8);
    int pos = t.before;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if ((t.ballot[j] >> lane) & 1u) {
        const int p = pos + __popc(t.ballot[j] & lanes_below);
        skey[p] = t.key[j];
        sf[p] = t.proj[j];
      }
      pos += __popc(t.ballot[j]);
    }
    const int kept = t.total;
    if (warp == 0) {
      const long long base = lookback::exclusive_prefix(status, tile, kept);
      if (lane == 0) {
        s_base = base;
        if (tile == ntiles - 1) *count = base + kept;
      }
    }
    __syncthreads();  // the compacted tile and its base are in
    const long long base = s_base;
    if (next < ntiles) {  // count and announce the next tile
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      rank_tile(smem + nxt * kStageBytes, tile_rows(next, n), thresh, vthr,
                s_warp, t);
      if (threadIdx.x == 0) lookback::announce(status, next, t.total);
    }
    for (int r = threadIdx.x; r < kept && base + r < out_len;
         r += kThreads) {
      key_out[base + r] = skey[r];
      proj_out[base + r] = sf[r];
    }
    if (next >= ntiles) break;  // tickets rise: every later one is past too
    tile = next;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace

extern "C" {

int64_t a1t_filter_project_tile_rows() { return kTileRows; }

// key, v: int64[n]; f: float64[n]; n > 0; any 8-byte alignment. Writes the
// kept rows' key and v * 2.0 + f to key_out/proj_out[0 .. min(count,
// out_len)) in row order and *count = kept rows. status is device scratch
// of ceil(n / tile_rows) + 1 words (the tile status words and the ticket),
// zeroed here on the stream. Launches on `stream`, never synchronises, and
// returns the CUDA error code.
int a1t_filter_project(const int64_t* key, const int64_t* v, const double* f,
                       int64_t n, double thresh, long long vthr,
                       int64_t* key_out, double* proj_out, int64_t out_len,
                       unsigned long long* status, int64_t* count,
                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // blocks that fit on the card at once, by device: the shared-memory
  // opt-in and the occupancy query are made once for each device
  static std::mutex mu;
  static int resident_by_dev[64] = {};
  int dev = 0;
  {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= 64) {
      return static_cast<int>(cudaErrorInvalidDevice);
    }
  }
  int resident = 0;
  {
    const std::lock_guard<std::mutex> lock(mu);
    if (resident_by_dev[dev] == 0) {
      int sms = 0, per_sm = 0;
      cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            filter_project_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, filter_project_kernel, kThreads, kSmemBytes);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) {
        return static_cast<int>(cudaErrorInvalidConfiguration);
      }
      resident_by_dev[dev] = sms * per_sm;
    }
    resident = resident_by_dev[dev];
  }
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  cudaError_t err = cudaMemsetAsync(
      status, 0, static_cast<size_t>(ntiles + 1) * sizeof(*status), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = ntiles < resident ? ntiles : resident;
  filter_project_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                          s>>>(Inputs{key, v, f}, n, ntiles, thresh, vthr,
                               key_out, proj_out, out_len, status,
                               status + ntiles, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
