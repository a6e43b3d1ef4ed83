// Dense-group accumulators over a stream of group ids: K3 and segsum v1.
//
// K3, a1t_segment_sums, replaces the JAX package's Pallas kernel
// arrow1_tpu/kernels/segsum2.py:segment_sums_mxu: per group g < G, the
// number of rows (occupancy), and per column the number of live rows and
// the sum of the live values, exact mod 2^64. The TPU factors a one-hot
// matrix through base-128 digits, splits values into 8-bit planes and
// carries u32 pairs so that bf16/f32 products stay exact; Hopper has
// native integer atomics, so each row adds its value to its group directly
// and the wraparound of unsigned 64-bit addition is the mod 2^64. Integer
// addition commutes, so the result is the same bits in any order.
//
// segsum v1, a1t_segment_sum_count, replaces
// arrow1_tpu/kernels/segsum.py:segment_sum_count: f32 sums and f32 counts
// of the live rows per group. Its sums depend on the order of the
// atomics; its counts are exact below 2^24 per group.
//
// Bound on the H100: memory bytes. Each row reads its group id (4 bytes)
// and, per column, a value (8 bytes) and a live byte; the outputs are a
// few slots of G. K3's design:
//
//   - every thread takes four rows at a time: one 16-byte load of four
//     group ids, two of four values, one 4-byte load of four live bytes;
//   - warp aggregation: __match_any_sync finds the lanes that hold the same
//     group, the counts are popcounts of ballots, the sums a tree of
//     shuffles over those lanes, and one lane a group adds: a hot group
//     costs one atomic a warp, not 32. The match is slow (on the H100 it
//     cost more than the atomics it saves at G = 1024), so it runs only
//     in a warp where two lanes 1 or 16 apart hold one group;
//   - counts are 32-bit partials in shared memory (a launch sees fewer
//     than 2^32 rows), a private CTA's sums 64-bit (two 32-bit halves
//     and a carry), widened as they are flushed;
//   - three regimes, chosen by the caller from the shape alone
//     (kernels/segsum2.py:plan):
//       private: every CTA holds all G groups; the CTAs of a cluster add
//         their partials up over distributed shared memory, so one global
//         atomic per cluster per slot reaches the output;
//       owned: G is too large for one CTA; each CTA of a cluster (2, 4 or
//         8) owns 2^shift consecutive groups' counts, rows add their
//         counts into the owner's shared memory over the cluster (mapa,
//         red.shared::cluster.add.u32), and the owner flushes its range.
//         The sums go straight to the output with global atomics: the
//         card has no 64-bit add in shared memory, and one into a peer's
//         is a compare-and-swap loop across the cluster, slower than a
//         global atomic (PERF.md);
//       global: rows add straight into the output with global atomics.

#include <cstdint>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // segsum v1

namespace k3 {

constexpr int kThreads = 1024;
constexpr int kMaxCols = 32;
constexpr int kMaxCounts = kMaxCols + 1;
constexpr unsigned kFullWarp = 0xffffffffu;

enum Mode : int { kPrivate = 0, kOwned = 1, kGlobal = 2 };

struct Columns {  // passed by value: 1044 bytes of kernel parameters
  const int64_t* vals[kMaxCols];  // nullptr: count-only column
  const uint8_t* live[kMaxCols];  // nullptr: every row is live
  int cnt[kMaxCols];              // count slot of the live count, or -1
  int sum[kMaxCols];              // sum slot, or -1
  int cnt_out[kMaxCounts];        // count slot -> row of the output
  int sum_out[kMaxCols];          // sum slot -> row of the output
  int ncols;
  int ncnt;
  int nsum;
  int occ;                        // count slot of the occupancy, or -1
};

// Four consecutive rows of one column: values (0 past the end or where
// the column has none) and live bits.
struct Quad {
  unsigned long long v[4];
  unsigned live;
};

__device__ __forceinline__ Quad load_quad(const Columns& cs, int c,
                                          long long q, long long n) {
  Quad x;
  const int64_t* vals = cs.vals[c];
  const uint8_t* live = cs.live[c];
  const long long row0 = 4 * q;
  if (row0 + 4 <= n) {
    if (vals != nullptr) {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(vals) +
                                2 * q);
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(vals) +
                                2 * q + 1);
      x.v[0] = a.x;
      x.v[1] = a.y;
      x.v[2] = b.x;
      x.v[3] = b.y;
    }
    x.live = 0xfu;
    if (live != nullptr) {
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(live) + q);
      x.live = (m.x != 0) | (m.y != 0) << 1 | (m.z != 0) << 2 |
               (m.w != 0) << 3;
    }
  } else {
    x.live = 0;
    for (int j = 0; j < 4; ++j) {
      const long long row = row0 + j;
      const bool in = row < n;
      x.v[j] = in && vals != nullptr ? vals[row] : 0;
      x.live |= static_cast<unsigned>(
                    in && (live == nullptr || live[row] != 0)) << j;
    }
  }
  if (vals == nullptr) {
    for (int j = 0; j < 4; ++j) x.v[j] = 0;
  }
  return x;
}

// The sum of x over the lanes in `peers` (the lanes that hold one group),
// in the lowest of them: a tree of shuffles, one step a level, none when
// every lane's group is its own. All 32 lanes call it.
__device__ __forceinline__ unsigned long long sum_peers(
    unsigned peers, unsigned long long x) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFullWarp, above != 0)) {
    const int next = above ? __ffs(above) - 1 : lane;
    const unsigned long long t = __shfl_sync(kFullWarp, x, next);
    if (above) x += t;
    // the lanes of odd rank have handed their sums down: drop them
    above &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
  return x;
}

// Adds with no return value: into a peer's shared memory in the cluster
// (mapa, then red.shared::cluster), and into global memory.
__device__ __forceinline__ void red_peer(unsigned* p, int rank, unsigned v) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;" : "+r"(a) : "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;"
               :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void red_global(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// A 64-bit add into this CTA's shared memory as two native 32-bit adds
// (the card has no 64-bit shared add; the compiler's is a compare-and-swap
// loop): the low half's old value gives its carry into the high half.
__device__ __forceinline__ void add_local(unsigned long long* p,
                                          unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, static_cast<unsigned>(v >> 32) + (old + lo < old));
}

// Sum slots a CTA keeps in shared memory: the private regime's; the owned
// regime adds its sums straight into the output.
template <int kMode>
__host__ __device__ __forceinline__ int smem_sums(const Columns& cs) {
  return kMode == kPrivate ? cs.nsum : 0;
}

template <int kMode>
struct Accumulators {
  unsigned long long* sums;  // private: [nsum][groups], shared memory
  unsigned* counts;          // private, owned: [ncnt][groups], shared
  unsigned long long* out;   // [rows of the output][G]
  long long G;
  int groups;                // groups a CTA holds
  int shift;                 // owned: log2(groups)

  __device__ __forceinline__ void add_count(const Columns& cs, int slot,
                                            int g, unsigned v) const {
    if (kMode == kPrivate) {
      atomicAdd(counts + slot * groups + g, v);
    } else if (kMode == kOwned) {
      red_peer(counts + slot * groups + (g & (groups - 1)), g >> shift, v);
    } else {
      red_global(out + cs.cnt_out[slot] * G + g, v);
    }
  }

  __device__ __forceinline__ void add_sum(const Columns& cs, int slot, int g,
                                          unsigned long long v) const {
    if (kMode == kPrivate) {
      add_local(sums + slot * groups + g, v);
    } else {
      red_global(out + cs.sum_out[slot] * G + g, v);
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
segment_sums_kernel(const int32_t* __restrict__ gid, long long n, int G,
                    int groups, int shift, const Columns cs,
                    unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long acc[];
  const int nsum_smem = smem_sums<kMode>(cs);
  Accumulators<kMode> a{acc,
                        reinterpret_cast<unsigned*>(acc + nsum_smem * groups),
                        out, G, groups, shift};
  if (kMode != kGlobal) {
    for (int i = threadIdx.x; i < nsum_smem * groups; i += kThreads) {
      a.sums[i] = 0ull;
    }
    for (int i = threadIdx.x; i < cs.ncnt * groups; i += kThreads) {
      a.counts[i] = 0u;
    }
    // every CTA's slots are zero before any CTA of the cluster adds
    cg::this_cluster().sync();
  }

  const int lane = threadIdx.x & 31;
  const long long nquads = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // a warp takes 32 consecutive quads; every lane of it runs every step
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       q - lane < nquads; q += stride) {
    int g[4];
    if (4 * q + 4 <= n) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(gid) + q);
      g[0] = x.x;
      g[1] = x.y;
      g[2] = x.z;
      g[3] = x.w;
    } else {
      for (int j = 0; j < 4; ++j) g[j] = 4 * q + j < n ? gid[4 * q + j] : -1;
    }
    Quad cur = cs.ncols > 0 ? load_quad(cs, 0, q, n) : Quad{};
    unsigned peers[4];
    unsigned lead = 0;  // bit j: this lane adds row j's group
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (g[j] < 0 || g[j] >= G) g[j] = -1;  // dead rows count nowhere
      // __match_any_sync is slow, so a cheap test first: a warp whose
      // lanes 1 and 16 apart never hold one group goes without it (a
      // group that many rows hold trips the test nearly always)
      const int g1 = __shfl_xor_sync(kFullWarp, g[j], 1);
      const int g16 = __shfl_xor_sync(kFullWarp, g[j], 16);
      const bool dup = __any_sync(kFullWarp,
                                  g[j] >= 0 && (g[j] == g1 || g[j] == g16));
      peers[j] = dup ? __match_any_sync(kFullWarp, g[j]) : 1u << lane;
      lead |= static_cast<unsigned>(g[j] >= 0 &&
                                    lane == __ffs(peers[j]) - 1) << j;
    }
    if (cs.occ >= 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((lead >> j) & 1u) a.add_count(cs, cs.occ, g[j], __popc(peers[j]));
      }
    }
    for (int c = 0; c < cs.ncols; ++c) {
      // the next column's loads are in flight while this one adds
      const Quad nxt = c + 1 < cs.ncols ? load_quad(cs, c + 1, q, n) : Quad{};
      const int cnt_slot = cs.cnt[c];
      const int sum_slot = cs.sum[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = g[j] >= 0 && ((cur.live >> j) & 1u);
        if (cnt_slot >= 0) {
          const unsigned n_live =
              __popc(peers[j] & __ballot_sync(kFullWarp, live));
          if (((lead >> j) & 1u) && n_live) {
            a.add_count(cs, cnt_slot, g[j], n_live);
          }
        }
        if (sum_slot >= 0) {
          const unsigned long long s = sum_peers(peers[j],
                                                 live ? cur.v[j] : 0ull);
          if (((lead >> j) & 1u) && s) a.add_sum(cs, sum_slot, g[j], s);
        }
      }
      cur = nxt;
    }
  }

  if (kMode == kGlobal) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every add of the cluster has landed
  const int rank = static_cast<int>(cluster.block_rank());
  int lo, hi;
  if (kMode == kPrivate) {  // CTA r adds up its share of the groups
    const int per = (G + cluster.num_blocks() - 1) / cluster.num_blocks();
    lo = rank * per;
    hi = lo + per < G ? lo + per : G;
  } else {                  // CTA r owns its groups' totals already
    lo = rank << shift;
    hi = lo + groups < G ? lo + groups : G;
  }
  const int nsrc = kMode == kPrivate ? cluster.num_blocks() : 1;
  const int base = kMode == kPrivate ? 0 : lo;  // of this CTA's slots
  for (int k = 0; k < nsum_smem; ++k) {
    for (int g = lo + threadIdx.x; g < hi; g += kThreads) {
      unsigned long long t = 0;
      for (int r = 0; r < nsrc; ++r) {
        const unsigned long long* src = a.sums + k * groups + g - base;
        t += kMode == kPrivate ? *cluster.map_shared_rank(src, r) : *src;
      }
      if (t) red_global(out + cs.sum_out[k] * a.G + g, t);
    }
  }
  for (int k = 0; k < cs.ncnt; ++k) {
    for (int g = lo + threadIdx.x; g < hi; g += kThreads) {
      unsigned long long t = 0;
      for (int r = 0; r < nsrc; ++r) {
        const unsigned* src = a.counts + k * groups + g - base;
        t += kMode == kPrivate ? *cluster.map_shared_rank(src, r) : *src;
      }
      if (t) red_global(out + cs.cnt_out[k] * a.G + g, t);
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  if (kMode == kPrivate) cluster.sync();
}

// The clusters of `cfg`'s shape that fit the card at once, asked of the
// runtime once per device, cluster size and shared memory (a query costs
// tens of microseconds a call); the kernel's shared-memory opt-in is
// raised to the largest asked for, never lowered.
template <int kMode>
cudaError_t resident_clusters(const cudaLaunchConfig_t& cfg, int* resident) {
  struct Fit {
    int dev;
    unsigned cluster;
    size_t smem;
    int resident;
  };
  static std::mutex mu;
  static Fit seen[32];
  static int nseen = 0;
  static size_t smem_set[64] = {};  // the opt-in, by device
  const std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const unsigned cluster = cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < nseen; ++i) {
    if (seen[i].dev == dev && seen[i].cluster == cluster &&
        seen[i].smem == cfg.dynamicSmemBytes) {
      *resident = seen[i].resident;
      return cudaSuccess;
    }
  }
  auto kernel = segment_sums_kernel<kMode>;
  if (cfg.dynamicSmemBytes > 48 * 1024 &&
      cfg.dynamicSmemBytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
    smem_set[dev] = cfg.dynamicSmemBytes;
  }
  err = cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
  if (err == cudaSuccess && nseen < 32) {
    seen[nseen++] = {dev, cluster, cfg.dynamicSmemBytes, *resident};
  }
  return err;
}

template <int kMode>
cudaError_t launch(long long n, int G, int cluster, int groups, int shift,
                   const int32_t* gid, const Columns& cs,
                   unsigned long long* out, cudaStream_t s) {
  auto kernel = segment_sums_kernel<kMode>;
  const size_t smem =
      kMode == kGlobal ? 0
                       : static_cast<size_t>(groups) *
                             (8 * smem_sums<kMode>(cs) + 4 * cs.ncnt);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // as many clusters as stay resident on the card, no more than the rows
  // need (a warp's lane takes one quad of rows a step)
  int resident = 0;
  cudaError_t err = resident_clusters<kMode>(cfg, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long need = (blocks + cluster - 1) / cluster;
  cfg.gridDim = dim3(static_cast<unsigned>(
      (need < resident ? need : resident) * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, gid, n, G, groups, shift, cs, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace k3

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

}  // namespace

extern "C" {

// Shared memory (bytes) one CTA may opt in to on the current device: the
// budget of kernels/segsum2.py:plan.
int a1t_segment_sums_smem_optin(int64_t* bytes) {
  size_t optin = 0;
  const cudaError_t err = smem_optin(&optin);
  *bytes = static_cast<int64_t>(optin);
  return static_cast<int>(err);
}

// K3, one launch of at most 32 columns over rows [0, n), n > 0 and below
// 2^32. gid: int32[n], 16-byte aligned; rows with gid outside [0, G)
// count nowhere. For column i (host arrays of ncols entries): vals[i] is
// int64[n] (16-byte aligned) or null (count-only), live[i] bool[n]
// (4-byte aligned) or null (all live), cnt[i] its count slot or -1, sum[i]
// its sum slot or -1. cnt_out[k] / sum_out[k]: the row of `out` that count
// / sum slot k adds into; occ: the count slot of the occupancy or -1.
// `out` is a device uint64 [rows, G] buffer the launch adds into. mode,
// cluster, groups and shift are kernels/segsum2.py:plan's: private (0;
// groups = G), owned (1; groups = 2^shift a CTA, cluster * groups >= G)
// or global (2; cluster 1).
// Launches on `stream`, never synchronises; returns the CUDA error code.
int a1t_segment_sums(const int32_t* gid, int64_t n, int64_t G, int64_t mode,
                     int64_t cluster, int64_t groups, int64_t shift,
                     const int64_t* const* vals, const uint8_t* const* live,
                     const int64_t* cnt, const int64_t* sum, int64_t ncols,
                     const int64_t* cnt_out, int64_t ncnt,
                     const int64_t* sum_out, int64_t nsum, int64_t occ,
                     unsigned long long* out, void* stream) {
  using namespace k3;
  if (n <= 0 || n >= (1ll << 32) || G <= 0 || G > INT32_MAX ||
      ncols < 0 || ncols > kMaxCols || ncnt < 0 || ncnt > kMaxCounts ||
      nsum < 0 || nsum > kMaxCols || cluster < 1 || cluster > 8 ||
      shift < 0 || shift > 30 ||
      (mode == kOwned && (groups != (1ll << shift) ||
                          cluster * groups < G)) ||
      (mode == kPrivate && groups != G) ||
      (mode == kGlobal && cluster != 1) || mode < 0 || mode > kGlobal ||
      occ < -1 || occ >= ncnt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int64_t i = 0; i < ncols; ++i) {
    if (cnt[i] < -1 || cnt[i] >= ncnt || sum[i] < -1 || sum[i] >= nsum) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Columns cs = {};
  cs.ncols = static_cast<int>(ncols);
  cs.ncnt = static_cast<int>(ncnt);
  cs.nsum = static_cast<int>(nsum);
  cs.occ = static_cast<int>(occ);
  for (int i = 0; i < cs.ncols; ++i) {
    cs.vals[i] = vals[i];
    cs.live[i] = live[i];
    cs.cnt[i] = static_cast<int>(cnt[i]);
    cs.sum[i] = static_cast<int>(sum[i]);
  }
  for (int k = 0; k < cs.ncnt; ++k) {
    cs.cnt_out[k] = static_cast<int>(cnt_out[k]);
  }
  for (int k = 0; k < cs.nsum; ++k) {
    cs.sum_out[k] = static_cast<int>(sum_out[k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(G);
  const int c = static_cast<int>(cluster);
  const int gr = static_cast<int>(groups);
  const int sh = static_cast<int>(shift);
  const cudaError_t err =
      mode == kPrivate
          ? launch<kPrivate>(n, g, c, gr, sh, gid, cs, out, s)
      : mode == kOwned
          ? launch<kOwned>(n, g, c, gr, sh, gid, cs, out, s)
          : launch<kGlobal>(n, g, c, gr, sh, gid, cs, out, s);
  return static_cast<int>(err);
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
