// Measurement kernels for K7 (daft_segment_sum_float_planes in
// daft_tpu_torch/ops/csrc/segment_reduce.cu). Nothing here is on a query's
// path: tier_timings.py and chip_smoke.py build this file on their own and
// time it beside the package's kernels, on the card.
//
// - k7_atomic_rate_kernel: the card's rate of f64 atomic adds at one shape,
//   into device memory (native reductions, K7's global tier) or into a
//   shared-memory table (compare-and-swap loops, K7's block tier). It is a
//   floor of a design that makes one such add per kept nonzero value, not a
//   bound of the function.
// - k7_cluster_kernel: two designs for K7's block tier that read the codes
//   once for every plane. A thread block cluster of G blocks takes each tile
//   of 3968 codes (4 for each consumer thread) by one bulk copy multicast to
//   all G blocks (each block issues a G-th of the tile for all of them),
//   through a ring of 2 to 8 stages (what fits beside the tables) whose
//   slots the G blocks free together (each consumer warp of each block
//   arrives on every block's `empty` barrier). kByRange false: block r holds
//   plane group r's tables (plane-major, cap entries a plane) and loads only
//   its planes' values. kByRange true: block r holds codes [r * width, (r +
//   1) * width) of every plane, entry-major (code, then plane), and loads
//   every plane's values for the rows with a code in its range. Both add by
//   shared-memory f64 atomics and write a partial table per block, which a
//   second launch adds in a fixed order into the output. Planes are f32, and
//   the codes and planes 16-byte aligned with n a multiple of 4 (the shapes
//   timed); anything else is refused.
// - k7_split_kernel: the block tier with both atomic units at work: the
//   codes below `split` add into the block's shared-memory table
//   (compare-and-swap loops), the rest into the output by native
//   device-memory reductions, which run beside them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kPlaneChunk = 64;
constexpr int kConsumers = kThreads - 32;  // warp 0 issues the copies
constexpr int kTile = kConsumers * 4;      // codes a stage holds: 4 a consumer
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 232448;
constexpr size_t kStageBytes = static_cast<size_t>(kTile) * 4;
constexpr size_t kReserve = 1024;  // the static barriers' shared memory

struct Ptrs {
  const float* p[kPlaneChunk];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// an arrival on the barrier at bar's offset in block `rank` of the cluster
__device__ __forceinline__ void bar_arrive_remote(unsigned long long* bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from src into dst of every block in `mask`, completing on each
// block's barrier at bar's offset
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, unsigned bytes,
                                               unsigned long long* bar, unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

template <bool kByRange>
__global__ void __launch_bounds__(kThreads, 1)
k7_cluster_kernel(const __grid_constant__ Ptrs planes, const int32_t* __restrict__ codes,
                  double* __restrict__ part, long long n, int cap, int nplanes, int group,
                  int width, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  __shared__ __align__(8) unsigned long long empty[kMaxStages];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = static_cast<unsigned>(cluster.block_rank());
  const unsigned g = static_cast<unsigned>(cluster.num_blocks());
  const int clusters = gridDim.x / g;
  const int cid = blockIdx.x / g;
  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  double* tab = reinterpret_cast<double*>(smem + stages * kStageBytes);
  // this block's planes and codes
  const int j0 = kByRange ? 0 : static_cast<int>(rank) * group;
  const int gp = kByRange ? nplanes : min(group, nplanes - j0);
  const int lo = kByRange ? static_cast<int>(rank) * width : 0;
  const int hi = kByRange ? min(cap, lo + width) : cap;
  const int entries = kByRange ? width * nplanes : group * cap;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tab[i] = 0.0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], g * (kConsumers / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  const long long tiles = (n + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    if (threadIdx.x == 0) {
      const unsigned short mask = static_cast<unsigned short>((1u << g) - 1);
      int k = 0;
      for (long long t = cid; t < tiles; t += clusters, ++k) {
        const int s = k % stages;
        if (k >= stages) bar_wait(&empty[s], static_cast<unsigned>((k / stages - 1) & 1));
        const long long r0 = t * kTile;
        const unsigned bytes =
            static_cast<unsigned>(min(static_cast<long long>(kTile), n - r0)) * 4;
        bar_expect(&full[s], bytes);
        // this block's slice of the tile, in 16-byte units
        const unsigned per = ((bytes / 16 + g - 1) / g) * 16;
        const unsigned off = min(bytes, per * rank);
        const unsigned len = min(bytes, off + per) - off;
        if (len) {
          bulk_multicast(reinterpret_cast<unsigned char*>(ring + s * kTile) + off,
                         reinterpret_cast<const unsigned char*>(codes + r0) + off, len, &full[s],
                         mask);
        }
      }
    }
  } else {
    const int ct = threadIdx.x - 32;
    int k = 0;
    for (long long t = cid; t < tiles; t += clusters, ++k) {
      const int s = k % stages;
      bar_wait(&full[s], static_cast<unsigned>((k / stages) & 1));
      const long long r0 = t * kTile;
      const int vecs = static_cast<int>(min(static_cast<long long>(kTile), n - r0)) / 4;
      const int4* cv = reinterpret_cast<const int4*>(ring + s * kTile);
      const int i = ct;
      if (i < vecs) {
        const int4 c4 = cv[i];
        const int code[4] = {c4.x, c4.y, c4.z, c4.w};
        bool ok[4];
        bool any = false;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ok[r] = code[r] >= lo && code[r] < hi;
          any = any || ok[r];
        }
        const long long row = r0 + 4LL * i;
        // four planes' loads in flight at once, then their adds
        for (int jb = 0; any && jb < gp; jb += 4) {
          float4 x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = jb + u < gp
                       ? __ldcs(reinterpret_cast<const float4*>(planes.p[j0 + jb + u] + row))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = jb + u;
            const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (ok[r] && v[r] != 0.0f) {
                const int e = kByRange ? (code[r] - lo) * nplanes + j : j * cap + code[r];
                atomicAdd(tab + e, static_cast<double>(v[r]));
              }
            }
          }
        }
      }
      // this warp is done with stage s: free it in every block of the
      // cluster (each stage is free once every consumer warp of every block
      // has arrived)
      __syncwarp();
      const int lane = threadIdx.x & 31;
      if (lane < static_cast<int>(g)) bar_arrive_remote(&empty[s], static_cast<unsigned>(lane));
    }
  }
  __syncthreads();
  // partial table (rank, cluster): rank-major, so that the second pass
  // finds a block's tables at rank * clusters + cluster
  double* dst = part + (static_cast<long long>(rank) * clusters + cid) * entries;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) dst[i] = tab[i];
  cluster.sync();  // no block leaves while another may still signal it
}

// out[c * nplanes + j] (cap x nplanes f64): the sum over `clusters` partial
// tables of entry (plane j, code c), in a fixed order.
template <bool kByRange>
__global__ void k7_cluster_merge_kernel(const double* __restrict__ part, int cap, int nplanes,
                                        int group, int width, int clusters,
                                        double* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(cap) * nplanes) return;
  const int c = static_cast<int>(e / nplanes);
  const int j = static_cast<int>(e - static_cast<long long>(c) * nplanes);
  int rank, at, entries;
  if (kByRange) {
    rank = c / width;
    at = (c - rank * width) * nplanes + j;
    entries = width * nplanes;
  } else {
    rank = j / group;
    at = (j - rank * group) * cap + c;
    entries = group * cap;
  }
  const double* src = part + static_cast<long long>(rank) * clusters * entries + at;
  double acc = 0.0;
  for (int k = 0; k < clusters; ++k) acc += src[static_cast<long long>(k) * entries];
  out[e] = acc;
}

using ClusterKernel = void (*)(Ptrs, const int32_t*, double*, long long, int, int, int, int,
                              int);

cudaLaunchConfig_t cluster_config(int g, int grid, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(g);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster shape at (cap, nplanes): g blocks, each with `group` planes
// (by plane group) or `width` codes (by range), the ring's stages (as many
// as fit beside the table, 2 to 8) and the shared memory a block takes;
// false when no cluster of at most 8 blocks holds the table.
bool cluster_shape(int by_range, int cap, int nplanes, int* g, int* group, int* width,
                   int* stages, size_t* smem) {
  // table doubles a block holds beside the smallest ring and the barriers
  const size_t room = (kMaxSmem - 2 * kStageBytes - kReserve) / 8;
  if (cap <= 0 || nplanes <= 0 || nplanes > kPlaneChunk) return false;
  if (by_range) {
    const long long per = static_cast<long long>(room / nplanes);  // codes a block holds
    if (per == 0) return false;
    *g = static_cast<int>((cap + per - 1) / per);
    *width = (cap + *g - 1) / *g;
    *group = nplanes;
    *smem = static_cast<size_t>(*width) * nplanes * 8;
  } else {
    const int fit = static_cast<int>(room / cap);  // planes a block holds
    if (fit == 0) return false;
    *g = (nplanes + fit - 1) / fit;
    *group = (nplanes + *g - 1) / *g;
    *width = cap;
    *smem = static_cast<size_t>(*group) * cap * 8;
  }
  *stages = static_cast<int>(
      min(static_cast<size_t>(kMaxStages), (kMaxSmem - kReserve - *smem) / kStageBytes));
  *smem += *stages * kStageBytes;
  return *g <= 8;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
k7_atomic_rate_kernel(const int32_t* __restrict__ codes, double* __restrict__ out, long long n,
                      int cap, int nplanes, int reps) {
  extern __shared__ double rate_tab[];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < cap * nplanes; i += blockDim.x) rate_tab[i] = 0.0;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int code = __ldcs(codes + r);
    if (static_cast<unsigned>(code) >= static_cast<unsigned>(cap)) continue;
    for (int rep = 0; rep < reps; ++rep) {
      const int c = static_cast<int>((code + rep * 40503LL) % cap);
      for (int j = 0; j < nplanes; ++j) {
        if constexpr (kShared) {
          atomicAdd(rate_tab + j * cap + c, 1.0);
        } else {
          atomicAdd(out + static_cast<long long>(c) * nplanes + j, 1.0);
        }
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cap * nplanes; i += blockDim.x) {
      if (rate_tab[i] != 0.0) atomicAdd(out + i, rate_tab[i]);
    }
  }
}

// The block tier with both atomic units at work: block b adds plane group
// b / per_group's values of codes below `split` into its shared-memory table
// (compare-and-swap loops) and those of codes in [split, cap) into out by
// device-memory reductions (native), so that the two units share the adds.
// 16-byte vectors of 4 f32 rows (codes and planes aligned, n a multiple of
// 4). Block b writes its table as partial table b (group x split doubles,
// plane-major).
__global__ void __launch_bounds__(kThreads)
k7_split_kernel(const __grid_constant__ Ptrs planes, const int32_t* __restrict__ codes,
                double* __restrict__ part, double* __restrict__ out, long long n, int cap,
                int split, int nplanes, int group, int per_group) {
  extern __shared__ __align__(16) double split_tab[];
  const int g = blockIdx.x / per_group;
  const int j0 = g * group;
  const int gp = min(group, nplanes - j0);
  for (int i = threadIdx.x; i < gp * split; i += blockDim.x) split_tab[i] = 0.0;
  __syncthreads();
  const long long stride = static_cast<long long>(per_group) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x - g * per_group) * blockDim.x +
                     threadIdx.x;
       q < n / 4; q += stride) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(codes) + q);
    const int code[4] = {c4.x, c4.y, c4.z, c4.w};
    bool ok[4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ok[r] = static_cast<unsigned>(code[r]) < static_cast<unsigned>(cap);
      any = any || ok[r];
    }
    for (int jb = 0; any && jb < gp; jb += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = jb + u < gp ? __ldcs(reinterpret_cast<const float4*>(planes.p[j0 + jb + u]) + q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!ok[r] || v[r] == 0.0f) continue;
          if (code[r] < split) {
            atomicAdd(split_tab + (jb + u) * split + code[r], static_cast<double>(v[r]));
          } else {
            atomicAdd(out + static_cast<long long>(code[r]) * nplanes + j0 + jb + u,
                      static_cast<double>(v[r]));
          }
        }
      }
    }
  }
  __syncthreads();
  double* dst = part + static_cast<long long>(blockIdx.x) * group * split;
  for (int i = threadIdx.x; i < gp * split; i += blockDim.x) dst[i] = split_tab[i];
}

// out[c * nplanes + j] for c < split: the per_group partial tables of plane
// j's group, added in a fixed order.
__global__ void k7_split_merge_kernel(const double* __restrict__ part, int split, int nplanes,
                                      int group, int per_group, double* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(split) * nplanes) return;
  const int c = static_cast<int>(e / nplanes);
  const int j = static_cast<int>(e - static_cast<long long>(c) * nplanes);
  const int g = j / group;
  const double* src =
      part + (static_cast<long long>(g) * per_group * group + (j - g * group)) * split + c;
  double acc = 0.0;
  for (int k = 0; k < per_group; ++k) acc += src[static_cast<long long>(k) * group * split];
  out[static_cast<long long>(c) * nplanes + j] = acc;
}

}  // namespace

extern "C" {

// The cluster designs' launch shape at (cap, nplanes): blocks a cluster,
// clusters that fit on the card at once, and the partial tables' doubles.
int daft_k7_cluster_shape(int by_range, int cap, int nplanes, int* blocks, int* clusters,
                          long long* words) {
  int g = 0, group = 0, width = 0, stages = 0;
  size_t smem = 0;
  if (!cluster_shape(by_range, cap, nplanes, &g, &group, &width, &stages, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterKernel kernel = by_range ? k7_cluster_kernel<true> : k7_cluster_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g > 1) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g, g, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = g;
  *words = static_cast<long long>(*clusters) * g *
           (by_range ? static_cast<long long>(width) * nplanes
                     : static_cast<long long>(group) * cap);
  return static_cast<int>(*clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration);
}

// K7 by a cluster design: f32 planes (16-byte aligned, n a multiple of 4)
// and codes into out (cap x nplanes f64, written); part holds the partial
// tables (daft_k7_cluster_shape's words). Two launches.
int daft_k7_cluster(int by_range, const void* const* planes, int nplanes, const void* codes,
                    void* part, void* out, long long n, int cap, int clusters, void* stream) {
  int g = 0, group = 0, width = 0, stages = 0;
  size_t smem = 0;
  if (!cluster_shape(by_range, cap, nplanes, &g, &group, &width, &stages, &smem) ||
      clusters <= 0 ||
      n < 0 || n % 4 != 0 || (reinterpret_cast<uintptr_t>(codes) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs ptrs = {};
  for (int j = 0; j < nplanes; ++j) {
    if ((reinterpret_cast<uintptr_t>(planes[j]) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ptrs.p[j] = static_cast<const float*>(planes[j]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ClusterKernel kernel = by_range ? k7_cluster_kernel<true> : k7_cluster_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g, clusters * g, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, ptrs, static_cast<const int32_t*>(codes),
                           static_cast<double*>(part), n, cap, nplanes, group, width, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = static_cast<long long>(cap) * nplanes;
  const int blocks = static_cast<int>((entries + 255) / 256);
  if (by_range) {
    k7_cluster_merge_kernel<true><<<blocks, 256, 0, s>>>(static_cast<const double*>(part), cap,
                                                         nplanes, group, width, clusters,
                                                         static_cast<double*>(out));
  } else {
    k7_cluster_merge_kernel<false><<<blocks, 256, 0, s>>>(static_cast<const double*>(part), cap,
                                                          nplanes, group, width, clusters,
                                                          static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The split design's first-pass grid (1024-thread blocks that fit on the
// card at once with a table of group x split doubles).
int daft_k7_split_blocks(int group, int split, int* blocks) {
  const size_t smem = static_cast<size_t>(group) * split * 8;
  if (group <= 0 || split <= 0 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(k7_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k7_split_kernel, kThreads,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  *blocks = per_sm * sms;
  return static_cast<int>(*blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration);
}

// K7 by the split design: f32 planes (16-byte aligned, n a multiple of 4)
// into out (cap x nplanes f64, zero-filled by the caller), `blocks` first-
// pass blocks in ceil(nplanes / group) groups of equally many; part holds
// blocks x group x split doubles. Two launches.
int daft_k7_split(const void* const* planes, int nplanes, const void* codes, void* part,
                  void* out, long long n, int cap, int split, int group, int blocks,
                  void* stream) {
  const int groups = nplanes > 0 && group > 0 ? (nplanes + group - 1) / group : 0;
  const size_t smem = static_cast<size_t>(group) * split * 8;
  if (nplanes <= 0 || nplanes > kPlaneChunk || group <= 0 || group > nplanes || split <= 0 ||
      split > cap || smem > kMaxSmem || blocks <= 0 || blocks % groups != 0 || n < 0 ||
      n % 4 != 0 || (reinterpret_cast<uintptr_t>(codes) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs ptrs = {};
  for (int j = 0; j < nplanes; ++j) {
    if ((reinterpret_cast<uintptr_t>(planes[j]) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ptrs.p[j] = static_cast<const float*>(planes[j]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(k7_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k7_split_kernel<<<blocks, kThreads, smem, s>>>(ptrs, static_cast<const int32_t*>(codes),
                                                 static_cast<double*>(part),
                                                 static_cast<double*>(out), n, cap, split,
                                                 nplanes, group, blocks / groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long entries = static_cast<long long>(split) * nplanes;
  k7_split_merge_kernel<<<static_cast<int>((entries + 255) / 256), 256, 0, s>>>(
      static_cast<const double*>(part), split, nplanes, group, blocks / groups,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The card's rate of f64 atomic adds (k7_atomic_rate_kernel; shared != 0:
// in each block's shared memory, cap x nplanes x 8 bytes at most 227 KB):
// out (cap x nplanes f64, zero-filled by the caller) gets reps x nplanes
// adds of 1.0 for every code in [0, cap), from as many 1024-thread blocks
// as fit on the card at once.
int daft_k7_atomic_rate(const void* codes, void* out, long long n, int cap, int nplanes,
                        int reps, int shared, void* stream) {
  const size_t smem = shared ? static_cast<size_t>(cap) * nplanes * 8 : 0;
  if (cap <= 0 || nplanes <= 0 || reps <= 0 || n < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = shared ? k7_atomic_rate_kernel<true> : k7_atomic_rate_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<per_sm * sms, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<double*>(out), n, cap, nplanes, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
