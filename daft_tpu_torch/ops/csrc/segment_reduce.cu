// Segment-reduce kernels of the grouped-aggregation kernel tier (K1-K3, and
// the standalone K1a),
// written by hand for Hopper (sm_90a).
//
// Each kernel sits behind a plain `extern "C"` launcher that takes raw device
// pointers and the caller's CUDA stream, launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is seen by the Python wrapper (daft_tpu_torch/ops/
// segment_kernels.py), which allocates every output and scratch buffer.
//
// K1 daft_segment_sum_planes
//   Replaces daft_tpu/ops/pallas_kernels.py segment_sum_planes_windowed.
//   Sums value planes (N x P, f32) into a (cap x P, f64) segment table by
//   int32 codes; codes outside [0, cap) are dropped (the trash segment of
//   filtered and padding rows).
//   Contract: the grouped stage feeds K1 only INTEGER-valued planes (the kept
//   row count, per-aggregation valid counts, and 8-bit digits below 256), and
//   every segment total stays below 2^53. Every partial sum is then an exact
//   f64 integer, so f64 atomics give the same bits in any order, and the same
//   bits as the TPU kernel's f32-per-32K-window / f64-across-windows combine.
//   A float plane would make the result depend on the atomic order; the tier
//   never feeds one (GroupedAggStage._kernel_eligible).
//   Bound: memory. Per element one f32 read and at most one f64 atomic into a
//   table of cap*P*8 bytes (2 MB at cap 16384, P 15, so it lives in the 50 MB
//   L2); zero values skip the atomic. Left for later: privatising the table in
//   shared memory where cap*P fits and warp-aggregated atomics for skewed keys.
//
// K1a daft_segment_sum_planes_f32
//   Replaces pallas_kernels.py segment_sum_planes (the single-window parity
//   anchor; no engine code calls it, in the port or in the reference).
//   K1's one-window case with an f32 table, as the TPU kernel's output: f32
//   atomics into (cap x P), codes outside [0, cap) dropped. Exact for
//   integer-valued planes whose segment totals stay below 2^24; otherwise
//   the atomic order decides the last bits.
//   Bound: memory, as K1 (one f32 read per element, a 4-byte table entry
//   per atomic). Left for later: the same privatisation as K1.
//
// K2 daft_segment_extreme_planes
//   Replaces pallas_kernels.py segment_extreme_planes.
//   Per-segment min or max of identity-filled f32 planes (N x Q) into
//   (cap x Q, f32); an empty segment keeps the identity (+inf for min, -inf
//   for max). atomicMin/atomicMax run on an order-preserving uint32 encoding
//   of f32, so negatives and +-inf order correctly; a second pass decodes the
//   table. NaN is outside the contract (the tier never feeds it), and -0.0
//   orders below +0.0.
//   Bound: memory (one f32 and one code read per element; identity rows skip
//   the atomic). Left for later: shared-memory privatisation of the table.
//
// K3 daft_segment_extreme_int64
//   Replaces pallas_kernels.py segment_extreme_int64 (three chained K2
//   launches over 16/24/24-bit digit planes on the TPU).
//   Exact int64 per-segment min or max over (v ^ INT64_MIN) viewed as
//   uint64, which maps int64 order onto uint64 order, plus a nonempty flag
//   per segment; an empty segment decodes to INT64_MAX for min and INT64_MIN
//   for max. Rows whose mask is false or whose code lies outside [0, cap)
//   are dropped.
//   Bound: memory, 13 bytes read per row (value, mask, code): 0.033 ms at
//   the supplier query's N = 2^23, cap 16,384, at 3.35 TB/s.
//   The first design made one global 64-bit atomic per kept row
//   (5.9 M of them onto 10,000 L2 addresses at the supplier's shapes), read
//   and stored a nonempty byte per row, and decoded in a second launch; L2
//   atomic throughput held it at 0.247 ms, 13 % of the bound.
//   This design privatises the table. A persistent grid (as many blocks as
//   fit on the card, 1024 threads each) keeps one table of encoded keys and
//   a nonempty bitmap in shared memory per block; rows come in 16-byte
//   vectors (4 codes, 2 values, 4 mask bytes per thread per step) and reduce
//   with shared-memory 64-bit atomics. Past a block's shared memory (cap >
//   24,576) the table is split across a thread block cluster of 2, 4 or 8
//   blocks of 16,384 entries each, and a row's atomic goes to the owning
//   block's shared memory (distributed shared memory). For caps up to 16
//   the lanes of a warp that share a code are grouped (__match_any_sync)
//   and reduced with __reduce_min/max_sync on the key's two halves, so one
//   lane per code does the shared atomic. Each block (or cluster) then
//   writes its table as one partial table, and a second launch reduces the
//   partials per segment and decodes.
//   The tier (cluster size, entries per block, warp pre-aggregation) is a
//   function of cap chosen by the wrapper (segment_kernels.py
//   segment_extreme_int64_tier); this file checks it.
//   Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, N = 2^23, device
//   time): 0.047-0.050 ms at cap 16,384 (the old 0.241), 0.084 ms at cap 8
//   (the old 1.75: every kept row on 7 L2 addresses), 0.224-0.226 ms at cap
//   2^17 (the old 0.244). Merging each block's set entries into one table by
//   global atomics was slower than the partial tables (0.080-0.100 ms at cap
//   16,384 by CUDA events). The cluster tier stays at 14 % of the bound: its
//   64-bit compare-and-swap on another SM's shared memory costs a round trip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride launches: enough blocks to fill 132 SMs many times over
constexpr long long kMaxBlocks = 132LL * 32;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

__device__ __forceinline__ unsigned int f32_order_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float f32_from_order_key(unsigned int k) {
  const unsigned int u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

__global__ void segment_sum_kernel(const float* __restrict__ planes,
                                   const int32_t* __restrict__ codes,
                                   double* __restrict__ out,
                                   long long n, int p, int cap) {
  const long long total = n * static_cast<long long>(p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / p;
    const int col = static_cast<int>(i - row * p);
    const int code = __ldg(codes + row);
    const float v = __ldg(planes + i);
    if (code >= 0 && code < cap && v != 0.0f) {
      atomicAdd(out + static_cast<long long>(code) * p + col,
                static_cast<double>(v));
    }
  }
}

__global__ void segment_sum_f32_kernel(const float* __restrict__ planes,
                                       const int32_t* __restrict__ codes,
                                       float* __restrict__ out,
                                       long long n, int p, int cap) {
  const long long total = n * static_cast<long long>(p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / p;
    const int col = static_cast<int>(i - row * p);
    const int code = __ldg(codes + row);
    const float v = __ldg(planes + i);
    if (code >= 0 && code < cap && v != 0.0f) {
      atomicAdd(out + static_cast<long long>(code) * p + col, v);
    }
  }
}

__global__ void segment_extreme_kernel(const float* __restrict__ planes,
                                       const int32_t* __restrict__ codes,
                                       unsigned int* __restrict__ table,
                                       long long n, int q, int cap, int is_min) {
  const long long total = n * static_cast<long long>(q);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float ident = is_min ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / q;
    const int col = static_cast<int>(i - row * q);
    const int code = __ldg(codes + row);
    const float v = __ldg(planes + i);
    if (code < 0 || code >= cap || v == ident) continue;
    unsigned int* slot = table + static_cast<long long>(code) * q + col;
    if (is_min) {
      atomicMin(slot, f32_order_key(v));
    } else {
      atomicMax(slot, f32_order_key(v));
    }
  }
}

__global__ void decode_f32_kernel(const unsigned int* __restrict__ table,
                                  float* __restrict__ out, long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    out[i] = f32_from_order_key(table[i]);
  }
}

// ---- K3 ----------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr unsigned long long kSignBit = 0x8000000000000000ull;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kK3Threads = 1024;
// most shared memory a block may take (H100: 227 KB)
constexpr size_t kK3MaxSmem = 232448;
constexpr int kK3ReduceWarps = 8;

template <bool kMin>
__device__ __forceinline__ unsigned long long k3_pick(unsigned long long a,
                                                      unsigned long long b) {
  return kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <bool kMin>
__device__ __forceinline__ void k3_atomic(unsigned long long* slot,
                                          unsigned long long key) {
  if (kMin) {
    atomicMin(slot, key);
  } else {
    atomicMax(slot, key);
  }
}

// The shared::cluster address of `p` (this block's shared memory) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_smem_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

// Reduce one row into the table. Every lane of the warp calls it together
// (the row loops are warp-uniform), with ok = false for a dropped row.
template <int CS, bool kMin, bool kWarpAgg>
__device__ __forceinline__ void k3_add(unsigned long long* keys, unsigned int* bits,
                                       int shift, bool ok, int code,
                                       unsigned long long key) {
  if constexpr (kWarpAgg) {
    // one lane per distinct code: its group's extreme, from the two 32-bit
    // halves of the key (the high half first, then the low half among the
    // lanes that hold the winning high half)
    const int lane = threadIdx.x & 31;
    const unsigned none = kMin ? 0xffffffffu : 0u;
    const unsigned peers = __match_any_sync(kFullWarp, ok ? static_cast<unsigned>(code)
                                                          : 0xffffffffu);
    unsigned leads = __ballot_sync(kFullWarp, ok && __ffs(peers) - 1 == lane);
    while (leads) {
      const int lead = __ffs(leads) - 1;
      leads &= leads - 1;
      const bool in = (__shfl_sync(kFullWarp, peers, lead) >> lane) & 1u;
      const unsigned hi = in ? static_cast<unsigned>(key >> 32) : none;
      const unsigned best_hi = kMin ? __reduce_min_sync(kFullWarp, hi)
                                    : __reduce_max_sync(kFullWarp, hi);
      const unsigned lo = in && hi == best_hi ? static_cast<unsigned>(key) : none;
      const unsigned best_lo = kMin ? __reduce_min_sync(kFullWarp, lo)
                                    : __reduce_max_sync(kFullWarp, lo);
      if (lane == lead) {
        k3_atomic<kMin>(keys + code,
                        (static_cast<unsigned long long>(best_hi) << 32) | best_lo);
        atomicOr(bits + (code >> 5), 1u << (code & 31));
      }
    }
  } else if constexpr (CS == 1) {
    if (!ok) return;
    k3_atomic<kMin>(keys + code, key);
    const unsigned bit = 1u << (code & 31);
    // most rows find their bit set already: read before the atomic
    if (!(reinterpret_cast<volatile unsigned int*>(bits)[code >> 5] & bit)) {
      atomicOr(bits + (code >> 5), bit);
    }
  } else {
    if (!ok) return;
    // the owning block of the cluster holds entries [owner << shift, ...).
    // The key goes in by a compare-and-swap loop on its shared memory: 64-bit
    // min/max reductions on another block's shared memory lost updates on the
    // H100 (red.shared::cluster.min.u64, and atomicMin through a generic
    // pointer). The first try guesses that the entry still holds the
    // identity, as most do at the caps that take this tier.
    const unsigned owner = static_cast<unsigned>(code) >> shift;
    const int local = code & ((1 << shift) - 1);
    const unsigned key_addr = cluster_smem_addr(keys + local, owner);
    const unsigned bit_addr = cluster_smem_addr(bits + (local >> 5), owner);
    unsigned long long cur = kMin ? ~0ull : 0ull;
    while (true) {
      unsigned long long prev;
      asm volatile("atom.shared::cluster.cas.b64 %0, [%1], %2, %3;"
                   : "=l"(prev)
                   : "r"(key_addr), "l"(cur), "l"(key)
                   : "memory");
      if (prev == cur || !(kMin ? key < prev : key > prev)) break;
      cur = prev;
    }
    asm volatile("red.relaxed.cluster.shared::cluster.or.b32 [%0], %1;" ::"r"(bit_addr),
                 "r"(1u << (local & 31))
                 : "memory");
  }
}

// The first pass: every block (CS == 1) or cluster of CS blocks holds one
// table of `slice` (x CS) entries in shared memory, reduces its share of the
// rows into it, and writes it out as partial table blockIdx.x / CS. kRows = 4
// reads 16-byte vectors (vals and codes 16-byte aligned, mask 4-byte
// aligned), kRows = 1 single rows.
template <int CS, bool kMin, bool kWarpAgg, int kRows>
__global__ void __launch_bounds__(kK3Threads, 1)
k3_partial_kernel(const long long* __restrict__ vals, const unsigned char* __restrict__ mask,
                  const int32_t* __restrict__ codes,
                  unsigned long long* __restrict__ part_keys,
                  unsigned int* __restrict__ part_bits, long long n, int cap, int slice,
                  int shift) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(k3_smem);
  unsigned int* bits = reinterpret_cast<unsigned int*>(keys + slice);
  const int words = slice >> 5;
  const unsigned long long ident = kMin ? ~0ull : 0ull;
  for (int i = threadIdx.x; i < slice; i += blockDim.x) keys[i] = ident;
  for (int i = threadIdx.x; i < words; i += blockDim.x) bits[i] = 0u;
  if constexpr (CS == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // every block's table is ready for remote atomics
  }

  const int lane = threadIdx.x & 31;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned ucap = static_cast<unsigned>(cap);
  if constexpr (kRows == 4) {
    const long long nq = n >> 2;
    // warp-uniform trip count: the bound is tested on the warp's first lane
    for (long long q0 = tid - lane; q0 < nq; q0 += nthreads) {
      const long long q = q0 + lane;
      int4 c = make_int4(0, 0, 0, 0);
      longlong2 v01 = make_longlong2(0, 0), v23 = make_longlong2(0, 0);
      unsigned m = 0;
      if (q < nq) {
        c = __ldcs(reinterpret_cast<const int4*>(codes) + q);
        v01 = __ldcs(reinterpret_cast<const longlong2*>(vals) + 2 * q);
        v23 = __ldcs(reinterpret_cast<const longlong2*>(vals) + 2 * q + 1);
        m = __ldcs(reinterpret_cast<const unsigned int*>(mask) + q);
      }
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 (m & 0xffu) && static_cast<unsigned>(c.x) < ucap, c.x,
                                 static_cast<unsigned long long>(v01.x) ^ kSignBit);
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 (m & 0xff00u) && static_cast<unsigned>(c.y) < ucap, c.y,
                                 static_cast<unsigned long long>(v01.y) ^ kSignBit);
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 (m & 0xff0000u) && static_cast<unsigned>(c.z) < ucap, c.z,
                                 static_cast<unsigned long long>(v23.x) ^ kSignBit);
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 (m & 0xff000000u) && static_cast<unsigned>(c.w) < ucap,
                                 c.w, static_cast<unsigned long long>(v23.y) ^ kSignBit);
    }
    // the last n % 4 rows: the grid's first warp
    if (tid < 32) {
      const long long r = (nq << 2) + lane;
      const bool in = r < n;
      const int code = in ? codes[r] : 0;
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 in && mask[r] && static_cast<unsigned>(code) < ucap, code,
                                 in ? static_cast<unsigned long long>(vals[r]) ^ kSignBit
                                    : 0ull);
    }
  } else {
    for (long long r0 = tid - lane; r0 < n; r0 += nthreads) {
      const long long r = r0 + lane;
      const bool in = r < n;
      const int code = in ? codes[r] : 0;
      k3_add<CS, kMin, kWarpAgg>(keys, bits, shift,
                                 in && mask[r] && static_cast<unsigned>(code) < ucap, code,
                                 in ? static_cast<unsigned long long>(vals[r]) ^ kSignBit
                                    : 0ull);
    }
  }

  if constexpr (CS == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // every remote atomic has landed
  }
  const long long cap_pad = static_cast<long long>(slice) * CS;
  const long long part = blockIdx.x / CS;
  const int rank = blockIdx.x % CS;  // the block's rank in its 1-D cluster
  unsigned long long* pk = part_keys + part * cap_pad + static_cast<long long>(rank) * slice;
  for (int i = threadIdx.x; i < slice; i += blockDim.x) pk[i] = keys[i];
  unsigned int* pb = part_bits + part * (cap_pad >> 5) + static_cast<long long>(rank) * words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) pb[i] = bits[i];
}

// The second pass: per segment, the extreme over every partial table and
// the OR of their nonempty bits, decoded into out. A block takes 32
// segments; its warps split the partial tables.
template <bool kMin>
__global__ void __launch_bounds__(32 * kK3ReduceWarps)
k3_reduce_kernel(const unsigned long long* __restrict__ part_keys,
                 const unsigned int* __restrict__ part_bits, int parts, int cap,
                 long long cap_pad, long long* __restrict__ out,
                 unsigned char* __restrict__ nonempty) {
  __shared__ unsigned long long best_key[kK3ReduceWarps][32];
  __shared__ unsigned int any_bit[kK3ReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  unsigned long long best = kMin ? ~0ull : 0ull;
  unsigned int any = 0;
  if (e < cap) {
#pragma unroll 4
    for (int p = warp; p < parts; p += kK3ReduceWarps) {
      best = k3_pick<kMin>(best, part_keys[p * cap_pad + e]);
      any |= part_bits[p * (cap_pad >> 5) + (e >> 5)] >> (e & 31);
    }
  }
  best_key[warp][lane] = best;
  any_bit[warp][lane] = any & 1u;
  __syncthreads();
  if (warp == 0 && e < cap) {
    for (int w = 1; w < kK3ReduceWarps; ++w) {
      best = k3_pick<kMin>(best, best_key[w][lane]);
      any |= any_bit[w][lane];
    }
    out[e] = static_cast<long long>(best ^ kSignBit);
    nonempty[e] = static_cast<unsigned char>(any & 1u);
  }
}

using K3Kernel = void (*)(const long long*, const unsigned char*, const int32_t*,
                          unsigned long long*, unsigned int*, long long, int, int, int);

template <int CS, bool kMin, bool kWarpAgg>
K3Kernel k3_variant(bool vec) {
  return vec ? k3_partial_kernel<CS, kMin, kWarpAgg, 4>
             : k3_partial_kernel<CS, kMin, kWarpAgg, 1>;
}

template <bool kMin>
K3Kernel k3_variant_for(int cluster, bool warp_agg, bool vec) {
  switch (cluster) {
    case 1:
      return warp_agg ? k3_variant<1, kMin, true>(vec) : k3_variant<1, kMin, false>(vec);
    case 2:
      return warp_agg ? nullptr : k3_variant<2, kMin, false>(vec);
    case 4:
      return warp_agg ? nullptr : k3_variant<4, kMin, false>(vec);
    case 8:
      return warp_agg ? nullptr : k3_variant<8, kMin, false>(vec);
    default:
      return nullptr;
  }
}

// The kernel of a tier, with its shared memory size and slice shift; null
// for a tier this file does not take (a cluster size other than 1, 2, 4 or
// 8, warp aggregation in a cluster, a slice that is not a multiple of 32 or,
// in a cluster, not a power of two, or a table past a block's shared memory).
K3Kernel k3_kernel(int cluster, int slice, int warp_agg, int is_min, bool vec,
                   size_t* smem, int* shift) {
  if (slice <= 0 || slice % 32 != 0) return nullptr;
  *smem = static_cast<size_t>(slice) * 8 + static_cast<size_t>(slice / 32) * 4;
  if (*smem > kK3MaxSmem) return nullptr;
  *shift = 0;
  if (cluster > 1) {
    if (slice & (slice - 1)) return nullptr;
    while ((1 << *shift) < slice) ++*shift;
  }
  return is_min ? k3_variant_for<true>(cluster, warp_agg != 0, vec)
                : k3_variant_for<false>(cluster, warp_agg != 0, vec);
}

cudaLaunchConfig_t k3_config(int cluster, int grid, size_t smem, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kK3Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = static_cast<unsigned>(cluster);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

}  // namespace

extern "C" {

// K1: out (cap x P, f64) must be zero-filled by the caller.
int daft_segment_sum_planes(const void* planes, const void* codes, void* out,
                            long long n, int p, int cap, void* stream) {
  const long long total = n * static_cast<long long>(p);
  if (total > 0) {
    segment_sum_kernel<<<grid_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(planes), static_cast<const int32_t*>(codes),
        static_cast<double*>(out), n, p, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1a: out (cap x P, f32) must be zero-filled by the caller.
int daft_segment_sum_planes_f32(const void* planes, const void* codes, void* out,
                                long long n, int p, int cap, void* stream) {
  const long long total = n * static_cast<long long>(p);
  if (total > 0) {
    segment_sum_f32_kernel<<<grid_for(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(planes), static_cast<const int32_t*>(codes),
        static_cast<float*>(out), n, p, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: table (cap x Q, uint32) must be filled with the encoded identity
// (0xff800000 for min, 0x007fffff for max); out (cap x Q, f32) is written.
int daft_segment_extreme_planes(const void* planes, const void* codes,
                                void* table, void* out, long long n, int q,
                                int cap, int is_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * static_cast<long long>(q);
  if (total > 0) {
    segment_extreme_kernel<<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(planes), static_cast<const int32_t*>(codes),
        static_cast<unsigned int*>(table), n, q, cap, is_min);
  }
  const long long m = static_cast<long long>(cap) * q;
  if (m > 0) {
    decode_f32_kernel<<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const unsigned int*>(table), static_cast<float*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's partial tables for a tier on the current device: as many blocks (or
// clusters of `cluster` blocks) as fit on the card at once. The caller
// allocates parts x cluster x slice keys (uint64) and parts x cluster x
// slice / 32 bit words (uint32).
int daft_segment_extreme_int64_parts(int cluster, int slice, int warp_agg, int* parts) {
  size_t smem = 0;
  int shift = 0;
  const K3Kernel kernel = k3_kernel(cluster, slice, warp_agg, 1, true, &smem, &shift);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *parts = 0;
  if (cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kK3Threads,
                                                             smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    *parts = per_sm * sms;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = k3_config(cluster, cluster, smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(parts, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(*parts > 0 ? cudaSuccess : cudaErrorInvalidConfiguration);
}

// K3: part_keys and part_bits are scratch sized by
// daft_segment_extreme_int64_parts for the same tier; out (cap, int64) and
// nonempty (cap, uint8) are written. Two launches: the partial tables, then
// their reduction and decode.
int daft_segment_extreme_int64(const void* vals, const void* mask, const void* codes,
                               void* part_keys, void* part_bits, void* out, void* nonempty,
                               long long n, int cap, int cluster, int slice, int warp_agg,
                               int parts, int is_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(vals) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  size_t smem = 0;
  int shift = 0;
  const K3Kernel kernel = k3_kernel(cluster, slice, warp_agg, is_min, vec, &smem, &shift);
  const long long cap_pad = static_cast<long long>(slice) * cluster;
  if (kernel == nullptr || cap <= 0 || cap > cap_pad || parts <= 0 ||
      static_cast<long long>(parts) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k3_config(cluster, parts * cluster, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const long long*>(vals),
                           static_cast<const unsigned char*>(mask),
                           static_cast<const int32_t*>(codes),
                           static_cast<unsigned long long*>(part_keys),
                           static_cast<unsigned int*>(part_bits), n, cap, slice, shift);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (cap + 31) / 32;
  if (is_min) {
    k3_reduce_kernel<true><<<blocks, 32 * kK3ReduceWarps, 0, s>>>(
        static_cast<const unsigned long long*>(part_keys),
        static_cast<const unsigned int*>(part_bits), parts, cap, cap_pad,
        static_cast<long long*>(out), static_cast<unsigned char*>(nonempty));
  } else {
    k3_reduce_kernel<false><<<blocks, 32 * kK3ReduceWarps, 0, s>>>(
        static_cast<const unsigned long long*>(part_keys),
        static_cast<const unsigned int*>(part_bits), parts, cap, cap_pad,
        static_cast<long long*>(out), static_cast<unsigned char*>(nonempty));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
