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
//   Exact int64 per-segment min or max: one pass of 64-bit atomicMin /
//   atomicMax over (v ^ INT64_MIN) viewed as unsigned long long, which maps
//   int64 order onto uint64 order, plus a nonempty flag per segment; a second
//   pass decodes. The table is pre-filled with the encoded identity, so an
//   empty segment decodes to INT64_MAX for min and INT64_MIN for max.
//   Bound: memory (8 + 1 + 4 bytes read per row). Left for later: the same
//   shared-memory privatisation as K1/K2.

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

__global__ void segment_extreme_i64_kernel(const long long* __restrict__ vals,
                                           const unsigned char* __restrict__ mask,
                                           const int32_t* __restrict__ codes,
                                           unsigned long long* __restrict__ table,
                                           unsigned char* __restrict__ nonempty,
                                           long long n, int cap, int is_min) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!__ldg(mask + i)) continue;
    const int code = __ldg(codes + i);
    if (code < 0 || code >= cap) continue;
    const unsigned long long key =
        static_cast<unsigned long long>(__ldg(vals + i)) ^ 0x8000000000000000ull;
    if (is_min) {
      atomicMin(table + code, key);
    } else {
      atomicMax(table + code, key);
    }
    if (!nonempty[code]) nonempty[code] = 1;
  }
}

__global__ void decode_i64_kernel(const unsigned long long* __restrict__ table,
                                  long long* __restrict__ out, int cap) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cap; i += stride) {
    out[i] = static_cast<long long>(table[i] ^ 0x8000000000000000ull);
  }
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

// K3: table (cap, uint64) must hold the encoded identity (all ones for min,
// zero for max) and nonempty (cap, uint8) zeros; out (cap, int64) is written.
int daft_segment_extreme_int64(const void* vals, const void* mask,
                               const void* codes, void* table, void* nonempty,
                               void* out, long long n, int cap, int is_min,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    segment_extreme_i64_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const long long*>(vals),
        static_cast<const unsigned char*>(mask),
        static_cast<const int32_t*>(codes),
        static_cast<unsigned long long*>(table),
        static_cast<unsigned char*>(nonempty), n, cap, is_min);
  }
  if (cap > 0) {
    decode_i64_kernel<<<grid_for(cap), kThreads, 0, s>>>(
        static_cast<const unsigned long long*>(table),
        static_cast<long long*>(out), cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
