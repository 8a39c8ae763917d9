// Hash-probe join kernels K4 (build + probe) and K5 (probe + segment sum),
// written by hand for Hopper (sm_90a).
//
// Replaces daft_tpu/ops/pallas_kernels.py hash_probe_index (with the host
// build_probe_table and probe_key_digits beside it). Contract: map every fact
// int64 key to the int32 row of the equal dim key, or -1 when the fact key is
// null or no valid dim key equals it; null dim keys never match. The result
// is bit-identical to the host unique_key_index.
//
// The TPU kernel matches every fact row against every table slot (a
// (row-block x table-tile) equality slab per grid cell, O(N * T)): at TPC-H
// SF1 (N = 2^23 fact rows, T = 2^21 slots) that is 1.8e13 compares. Hopper
// has no reason to brute-force, so K4 is a real hash table:
//
// - open addressing over S slots, S a power of two >= 2 x the dim's rows
//   (load <= 0.5; the wrapper refuses a smaller table, which could fill and
//   leave the probe loops without an empty slot to stop at); a slot holds
//   an int64 key and an int32 row;
// - the empty slot holds INT64_MIN. A dim key equal to INT64_MIN is refused
//   on the host before any launch (the reference refuses its sentinel the
//   same way), as are duplicate valid keys: uniqueness is a host check;
// - the slot of a key is a 64-bit mix (splitmix64's finalizer) of its bits,
//   masked to S, then linear probing.
//
// daft_hash_probe_build: one thread per dim row claims a slot with a 64-bit
//   atomicCAS on the key word and then writes the row. The slot a key lands
//   in depends on the order the threads win their CAS, so two builds of the
//   same keys may lay the table out differently; the set of (key, row)
//   entries, and so every probe's answer, does not change.
// daft_hash_probe_index: one thread per fact row walks the probe sequence
//   through the read-only cache (__ldg) until it finds its key (-> row) or
//   an empty slot (-> -1). Null fact rows and fact keys equal to INT64_MIN
//   answer -1 without probing.
//
// Bound: memory. The probe reads each fact key (8 B) and validity byte once
// and writes a 4 B row; the table (12 B a slot; 50 MB at S = 2^22) is read
// at random, one 32 B sector per probe step, so at SF1 the table does not
// fit the 50 MB L2 whole and most probes pay a device-memory sector. Left
// for later: packing key and row into one 16 B slot so one step touches one
// sector, and a cuckoo or bucketed layout that bounds the steps.
//
// K5 daft_hash_probe_segment_sum replaces pallas_kernels.py
//   hash_probe_segment_sum: probe + membership + segment sum in one kernel,
//   on K4's table. No engine code calls it, in the port or in the reference.
//   One thread per fact row: a row whose code lies in [0, cap) and whose key
//   is valid walks K4's probe sequence (the device function shared with the
//   probe kernel); on a hit it adds the matched dim row's P planes (f32,
//   indexed by dim row) into the code's segment with f64 atomics and 1 into
//   the code's match count with a 64-bit atomic. No index plane is written.
//   The TPU kernel accumulates in f32; the port widens to f64 sums and int64
//   counts, as K1 does, so the values equal the reference's wherever its f32
//   sums are exact (integer-valued planes under 2^24 a segment).
//   Bound: memory. Every fact row's code is read; only rows with a code in
//   range read their key and probe (q12 keeps 0.4 % of lineitem), and only
//   hits read P planes of their dim row. Left for later: warp-aggregated
//   atomics, since few segments take every hit.
//
// Each launcher takes raw device pointers and the caller's stream, launches
// on that stream, never synchronises, allocates nothing (the wrapper in
// daft_tpu_torch/ops/probe_kernels.py allocates the table and the output),
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = 0x8000000000000000ull;  // INT64_MIN

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : b);
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

// the dim row of `key` in the table, or -1: linear probing from the key's
// mixed slot until the key or an empty slot
__device__ __forceinline__ int probe_row(unsigned long long key,
                                         const unsigned long long* __restrict__ slot_keys,
                                         const int* __restrict__ slot_rows,
                                         unsigned long long mask) {
  unsigned long long h = mix64(key) & mask;
  while (true) {
    const unsigned long long k = __ldg(slot_keys + h);
    if (k == key) return __ldg(slot_rows + h);
    if (k == kEmpty) return -1;
    h = (h + 1) & mask;
  }
}

__global__ void probe_build_kernel(const long long* __restrict__ keys,
                                   const unsigned char* __restrict__ valid,
                                   unsigned long long* __restrict__ slot_keys,
                                   int* __restrict__ slot_rows,
                                   long long n, unsigned long long mask) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n || !valid[row]) return;
  const unsigned long long key = static_cast<unsigned long long>(keys[row]);
  unsigned long long h = mix64(key) & mask;
  while (true) {
    const unsigned long long prev = atomicCAS(slot_keys + h, kEmpty, key);
    if (prev == kEmpty) {
      slot_rows[h] = static_cast<int>(row);
      return;
    }
    h = (h + 1) & mask;
  }
}

__global__ void probe_index_kernel(const long long* __restrict__ keys,
                                   const unsigned char* __restrict__ valid,
                                   const unsigned long long* __restrict__ slot_keys,
                                   const int* __restrict__ slot_rows,
                                   int* __restrict__ out, long long n,
                                   unsigned long long mask) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = static_cast<unsigned long long>(__ldg(keys + i));
  out[i] = (__ldg(valid + i) && key != kEmpty) ? probe_row(key, slot_keys, slot_rows, mask)
                                                : -1;
}

__global__ void probe_segment_sum_kernel(const long long* __restrict__ keys,
                                         const unsigned char* __restrict__ valid,
                                         const int* __restrict__ codes,
                                         const unsigned long long* __restrict__ slot_keys,
                                         const int* __restrict__ slot_rows,
                                         const float* __restrict__ planes,
                                         double* __restrict__ sums,
                                         unsigned long long* __restrict__ counts,
                                         long long n, int p, int cap,
                                         unsigned long long mask) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int code = __ldg(codes + i);
  if (code < 0 || code >= cap || !__ldg(valid + i)) return;
  const unsigned long long key = static_cast<unsigned long long>(__ldg(keys + i));
  if (key == kEmpty) return;
  const int row = probe_row(key, slot_keys, slot_rows, mask);
  if (row < 0) return;
  const float* src = planes + static_cast<long long>(row) * p;
  double* dst = sums + static_cast<long long>(code) * p;
  for (int c = 0; c < p; ++c) {
    const float v = __ldg(src + c);
    if (v != 0.0f) atomicAdd(dst + c, static_cast<double>(v));
  }
  atomicAdd(counts + code, 1ull);
}

}  // namespace

extern "C" {

// Build: slot_keys (S, int64) must hold INT64_MIN everywhere and slot_rows
// (S, int32) may hold anything; S is a power of two larger than the number
// of valid keys, every valid key is unique and none equals INT64_MIN.
int daft_hash_probe_build(const void* keys, const void* valid, void* slot_keys,
                          void* slot_rows, long long n, long long slots,
                          void* stream) {
  if (n > 0) {
    probe_build_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys),
        static_cast<const unsigned char*>(valid),
        static_cast<unsigned long long*>(slot_keys), static_cast<int*>(slot_rows),
        n, static_cast<unsigned long long>(slots - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

// Probe: out (N, int32) is written for every row.
int daft_hash_probe_index(const void* keys, const void* valid,
                          const void* slot_keys, const void* slot_rows, void* out,
                          long long n, long long slots, void* stream) {
  if (n > 0) {
    probe_index_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys),
        static_cast<const unsigned char*>(valid),
        static_cast<const unsigned long long*>(slot_keys),
        static_cast<const int*>(slot_rows), static_cast<int*>(out), n,
        static_cast<unsigned long long>(slots - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: sums (cap x P, f64) and counts (cap, int64) must be zero-filled;
// planes (D x P, f32) hold one row per key the table was built from.
int daft_hash_probe_segment_sum(const void* keys, const void* valid, const void* codes,
                                const void* slot_keys, const void* slot_rows,
                                const void* planes, void* sums, void* counts,
                                long long n, int p, int cap, long long slots,
                                void* stream) {
  if (n > 0) {
    probe_segment_sum_kernel<<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys),
        static_cast<const unsigned char*>(valid), static_cast<const int*>(codes),
        static_cast<const unsigned long long*>(slot_keys),
        static_cast<const int*>(slot_rows), static_cast<const float*>(planes),
        static_cast<double*>(sums), static_cast<unsigned long long*>(counts), n, p, cap,
        static_cast<unsigned long long>(slots - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
