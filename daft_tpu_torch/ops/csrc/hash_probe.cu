// Hash-probe join kernel K4 (build + probe), written by hand for Hopper
// (sm_90a).
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
  int found = -1;
  if (__ldg(valid + i) && key != kEmpty) {
    unsigned long long h = mix64(key) & mask;
    while (true) {
      const unsigned long long k = __ldg(slot_keys + h);
      if (k == key) {
        found = __ldg(slot_rows + h);
        break;
      }
      if (k == kEmpty) break;
      h = (h + 1) & mask;
    }
  }
  out[i] = found;
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

}  // extern "C"
