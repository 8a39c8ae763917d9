// Hash-probe join kernels K4 (build + probe) and K5 (probe + segment sum),
// written by hand for Hopper (sm_90a).
//
// Replaces daft_tpu/ops/pallas_kernels.py hash_probe_index (with the host
// build_probe_table and probe_key_digits beside it). Contract: map every fact
// int64 key to the int32 row of the equal dim key, or -1 when the fact key is
// null, equals INT64_MIN or no valid dim key equals it; null dim keys never
// match. The result is bit-identical to the host unique_key_index.
//
// The TPU kernel matches every fact row against every table slot (a
// (row-block x table-tile) equality slab per grid cell, O(N * T)): at TPC-H
// SF1 (N = 2^23 fact rows, T = 2^21 slots) that is 1.8e13 compares. Hopper
// has no reason to brute-force, so K4 is a real hash table.
//
// The table: one array of S 16-byte slots, S a power of two, 16-byte
// aligned. Slot h is two little-endian 64-bit words:
//
//   word 2h     the key XOR INT64_MIN (its sign bit flipped); 0 = empty
//   word 2h + 1 the key's int32 dim row, zero-extended (the upper 4 bytes
//               are padding and stay 0)
//
// so an all-zero table is empty. The only key whose stored word is 0 is
// INT64_MIN, which is refused on the host before any launch (the reference
// refuses its sentinel the same way), as are duplicate valid keys:
// uniqueness is a host check. The wrapper keeps the load (valid keys / S)
// at most 0.5 (probe_kernels.py probe_table_slots), so an empty slot always
// exists and every probe loop ends. The slot of a key is a 64-bit mix
// (splitmix64's finalizer) of its bits, masked to S, then linear probing.
//
// Why one 16-byte slot: the first design kept keys (int64) and rows (int32)
// in two arrays, so a probe hit needed a second, dependent load for the
// row. Here a probe step is one 16-byte read-only load (two slots share a
// 32-byte sector, so the next step of a walk is often in the same sector).
//
// daft_hash_probe_build, for tables up to 2^25 slots: a partitioned build
//   that needs no clearing and no CAS in device memory but for overflow. The
//   table is cut into regions of 4096 slots. Pass 1 (one block per 4096 dim
//   rows) sorts its valid rows by their home slot's region in shared memory
//   (a histogram, its prefix sum, the staged entries), reserves one run per
//   region with one global atomic, and writes each run whole, (stored key,
//   row) per slot, at the start of its region in the table itself. Pass 2
//   (one block per region) takes the region's staged entries into
//   registers, places them by linear probing in shared memory (a 64-bit
//   shared CAS; keys and rows in separate arrays, so the key words spread
//   over the banks), and writes the region's slots back whole, empty ones as
//   zeros. An entry that would pass its region's last slot, or whose region
//   got more keys than slots, goes to an overflow list that pass 3 inserts
//   once every region is placed, one row per warp, 32 slots a step (rare at
//   load 0.5 or below; keys chosen to collide take it often, and stay
//   right). The CAS tier is the only path from 2^26 slots on, that is for a
//   dim of more than 2^24 keys (the wrapper gives at least twice the keys'
//   slots): one memset, then one thread per dim row claims a slot with a
//   64-bit atomicCAS on the key word (0 -> stored key) and writes the row
//   word. The scratch both tiers need is daft_hash_probe_build_scratch's
//   count of int32. Where a key lands depends on the
//   order the threads win their atomics, so two builds of the same keys may
//   lay the table out differently; the set of (key, row) entries, and so
//   every probe's answer, does not change.
// daft_hash_probe_index: each thread takes kProbeRows (2) fact rows one
//   block-width apart, so the key and validity reads stay coalesced, issues
//   both first-slot loads before it compares either (on an H100 at TPC-H
//   SF1 q12's shapes, 1 row a thread was 6-7 % slower, 4 rows 34-43 %
//   slower), then walks each row's probe sequence until its stored key
//   (-> row) or an empty slot (-> -1). Null fact rows and fact keys equal
//   to INT64_MIN answer -1 without probing. Fact keys and validity are read,
//   and the answers written, with the streaming hint (__ldcs, __stcs) so
//   they leave L2 before the table does.
//
// Bound: memory. The build reads each dim key (8 B) and validity byte once
// and writes the table (12 B of key and row a slot, by the count the first
// design set, whatever the padding); the probe reads each fact key and
// validity byte once, the table once, and writes a 4 B row. What held the
// first build back was not bytes but its 1.5 M random 64-bit CAS in device
// memory: about 0.10 ms on the H100 at SF1, the same with one sector per
// key as with two, and slower on a table small enough to stay in L2 (more
// CAS at its higher load). The partitioned build writes runs and whole
// regions instead; its pass 1 still writes about 370 K runs of about 64
// bytes at random places, and pass 2 is bound by its per-block phases
// (read, place, write), not by bytes. Left for later: a bucketed or cuckoo
// layout that bounds a miss's walk, and fewer, longer runs in pass 1.
//
// K5 daft_hash_probe_segment_sum replaces pallas_kernels.py
//   hash_probe_segment_sum: probe + membership + segment sum in one kernel,
//   on K4's table. No engine code calls it, in the port or in the reference.
//   A fact row whose code lies in [0, cap) and whose key is valid (and not
//   INT64_MIN) walks K4's probe sequence (the device function `walk` shared
//   with the probe kernel); on a hit it adds the matched dim row's P planes
//   (f32, indexed by dim row) into the code's segment in f64 and 1 into the
//   code's match count. No index plane is written. The TPU kernel
//   accumulates in f32; the port widens to f64 sums and int64 counts, as K1
//   does, so the values equal the reference's wherever its f32 sums are
//   exact (integer-valued planes under 2^24 a segment).
//   Bound: memory. Every fact row's code is read; a kept row (a code in
//   range) reads its key and validity byte, each distinct kept key one
//   16-byte slot, each matched dim row its P planes; then the outputs:
//   0.0103 ms at TPC-H SF1 q12's shapes (2^23 rows, 31,585 kept, 29,673
//   distinct keys, cap 8, P 2), nearly all the codes' 33.5 MB, and 0.0369
//   ms with every real row kept (6.0 M hits on 1.5 M orders) at 3.35 TB/s.
//   Design: a persistent grid of 512-thread blocks, two an SM. A block
//   steps through its chunks of the codes, 2 16-byte vectors of 4 codes a
//   lane (single codes where the codes are not 16-byte aligned), the next
//   chunk's loads in flight while this chunk's kept rows are queued in
//   shared memory (a warp's prefix sum, one shared atomic a warp). A chunk
//   with no kept row costs its loads alone. After each chunk every thread
//   reads the queue's count between two barriers, so no warp queues the
//   next chunk before the block has decided on one count. When the
//   8192-row queue may not hold another chunk, and at the end, the whole
//   block probes the queue, 2
//   rows a thread with both first slots loaded before either walk, so the
//   walks of a thousand rows are in flight at once. Hits are aggregated in
//   the warp: __match_any_sync groups the lanes by code, every lane of a
//   group gathers its members' values by shuffles in lane order, and the
//   group's first lane adds the f64 sums and the group's size. Tiers, by
//   cap x (P + 1) in the wrapper (probe_kernels.py
//   hash_probe_segment_sum_tier) and checked here:
//   - shared, while a table of cap x (P + 1) 8-byte entries fits in 32 KB:
//     one table in the block's shared memory, added into the output with
//     one global atomic per nonzero entry when the block ends;
//   - global, past that: the groups' sums go to the output as global
//     atomics.
//   The 64-bit adds in shared memory (the f64 sums, the u64 counts) compile
//   to a compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN.64 in the SASS);
//   the global ones are REDG.E.ADD.F64 and REDG.E.ADD.64.
//   Measured (chip_smoke.py and probe_timings.py on an H100 80GB HBM3 at
//   700.00 W, device time under torch.profiler, the wrapper's one zero-fill
//   of the outputs included; the first design in brackets, timed in the
//   same call: one thread per row, f64 and u64 global atomics per hit):
//   0.018-0.019 ms at q12's shapes (0.046 or 0.071 by where the outputs
//   lie), 0.173-0.177 ms with every row kept (6.09). The first design's two
//   times are its 95 K atomics on two 128-byte lines: its time followed
//   where the allocator put the sums and the counts (PERF.md, section 7).
//   Designs that lost, at q12's shapes: warp aggregation straight
//   off a persistent scan, each warp probing its own kept rows as it met
//   them (0.048-0.050 ms with one vector a lane and 79 registers, 0.078
//   with 4 vectors and 64): each warp waited out its few rows' dependent
//   key, slot and plane loads in turn. A table per warp in turn (as far as
//   32 KB holds them) took 0.1744-0.1748 ms with every row kept against
//   0.1755-0.1773 for one table a block, and the same at q12's shapes
//   (0.0186-0.0188 against 0.0179-0.0185): one table is kept.
//
// Each launcher takes raw device pointers and the caller's stream, launches
// on that stream, never synchronises, allocates nothing (the wrapper in
// daft_tpu_torch/ops/probe_kernels.py allocates the table and the output),
// and returns the first CUDA error it met.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kSign = 0x8000000000000000ull;  // INT64_MIN's bits
// the partitioned build: regions of kRegion slots (placed in one block's
// shared memory, 48 KB), at most kMaxRegions of them (the partition
// kernel's two per-region arrays, 64 KB beside its 64 KB staging area), so
// tables up to 2^25 slots
constexpr int kRegionShift = 12;
constexpr int kRegion = 1 << kRegionShift;
constexpr int kMaxRegions = 8192;
constexpr int kPartThreads = 512;
constexpr int kPartRows = 8;                         // dim rows per thread
constexpr int kPlaceThreads = 512;
constexpr int kPlaceRows = kRegion / kPlaceThreads;  // staged entries per thread
constexpr int kOverflowBlocks = 264;
constexpr int kProbeRows = 2;                        // fact rows per probe thread
constexpr int kMaxDevices = 64;

inline int blocks_for(long long n, int per_block) {
  long long b = (n + per_block - 1) / per_block;
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

// the dim row stored beside `stored` (a key XOR INT64_MIN, never 0), or -1:
// linear probing from slot h, whose contents `cur` the caller loaded, until
// the key or an empty slot
__device__ __forceinline__ int walk(unsigned long long stored, unsigned long long h,
                                    ulonglong2 cur, const ulonglong2* __restrict__ slots,
                                    unsigned long long mask) {
  while (true) {
    if (cur.x == stored) return static_cast<int>(cur.y);
    if (cur.x == 0) return -1;
    h = (h + 1) & mask;
    cur = __ldg(slots + h);
  }
}

// the CAS tier (tables past kMaxRegions regions): one thread per dim row on
// a cleared table, a 64-bit CAS on the key word of each slot from the
// key's home on, then the row word of the slot it claimed
__global__ void __launch_bounds__(kThreads)
probe_build_kernel(const long long* __restrict__ keys, const unsigned char* __restrict__ valid,
                   unsigned long long* __restrict__ words, long long n,
                   unsigned long long mask) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n || !valid[row]) return;
  const unsigned long long key = static_cast<unsigned long long>(keys[row]);
  unsigned long long h = mix64(key) & mask;
  while (atomicCAS(words + 2 * h, 0ull, key ^ kSign) != 0ull) h = (h + 1) & mask;
  words[2 * h + 1] = static_cast<unsigned long long>(row);
}

// an exclusive prefix sum of v over the block's kPartThreads threads; the
// block's total is left in warp_sums[kPartThreads / 32 - 1]
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kPartThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kPartThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  return x - v + (warp ? warp_sums[warp - 1] : 0);
}

// bytes of pass 1's dynamic shared memory before its staging area
__host__ __device__ __forceinline__ int partition_stage_offset(int regions) {
  return (regions * 2 * static_cast<int>(sizeof(int)) + 15) & ~15;
}

// Partitioned build, pass 1: each block takes kPartThreads x kPartRows dim
// rows and sorts its valid ones by region (the home slot's upper bits) in
// shared memory: a histogram, its prefix sum, the entries (stored key, row)
// staged in region order. It reserves one run per region it touches with
// one global atomic, then writes each run whole at its reserved slots at
// the start of the region, inside the table itself: consecutive threads
// write consecutive slots. A row past its region's 2^shift slots (a region
// with more keys than slots) goes to the overflow list: overflow[0] counts,
// overflow[1..] holds rows.
__global__ void __launch_bounds__(kPartThreads)
build_partition_kernel(const long long* __restrict__ keys,
                       const unsigned char* __restrict__ valid, ulonglong2* __restrict__ slots,
                       int* __restrict__ counts, int* __restrict__ overflow, long long n,
                       unsigned long long mask, int shift, int regions) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[kPartThreads / 32];
  int* start = reinterpret_cast<int*>(smem);  // per region: count, then run start
  int* base = start + regions;                // per region: the run's first slot
  ulonglong2* stage = reinterpret_cast<ulonglong2*>(smem + partition_stage_offset(regions));
  for (int r = threadIdx.x; r < regions; r += kPartThreads) start[r] = 0;
  __syncthreads();
  const long long first_row = static_cast<long long>(blockIdx.x) * (kPartThreads * kPartRows);
  unsigned long long key[kPartRows];
  int region[kPartRows], rank[kPartRows];
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    const long long row = first_row + threadIdx.x + static_cast<long long>(j) * kPartThreads;
    region[j] = -1;
    if (row < n && __ldcs(valid + row)) {
      key[j] = static_cast<unsigned long long>(__ldcs(keys + row));
      region[j] = static_cast<int>((mix64(key[j]) & mask) >> shift);
      rank[j] = atomicAdd(start + region[j], 1);
    }
  }
  __syncthreads();
  // each thread turns a contiguous chunk of regions' counts into run starts
  // and reserves those runs in their regions
  const int per = (regions + kPartThreads - 1) / kPartThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, regions);
  const int hi = min(lo + per, regions);
  int sum = 0;
  for (int r = lo; r < hi; ++r) sum += start[r];
  int run = block_exclusive_scan(sum, warp_sums);
  for (int r = lo; r < hi; ++r) {
    const int c = start[r];
    start[r] = run;
    base[r] = c ? atomicAdd(counts + r, c) : 0;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    if (region[j] < 0) continue;
    const long long row = first_row + threadIdx.x + static_cast<long long>(j) * kPartThreads;
    stage[start[region[j]] + rank[j]] =
        make_ulonglong2(key[j] ^ kSign, static_cast<unsigned long long>(row));
  }
  __syncthreads();
  const int total = warp_sums[kPartThreads / 32 - 1];
  const int size = 1 << shift;
  for (int i = threadIdx.x; i < total; i += kPartThreads) {
    const ulonglong2 e = stage[i];
    const int r = static_cast<int>((mix64(e.x ^ kSign) & mask) >> shift);
    const int pos = base[r] + (i - start[r]);
    if (pos < size) {
      slots[(static_cast<long long>(r) << shift) + pos] = e;
    } else {
      overflow[1 + atomicAdd(overflow, 1)] = static_cast<int>(e.y);
    }
  }
}

// Partitioned build, pass 2: one block per region reads the region's staged
// entries into registers, inserts them by linear probing into the region's
// slots in shared memory (a 64-bit shared CAS on the key words, no wrap;
// keys and rows in separate arrays, so the key words spread over the
// banks), and writes the region's 16-byte slots back whole: the table needs
// no clearing. An entry whose probe passes the region's last slot goes to
// the overflow list.
__global__ void __launch_bounds__(kPlaceThreads)
build_place_kernel(ulonglong2* __restrict__ slots, const int* __restrict__ counts,
                   int* __restrict__ overflow, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int size = 1 << shift;
  unsigned long long* skeys = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* srows = reinterpret_cast<unsigned int*>(skeys + size);
  const long long first = static_cast<long long>(blockIdx.x) << shift;
  const int m = min(counts[blockIdx.x], size);
  ulonglong2 mine[kPlaceRows];
#pragma unroll
  for (int j = 0; j < kPlaceRows; ++j) {
    const int e = threadIdx.x + j * kPlaceThreads;
    if (e < m) mine[j] = slots[first + e];
  }
  for (int s = threadIdx.x; s < size; s += kPlaceThreads) skeys[s] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPlaceRows; ++j) {
    const int e = threadIdx.x + j * kPlaceThreads;
    if (e >= m) continue;
    // the home's lower bits: the region is the home's upper bits
    int h = static_cast<int>(mix64(mine[j].x ^ kSign) &
                             static_cast<unsigned long long>(size - 1));
    while (true) {
      if (h == size) {
        overflow[1 + atomicAdd(overflow, 1)] = static_cast<int>(mine[j].y);
        break;
      }
      if (atomicCAS(skeys + h, 0ull, mine[j].x) == 0ull) {
        srows[h] = static_cast<unsigned int>(mine[j].y);
        break;
      }
      ++h;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < size; s += kPlaceThreads) {
    const unsigned long long k = skeys[s];
    slots[first + s] = make_ulonglong2(k, k ? srows[s] : 0ull);
  }
}

// Partitioned build, pass 3: the overflow list's rows, once every region is
// placed, one row per warp: the warp reads 32 slots from the row's home on
// at once and CAS-es the first that reads empty (the next, if another row
// took it first), 32 slots further while none is. Each placed key has every
// slot from its home to its own taken, and an insertion into the first
// empty slot from a home keeps that so: the table stays one that linear
// probing could have built.
__global__ void __launch_bounds__(kThreads)
build_overflow_kernel(const long long* __restrict__ keys, const int* __restrict__ overflow,
                      unsigned long long* __restrict__ words, unsigned long long mask) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const int total = overflow[0];
  for (int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); i < total; i += warps) {
    const int row = overflow[1 + i];
    const unsigned long long key = static_cast<unsigned long long>(keys[row]);
    unsigned long long h = mix64(key) & mask;
    while (true) {
      const unsigned long long slot = (h + lane) & mask;
      const bool empty =
          __ldcg(reinterpret_cast<const long long*>(words) + 2 * slot) == 0;
      unsigned int free = __ballot_sync(0xffffffffu, empty);
      int won = 0;
      while (free && !won) {
        const int l = __ffs(free) - 1;
        if (lane == l && atomicCAS(words + 2 * slot, 0ull, key ^ kSign) == 0ull) {
          words[2 * slot + 1] = static_cast<unsigned long long>(row);
          won = 1;
        }
        won = __shfl_sync(0xffffffffu, won, l);
        free &= free - 1;
      }
      if (won) break;
      h = (h + 32) & mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
probe_index_kernel(const long long* __restrict__ keys, const unsigned char* __restrict__ valid,
                   const ulonglong2* __restrict__ slots, int* __restrict__ out, long long n,
                   unsigned long long mask) {
  constexpr int R = kProbeRows;
  const long long base = static_cast<long long>(blockIdx.x) * (kThreads * R) + threadIdx.x;
  unsigned long long stored[R], h[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = base + static_cast<long long>(r) * kThreads;
    live[r] = false;
    if (i < n) {
      const unsigned long long key = static_cast<unsigned long long>(__ldcs(keys + i));
      live[r] = __ldcs(valid + i) && key != kSign;
      stored[r] = key ^ kSign;
      h[r] = mix64(key) & mask;
    }
  }
  ulonglong2 first[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) first[r] = __ldg(slots + h[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = base + static_cast<long long>(r) * kThreads;
    if (i < n) __stcs(out + i, live[r] ? walk(stored[r], h[r], first[r], slots, mask) : -1);
  }
}

// ---- K5 ------------------------------------------------------------------------

constexpr int kSumThreads = 512;
constexpr int kSumVectors = 2;     // code vectors (4 codes, or 1) a lane loads a step
constexpr int kSumQueue = 8192;    // kept rows a block queues before it probes them
constexpr int kSumProbeRows = 2;   // queued rows a thread probes at once
constexpr int kSumPlaneChunk = 4;  // planes a lane loads and sums at once
constexpr int kSumTierShared = 0, kSumTierGlobal = 1;
// a block's table of cap x (P + 1) 8-byte entries
constexpr int kSumTableBytes = 32768;
constexpr unsigned kFullWarp = 0xffffffffu;

// One row slot of every lane of the warp (called by all 32 lanes together):
// lanes whose row hit dim row `row` add its P planes into segment `code`,
// aggregated in the warp first. __match_any_sync groups the lanes by code;
// every lane of a group gathers the group's values by shuffles from each of
// its members in lane order (so the order of the f64 additions is fixed),
// and the group's first lane adds the sums and the group's size into the
// table (shared memory, or the output in device memory).
__device__ __forceinline__ void sum_hits(bool hit, int code, int row,
                                         const float* __restrict__ planes, int p,
                                         double* sums, unsigned long long* counts) {
  if (!__any_sync(kFullWarp, hit)) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullWarp, hit ? code : -1);
  const unsigned group = hit ? peers : 0u;
  const bool lead = hit && __ffs(peers) - 1 == lane;
  if (lead) atomicAdd(counts + code, static_cast<unsigned long long>(__popc(peers)));
  const float* src = planes + static_cast<long long>(hit ? row : 0) * p;
  for (int j0 = 0; j0 < p; j0 += kSumPlaneChunk) {
    float v[kSumPlaneChunk];
#pragma unroll
    for (int u = 0; u < kSumPlaneChunk; ++u) {
      v[u] = hit && j0 + u < p ? __ldg(src + j0 + u) : 0.0f;
    }
    double acc[kSumPlaneChunk] = {};
    unsigned rest = group;
    while (__any_sync(kFullWarp, rest != 0u)) {
      const int from = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int u = 0; u < kSumPlaneChunk; ++u) {
        const float x = __shfl_sync(kFullWarp, v[u], from);
        if (rest) acc[u] += static_cast<double>(x);
      }
      rest &= rest - 1;
    }
    if (lead) {
#pragma unroll
      for (int u = 0; u < kSumPlaneChunk; ++u) {
        // a zero sum adds nothing to the zero-filled output
        if (j0 + u < p && acc[u] != 0.0) atomicAdd(sums + code * p + j0 + u, acc[u]);
      }
    }
  }
}

// Queue the rows [row0, row0 + R) of every lane whose code lies in
// [0, cap) (called by all 32 lanes together): one shared atomic per warp
// reserves the warp's run, each lane writes its rows at its prefix.
template <int R>
__device__ __forceinline__ void queue_rows(const int (&code)[R], long long row0, unsigned cap,
                                           int* queue, int* count) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) mine += static_cast<unsigned>(code[r]) < cap;
  int at = mine;  // inclusive prefix over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullWarp, at, d);
    if (lane >= d) at += y;
  }
  const int total = __shfl_sync(kFullWarp, at, 31);
  if (total == 0) return;
  int base = 0;
  if (lane == 31) base = atomicAdd(count, total);
  at += __shfl_sync(kFullWarp, base, 31) - mine;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (static_cast<unsigned>(code[r]) < cap) queue[at++] = static_cast<int>(row0 + r);
  }
}

// Probe the block's `count` queued rows and sum their hits (called by
// every thread of the block): each thread takes kSumProbeRows rows a round,
// reads their codes, validity and keys, loads every live row's first slot
// before it walks any, and each row slot is summed by sum_hits.
__device__ __forceinline__ void probe_queue(const int* queue, int count,
                                            const long long* __restrict__ keys,
                                            const unsigned char* __restrict__ valid,
                                            const int* __restrict__ codes,
                                            const ulonglong2* __restrict__ slots,
                                            unsigned long long mask,
                                            const float* __restrict__ planes, int p,
                                            double* sums, unsigned long long* counts) {
  constexpr int R = kSumProbeRows;
  for (int q0 = 0; q0 < count; q0 += kSumThreads * R) {
    int code[R];
    bool live[R];
    unsigned long long stored[R], h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + r * kSumThreads + static_cast<int>(threadIdx.x);
      live[r] = i < count;
      code[r] = 0;
      if (live[r]) {
        const int row = queue[i];
        const unsigned long long key = static_cast<unsigned long long>(__ldg(keys + row));
        code[r] = __ldg(codes + row);
        live[r] = __ldg(valid + row) && key != kSign;
        stored[r] = key ^ kSign;
        h[r] = mix64(key) & mask;
      }
    }
    ulonglong2 first[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (live[r]) first[r] = __ldg(slots + h[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = live[r] ? walk(stored[r], h[r], first[r], slots, mask) : -1;
      sum_hits(row >= 0, code[r], row, planes, p, sums, counts);
    }
  }
}

// K5: a persistent grid. Each block steps through its chunks of the codes,
// kSumVectors vectors a lane (4 codes each, kRows = 4, codes 16-byte
// aligned; or single codes, kRows = 1), the next chunk's loads in flight
// while this chunk's kept rows (a code in [0, cap)) are queued in shared
// memory. A chunk where no code is kept costs its loads alone. When the
// queue may not hold another chunk, and at the end, the whole block probes
// the queue (probe_queue): the walks of many rows are in flight at once,
// not one warp's few. The shared tier sums into a table of cap x (P + 1)
// entries in the block's shared memory (the counts, then the P sums of each
// code) and at the end adds each nonzero entry into the output with one
// global atomic; the global tier adds the warps' aggregates into the output
// directly.
template <int kTier, int kRows>
__global__ void __launch_bounds__(kSumThreads, 2)
probe_sum_kernel(const long long* __restrict__ keys, const unsigned char* __restrict__ valid,
                 const int* __restrict__ codes, const ulonglong2* __restrict__ slots,
                 const float* __restrict__ planes, double* __restrict__ sums,
                 unsigned long long* __restrict__ counts, long long n, int p, int cap,
                 unsigned long long mask) {
  extern __shared__ __align__(16) unsigned char sum_smem[];
  __shared__ int queue[kSumQueue];
  __shared__ int queued;
  using Vec = typename std::conditional<kRows == 4, int4, int>::type;
  const int entries = cap * (p + 1);
  double* tsum = sums;
  unsigned long long* tcnt = counts;
  if constexpr (kTier == kSumTierShared) {
    tcnt = reinterpret_cast<unsigned long long*>(sum_smem);
    tsum = reinterpret_cast<double*>(tcnt + cap);
    for (int i = threadIdx.x; i < entries; i += kSumThreads) tcnt[i] = 0ull;
  }
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  const unsigned ucap = static_cast<unsigned>(cap);
  const long long vecs = kRows == 4 ? n >> 2 : n;  // code vectors
  constexpr int kChunk = kSumThreads * kSumVectors;  // vectors a block step
  const long long stride = static_cast<long long>(gridDim.x) * kChunk;
  Vec c[kSumVectors], next[kSumVectors];
  auto load = [&](long long chunk, Vec (&v)[kSumVectors]) {
#pragma unroll
    for (int u = 0; u < kSumVectors; ++u) {
      const long long s = chunk + u * kSumThreads + threadIdx.x;
      if constexpr (kRows == 4) {
        v[u] = s < vecs ? __ldcs(reinterpret_cast<const int4*>(codes) + s)
                        : make_int4(-1, -1, -1, -1);
      } else {
        v[u] = s < vecs ? __ldcs(codes + s) : -1;
      }
    }
  };
  long long chunk = static_cast<long long>(blockIdx.x) * kChunk;
  if (chunk < vecs) load(chunk, c);
  for (; chunk < vecs; chunk += stride) {  // block-uniform
    if (chunk + stride < vecs) load(chunk + stride, next);
#pragma unroll
    for (int u = 0; u < kSumVectors; ++u) {
      const long long s = chunk + u * kSumThreads + threadIdx.x;
      if constexpr (kRows == 4) {
        const int code[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
        queue_rows<4>(code, s << 2, ucap, queue, &queued);
      } else {
        const int code[1] = {c[u]};
        queue_rows<1>(code, s, ucap, queue, &queued);
      }
    }
    __syncthreads();
    const int count = queued;
    // every thread has read the count before any warp queues the next
    // chunk's rows: the flush is decided by one count, block-wide
    __syncthreads();
    if (count > kSumQueue - kChunk * kRows) {
      probe_queue(queue, count, keys, valid, codes, slots, mask, planes, p, tsum, tcnt);
      __syncthreads();
      if (threadIdx.x == 0) queued = 0;
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kSumVectors; ++u) c[u] = next[u];
  }
  if constexpr (kRows == 4) {
    // the last n % 4 rows: block 0's first warp, after every thread has
    // read the last chunk's count (the barrier above)
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const long long r = (vecs << 2) + threadIdx.x;
      const int code[1] = {r < n ? codes[r] : -1};
      queue_rows<1>(code, r, ucap, queue, &queued);
    }
  }
  __syncthreads();
  probe_queue(queue, queued, keys, valid, codes, slots, mask, planes, p, tsum, tcnt);
  if constexpr (kTier == kSumTierShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cap; i += kSumThreads) {
      if (tcnt[i]) atomicAdd(counts + i, tcnt[i]);
    }
    for (int i = threadIdx.x; i < cap * p; i += kSumThreads) {
      if (tsum[i] != 0.0) atomicAdd(sums + i, tsum[i]);
    }
  }
}

using SumKernel = void (*)(const long long*, const unsigned char*, const int*,
                           const ulonglong2*, const float*, double*, unsigned long long*,
                           long long, int, int, unsigned long long);

// K5's kernel for a tier with its shared memory, or null for a tier this
// file does not take (a shared table past kSumTableBytes).
SumKernel sum_kernel(int tier, int cap, int p, bool vec, int* smem) {
  *smem = 0;
  if (cap <= 0 || p < 0) return nullptr;
  if (tier == kSumTierGlobal) {
    return vec ? probe_sum_kernel<kSumTierGlobal, 4> : probe_sum_kernel<kSumTierGlobal, 1>;
  }
  const long long bytes = static_cast<long long>(cap) * (p + 1) * 8;
  if (tier != kSumTierShared || bytes > kSumTableBytes) return nullptr;
  *smem = static_cast<int>(bytes);
  return vec ? probe_sum_kernel<kSumTierShared, 4> : probe_sum_kernel<kSumTierShared, 1>;
}

// regions of the partitioned build for a table of n_slots slots; 0: past
// kMaxRegions regions, the CAS tier
int build_regions(long long n_slots) {
  const long long regions = n_slots > kRegion ? n_slots >> kRegionShift : 1;
  return regions > kMaxRegions ? 0 : static_cast<int>(regions);
}

// the partitioned build's shared memory at its largest (kMaxRegions regions,
// regions of kRegion slots), allowed once per device
bool build_ready[kMaxDevices];

cudaError_t allow_build_smem() {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && build_ready[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(
      build_partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      partition_stage_offset(kMaxRegions) + kPartThreads * kPartRows * 16);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(build_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kRegion * 12);
  if (rc == cudaSuccess && dev < kMaxDevices) build_ready[dev] = true;
  return rc;
}

// K5's shared tier: its tables come beside the static queue, past 48 KB
// together only by this opt-in, allowed at their largest once per device
bool sum_ready[kMaxDevices];

cudaError_t allow_sum_smem() {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && sum_ready[dev]) return cudaSuccess;
  for (const SumKernel kernel : {probe_sum_kernel<kSumTierShared, 4>,
                                 probe_sum_kernel<kSumTierShared, 1>}) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSumTableBytes);
    if (rc != cudaSuccess) return rc;
  }
  if (dev < kMaxDevices) sum_ready[dev] = true;
  return rc;
}

}  // namespace

extern "C" {

// int32 of scratch daft_hash_probe_build needs for n dim rows into n_slots
// slots: a count per region, the overflow list's count and its n rows (0
// for the CAS tier)
long long daft_hash_probe_build_scratch(long long n, long long n_slots) {
  const int regions = build_regions(n_slots);
  return regions ? regions + 1 + n : 0;
}

// Build: slots (S x 16 B, 16-byte aligned) may hold anything and is filled
// here; S is a power of two larger than the number of valid keys, every
// valid key is unique and none equals INT64_MIN; 0 < n < 2^31. scratch
// holds daft_hash_probe_build_scratch(n, S) int32.
int daft_hash_probe_build(const void* keys, const void* valid, void* slots, void* scratch,
                          long long n, long long n_slots, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long mask = static_cast<unsigned long long>(n_slots - 1);
  const long long* k = static_cast<const long long*>(keys);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const int regions = build_regions(n_slots);
  cudaError_t rc;
  if (regions == 0) {
    rc = cudaMemsetAsync(slots, 0, static_cast<size_t>(n_slots) * 16, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    probe_build_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        k, v, static_cast<unsigned long long*>(slots), n, mask);
    return static_cast<int>(cudaGetLastError());
  }
  int shift = kRegionShift;
  if (regions == 1) {
    shift = 0;
    while ((1ll << shift) < n_slots) ++shift;
  }
  int* counts = static_cast<int*>(scratch);
  int* overflow = counts + regions;
  rc = cudaMemsetAsync(counts, 0, static_cast<size_t>(regions + 1) * sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int part_smem = partition_stage_offset(regions) + kPartThreads * kPartRows * 16;
  const int place_smem = (1 << shift) * 12;
  rc = allow_build_smem();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  ulonglong2* table = static_cast<ulonglong2*>(slots);
  build_partition_kernel<<<blocks_for(n, kPartThreads * kPartRows), kPartThreads, part_smem,
                           s>>>(k, v, table, counts, overflow, n, mask, shift, regions);
  build_place_kernel<<<regions, kPlaceThreads, place_smem, s>>>(table, counts, overflow,
                                                                shift);
  build_overflow_kernel<<<kOverflowBlocks, kThreads, 0, s>>>(
      k, overflow, static_cast<unsigned long long*>(slots), mask);
  return static_cast<int>(cudaGetLastError());
}

// Probe: out (N, int32) is written for every row.
int daft_hash_probe_index(const void* keys, const void* valid, const void* slots, void* out,
                          long long n, long long n_slots, void* stream) {
  if (n > 0) {
    probe_index_kernel<<<blocks_for(n, kThreads * kProbeRows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), static_cast<const unsigned char*>(valid),
        static_cast<const ulonglong2*>(slots), static_cast<int*>(out), n,
        static_cast<unsigned long long>(n_slots - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's grid for a tier (0 shared, 1 global) on the current device: as many
// blocks as fit on the card at once.
int daft_hash_probe_segment_sum_blocks(int tier, int cap, int p, int* blocks) {
  int smem = 0;
  const SumKernel kernel = sum_kernel(tier, cap, p, true, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = allow_sum_smem()) != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSumThreads,
                                                           smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  *blocks = per_sm * sms;
  return static_cast<int>(*blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration);
}

// K5: sums (cap x P, f64) and counts (cap, int64) must be zero-filled;
// planes (D x P, f32) hold one row per key the table was built from. A grid
// of `blocks` (daft_hash_probe_segment_sum_blocks for the same tier, cap
// and P on this device, which also allows the shared tables there).
int daft_hash_probe_segment_sum(const void* keys, const void* valid, const void* codes,
                                const void* slots, const void* planes, void* sums,
                                void* counts, long long n, int p, int cap, long long n_slots,
                                int tier, int blocks, void* stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  int smem = 0;
  const SumKernel kernel = sum_kernel(tier, cap, p, vec, &smem);
  // the queue holds int32 rows
  if (kernel == nullptr || blocks <= 0 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    kernel<<<blocks, kSumThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), static_cast<const unsigned char*>(valid),
        static_cast<const int*>(codes), static_cast<const ulonglong2*>(slots),
        static_cast<const float*>(planes), static_cast<double*>(sums),
        static_cast<unsigned long long*>(counts), n, p, cap,
        static_cast<unsigned long long>(n_slots - 1));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
