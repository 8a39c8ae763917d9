// Segment-reduce kernels of the grouped-aggregation kernel tier (K1-K3, K7,
// and the standalone K1a),
// written by hand for Hopper (sm_90a).
//
// Each kernel sits behind a plain `extern "C"` launcher that takes raw device
// pointers and the caller's CUDA stream, launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is seen by the Python wrapper (daft_tpu_torch/ops/
// segment_kernels.py), which allocates every output and scratch buffer.
//
// K1 and K2 daft_segment_planes (op 0: K1 sum; op 1, 2: K2 min, max)
//   K1 replaces daft_tpu/ops/pallas_kernels.py segment_sum_planes_windowed:
//   P value planes (each N f32) summed into a (cap x P, f64) segment table.
//   K2 replaces pallas_kernels.py segment_extreme_planes: the per-segment
//   min or max of Q identity-filled f32 planes into (cap x Q, f32); an empty
//   segment keeps the identity (+inf for min, -inf for max).
//   Both group rows by int32 codes and drop codes outside [0, cap) (the
//   trash segment of filtered and padding rows). The planes come as P
//   separate pointers, passed by value in the kernel's parameters (chunks of
//   up to 64 planes, one launch pair per chunk, each writing its own columns
//   of the output): the TPU kernels' (N, P) block layout made the caller
//   stack its planes, a strided copy that took longer than every kernel of
//   the query together.
//   K1's contract: every plane value is an integer in [0, 255] (the kept-row
//   plane, valid counts and 8-bit digits: all the grouped stage feeds it),
//   and N < 2^24 (MAX_KERNEL_BUCKET, which the wrapper checks). A table
//   entry then stays below 255 x 2^24 < 2^32, so K1 adds in uint32 exactly,
//   in any order, and gives the TPU kernel's f32-window / f64 bits. A value
//   outside the contract gives a wrong sum: the wrapper cannot check values
//   without a device-to-host sync.
//   K2 reduces an order-preserving uint32 key of each f32 (the complement of
//   the key for min, so both ops take the max); key 0 marks an empty entry.
//   NaN is outside the contract, and -0.0 orders below +0.0.
//   Bound: memory, what the function needs: the codes (4 bytes a row), the
//   32-byte sectors of the kept rows' planes (a trash row's plane values are
//   never needed) and the output: 0.118 ms for K1 at the supplier query's
//   N = 2^23, cap 16,384, P 15 (70 % of rows kept), 0.011 ms at q12's cap 8,
//   P 5 (0.5 % kept), and 0.017 and 0.010 ms for K2 there (Q 1), at 3.35
//   TB/s. Every input read once would take 0.161, 0.060, 0.020 and 0.020 ms.
//   Design: a persistent grid of 1024-thread blocks, each holding a uint32
//   table in shared memory. Rows come 4 per thread as 16-byte vectors (codes
//   and every plane 16-byte aligned; otherwise one row per thread); a row
//   whose value adds nothing (0 for K1, the identity for K2) does no atomic.
//   Tiers, chosen by cap and P in the wrapper (segment_kernels.py
//   segment_planes_tier) and checked here:
//   - block: the planes are split into groups of G, the most whose cap x G
//     x 4 bytes fit in a block's shared memory (G = 3 at cap 16,384, so 5
//     groups for P 15); each group gets an equal share of the grid, and a
//     block reads the codes and its group's planes only, with shared-memory
//     atomicAdd (K1) or atomicMax (K2, after reading the entry: most rows
//     lose to it);
//   - global: caps past one plane's table in a block (cap x 4 > 227 KB, up
//     to 2^22): uint32 atomics on one code-major table in device memory,
//     the lanes of a warp on (row, plane) pairs, plane fastest, so that one
//     warp instruction's atomics fall on a few adjacent entries (0.515 ms
//     for K1's 15 planes and 0.050 for K2 at cap 2^20, chip_smoke.py, same
//     card).
//   Each block then writes its table as one partial table, and a second
//   launch combines the partials per entry (in uint64 for K1) and writes the
//   f64 sums or the decoded f32 extremes straight into the output. Every
//   first pass loads the next step's codes while this step's planes load.
//   Measured (chip_smoke.py on an H100 80GB HBM3 at 700.00 W, N = 2^23,
//   device time under torch.profiler, the first design's in brackets: one
//   global atomic per kept element over an (N, P) stack): K1 0.168-0.170 ms
//   at the supplier's cap 16,384 and 15 planes (0.363), 0.022 at q12's cap
//   8 and 5 planes (0.110), 0.130-0.131 at cap 8 with 98 % of rows kept
//   (10.96), 0.417 at cap 2^17 (0.389: the global tier is the slower) and
//   0.685 on 73 planes at cap 4096 (1.693); K2 0.029 at cap 16,384 (0.150),
//   0.014 at q12's cap 8 (0.041), 0.018 at cap 8 with 98 % kept (1.06), 0.071
//   at cap 2^17 (0.092). The wrapper's Python takes 0.05-0.08 ms a call,
//   more than the kernels at q12's shapes. A warp pre-aggregation tier for
//   caps up to 16 (__match_any_sync, one __reduce_add/max_sync per code) was
//   slower than these tables at every shape tried and was dropped: K1 0.030
//   and 0.61-0.62 ms, K2 0.016 and 0.067; the global tier with one row per
//   lane took 0.48 ms for K1 at cap 2^17, its atomics uncoalesced.
//
// K1a daft_segment_sum_planes_f32
//   Replaces pallas_kernels.py segment_sum_planes (the single-window parity
//   anchor; no engine code calls it, in the port or in the reference).
//   Contract: an (N x P) row-major f32 stack and N int32 codes into a
//   (cap x P) f32 table, one f32 accumulation, codes outside [0, cap)
//   dropped; exact where segment totals are integers below 2^24, otherwise
//   the order of the adds decides the last bits.
//   Bound: memory, the bytes the function needs at 3.35 TB/s: every code,
//   the 32-byte sectors of the stack that the kept rows' floats lie in (a
//   trash row's values are never needed), the output once: 0.117 ms at
//   the supplier query's N = 2^23, P 15, cap 16,384, where the last 28 %
//   of the rows are padding (every input read once: 0.161).
//   Design: a persistent grid of 1024-thread blocks reads the stack once as
//   16-byte vectors, from the start rounded down to 16 bytes (the 0-3
//   floats before it, and those past the end in the last vector, fall on
//   rows outside [0, N) and are dropped), in tiles of 4096 rows (1024 x P
//   vectors) round robin over the grid. A tile's codes are staged in
//   shared memory once per row, by cp.async while the block adds the tile
//   before; a tile none of whose codes lies in [0, cap) loads no vector
//   (the padding, a filtered run). Each warp turns its 32 loaded vectors
//   lane-consecutive through shared memory, so the adds of one warp
//   instruction fall on one or two rows' adjacent entries, and takes each
//   float's (row, column) from counters, not a division. Tiers, chosen by
//   cap x P in the wrapper (segment_kernels.py segment_sum_f32_tier) and
//   checked here:
//   - block, while the cap x P table fits in a block's shared memory beside
//     the staged codes and vectors (45,816 entries: every cap up to 3,054 at
//     P 15): each block sums into its own table (one copy per warp in turn,
//     up to 32, as far as two blocks an SM would still fit), writes it as a
//     partial table, and a second launch adds the partial tables per entry
//     in a fixed order. Warps that share a copy add in the order they run,
//     so fractional planes may differ in their last bits from run to run
//     below 32 copies; integer-valued planes (totals below 2^24) are exact;
//   - global, past that: f32 atomics on one table in device memory, which
//     the wrapper zero-fills.
//   Shared-memory f32 atomicAdd (and red.shared.add.f32) compiles to a
//   compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN in the SASS); the
//   global adds are REDG.E.ADD.F32.
//   Measured (chip_smoke.py on an H100 80GB HBM3 at 700.00 W, device time
//   under torch.profiler; the first design in brackets, timed in the same
//   call: one global atomic per nonzero element, grid-stride): 0.233-0.238
//   ms at the supplier's cap 16,384 (0.331), 0.198-0.201 at cap 8 with 98 %
//   of rows kept (5.56), 0.225-0.239 at cap 2^17 (0.342). At the supplier's
//   shape that is half the 0.117 ms bound: the adds, not the reads, take
//   the rest (the block tier at cap 8, with the same reads, reaches 59 %).
//   Skipping the trash tiles took 13-14 % off each shape.
//   Designs that lost, at the supplier's shape, each timed in one call
//   against the design it was then compared with: the table split by code
//   range over a thread block cluster of 8 blocks, with fire-and-forget f32
//   adds on the owner's shared memory (red.shared::cluster.add.f32), took
//   1.47 ms with each lane adding its own vector's floats and 0.633 ms
//   lane-consecutive, against 0.293 for the global tier; tiles of 2048 rows
//   0.294-0.295 (a barrier per tile) against 0.275 for 4096, and 8192 rows
//   0.275-0.280 against 0.275-0.276; 2 or 8 vectors in flight a thread
//   (2048-row tiles, reloaded a chunk at a time) 0.340 and 0.298 against
//   0.294; reloading a chunk at a time, not a slab, 0.271-0.275 against
//   0.270-0.275 (0.243 against 0.232 at cap 8). With the tile skip, two
//   more lost at every shape: carrying the block's next tile's first
//   chunk across the tile barrier (each vector loaded where its rows'
//   codes, read from global memory, are kept), and, in the global tier,
//   one 16-byte f32 atomic (atomicAdd on a float4) per row and group of 4
//   columns into a table padded to whole groups, in place of 4 scalar
//   atomics, much slower at both global-tier shapes; tiles of 2048 or 3072
//   rows were no clear gain either way. Not built: the cluster's
//   blocks sharing one row tile through a TMA multicast, each adding only
//   the codes it owns: each block would scan the whole tile, 8 times the
//   shared-memory reads of a float that the global tier makes.
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
//   Past a cluster's tables (cap > 2^17, up to 2^22) the global tier keeps
//   one table and bitmap in device memory, filled with the identity and
//   zeros by the launcher, and reduces into them with native 64-bit
//   atomicMin/Max and 32-bit atomicOr; the second pass decodes it as the one
//   partial table: 0.111 ms at cap 2^20 (chip_smoke.py, same card; 32 % of
//   the bound), faster than the cluster tier's 0.225 at 2^17.
//
// K7 daft_segment_sum_float_planes
//   Replaces no Pallas kernel: the reference sums its float "sum" planes
//   with XLA (daft_tpu/ops/grouped_stage.py: _build's one-hot matmul scan,
//   f32 chunk products combined in f64; _build_sorted's f64 segmented scan;
//   _build_local_dense's chunk matmul). A one-hot product at the supplier's
//   cap would cost 2 x 2^23 x 16,385 x P flops, so the port scatters.
//   Contract: P planes (each N f32, or each N f64 in a stage that computes
//   in f64) and N int32 codes into a (cap x P, f64) table, cap <= 2^22,
//   codes outside [0, cap) dropped. Every value is widened to f64 on load
//   and added in f64, at least as precise as the reference's f32 chunks;
//   the order of the adds decides the last bits (the thread and warp tiers'
//   are fixed), so results are held to a summation bound, not bit for bit.
//   Bound: memory, what the function needs (the codes, 4 bytes a row; the
//   32-byte sectors of the kept rows' planes; the output) at 3.35 TB/s. The
//   tiers that add by atomics also meet a floor of their own: their adds at
//   the card's rate of f64 atomics at the same shape (measured by
//   measure/k7_leads.cu, through chip_smoke.py's k7_atomic_rate): about
//   1.95e11 a second into a shared-memory table at the supplier's spread
//   (compare-and-swap loops: ATOMS.CAST.SPIN.64 in the SASS), 8.8e10 into
//   device memory at the partkey cell's 2^18 and 1.07e11 at 2^20 (native
//   REDG.E.ADD.F64). That floor holds any design that adds each value by
//   such an atomic, not the function.
//   Design: the planes by pointer as in K1 (chunks of 64, one launch pair
//   per chunk); a step whose codes all lie outside [0, cap) loads no plane
//   value (the padding), and a zero makes no add. Tiers by cap and planes
//   (segment_kernels.py segment_sum_float_tier), checked here:
//   - thread, cap <= 32 (TPC-H q1's 4 to 6 groups): 256-thread blocks, rows
//     as 16-byte vectors (4 floats or 2 doubles) when every array is
//     16-byte aligned, else one row a thread; each thread adds into its own
//     copy of its group's table in shared memory (entry-major, thread
//     fastest) with plain loads and stores, and the block adds its copies
//     in a fixed order;
//   - warp, while 16 tables of every plane fit beside the smallest ring
//     (cap <= 131 for 4 planes, 1295 for one): a block per SM of two loader
//     warps and 16 consumer warps, each consumer with its own table. Tiles
//     of 2048 rows go through shared memory by cp.async.bulk into rings of
//     stages that complete on mbarriers: warp 0 keeps the codes of up to 8
//     tiles in flight, warp 1 reads each tile's codes and loads only the
//     256-row runs of each plane that hold a kept row into up to 4 plane
//     stages. A consumer lane takes 4 rows a step; for each of them the
//     lanes with one code (__match_any_sync) send their values to the
//     lowest such lane by shuffles, in lane order, and it adds them with
//     plain loads and stores: no atomic, no compare-and-swap, and a fixed
//     order;
//   - block (up to cap 29,056 for one plane): 1024-thread blocks, rows as in
//     the thread tier, shared-memory f64 atomics on a table of `group`
//     planes a block (the most whose cap x group x 8 bytes fit), each plane
//     group's blocks reading every code;
//   - global, past that (up to 2^22): native f64 atomicAdd straight into
//     the output, which the wrapper zero-fills.
//   The thread, warp and block tiers write one partial table per block, and
//   a second launch adds them per entry in a fixed order into the output.
//   Measured (chip_smoke.py and tier_timings.py on an H100 80GB HBM3 at
//   700.00 W, N = 2^23, device time under torch.profiler; the first design,
//   timed in the same call, in brackets): 0.092 ms at q1's cap 8 with 7 f32
//   planes (0.094-0.095; 65 % of the bytes bound), 0.135 with the same
//   planes in f64 (0.134-0.135); 0.102-0.103 at cap 64 with lineitem's 4
//   f32 planes in the warp tier (0.157 in the block tier; 38 % of the
//   bytes bound, under the 0.126 that its adds would take at the shared
//   atomic rate); the block tier 0.099 at cap 1024 and 0.122 at the
//   supplier's cap 16,384, at its atomics floor there (0.119) and at 32 %
//   of the bytes bound; the global tier 0.085-0.088 at the partkey cell's
//   2^18 with one f64 plane (78-80 % of its floor of 0.068), 0.124-0.125 at
//   2^20 with 2 planes (88 % of 0.111). Tried and dropped, each slower
//   where it would serve (tier_timings.py; the two cluster designs and the
//   split design are in measure/k7_leads.cu): a cluster of a block per
//   plane group fed by one multicast bulk copy of each tile of codes
//   (0.116 at cap 1024, 0.173-0.181 at 16,384), the same with each block
//   holding a code range of every plane, entry-major (0.237-0.240,
//   0.395-0.399); the block tier with the codes past a split adding into
//   device memory beside the shared-memory adds (0.113 at best at 16,384,
//   with two planes a table, and 0.36 at 1024); a partitioned global tier
//   (records by code range, then a block a range: 0.323 and 0.229 ms at
//   2^18 and 2^20); the block tier fed by the bulk-copy rings (with shared
//   atomics, with the lanes of a code combined first, or with rows handed
//   through per-warp queues to the warp owning their code), 128-bit
//   compare-and-swap on pairs of planes, and the warp tier with 8, 24 or 30
//   tables, two blocks an SM, or each code's lanes adding in rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // K1 and K2's global-tier finish

__device__ __forceinline__ unsigned int f32_order_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float f32_from_order_key(unsigned int k) {
  const unsigned int u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

// ---- K1a -----------------------------------------------------------------------

constexpr int kF32Threads = 1024;
// a tile is 4096 rows of the stack: 1024 x P 16-byte vectors
constexpr int kF32TileRows = 4096;
// code slots per tile: its rows, one more for a tile that starts mid-row,
// and the rows a start off 16-byte alignment reaches back to
constexpr int kF32CodeSlots = kF32TileRows + 4;
constexpr int kF32Chunk = 4;  // vectors whose loads a thread has in flight
constexpr int kF32MergeWarps = 8;
constexpr int kF32TierBlock = 0, kF32TierGlobal = 1;
// shared memory beside the table: the codes of two tiles, and each warp's
// 32 vectors while it turns them lane-consecutive
constexpr size_t kF32CodeBytes = 2 * kF32CodeSlots * 4;
constexpr size_t kF32TurnBytes = kF32Threads * 16;
constexpr size_t kF32MaxSmem = 232448;

__device__ __forceinline__ void red_shared_f32(const float* p, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "f"(v)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Add v into entry (code, col): the block tier into the warp's copy of the
// table in shared memory, the global tier into out.
template <int kTier>
__device__ __forceinline__ void f32_add(float* tab, float* out, int code, int col, int p,
                                        float v) {
  if constexpr (kTier == kF32TierBlock) {
    red_shared_f32(tab + code * p + col, v);
  } else {
    atomicAdd(out + static_cast<long long>(code) * p + col, v);
  }
}

// (row, col) += `step` floats, with the step split as rows and cols of P
__device__ __forceinline__ void f32_advance(int& row, int& col, int step_rows, int step_cols,
                                            int p) {
  row += step_rows;
  col += step_cols;
  if (col >= p) {
    col -= p;
    ++row;
  }
}

// The first pass. The (N x P) stack is read as 16-byte vectors from `base`,
// its start rounded down to 16 bytes (`lead` floats before the first
// element, 0-3: the same vector path for a view off its alignment), tile by
// tile: tile k is vectors [k * 512P, (k + 1) * 512P), tiles round robin over
// the grid. A tile's codes are staged
// in shared memory once per row, rows outside [0, n) as -1 (the floats
// before the start and past the end of the stack that its first and last
// vector hold are dropped as trash), by cp.async while the block adds the
// tile before it (two buffers, one barrier a tile). That barrier also
// tells the block whether any of the tile's codes lies in [0, cap); a tile
// with none (padding, a filtered run) loads no vector. Warp w
// takes the tile's 32-vector slabs w, w + 32, ..., with kF32Chunk slabs'
// loads in flight (a slab's register reloads with the next chunk's slab as
// soon as it is staged), and turns each slab lane-consecutive through
// shared memory: in round k lane l adds the slab's float 32k + l, so the adds of
// one warp instruction fall on one or two rows' adjacent entries (adjacent
// banks, a few lines of the global table). Each float's (row, column) comes
// from counters stepped by 32 floats a round, not a division per element.
// Then the block tier folds its copies into partial table blockIdx.x; the
// global tier has added into out.
template <int kTier>
__global__ void __launch_bounds__(kF32Threads, 1)
f32_partial_kernel(const float4* __restrict__ base, int lead, const int32_t* __restrict__ codes,
                   float* __restrict__ dst, long long n, int p, int cap, int copies) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  int* scodes = reinterpret_cast<int*>(f32_smem);
  float4* turn = reinterpret_cast<float4*>(f32_smem + kF32CodeBytes);
  float* tab = reinterpret_cast<float*>(f32_smem + kF32CodeBytes + kF32TurnBytes);
  const int entries = cap * p;
  if constexpr (kTier == kF32TierBlock) {
    for (int i = threadIdx.x; i < entries * copies; i += kF32Threads) tab[i] = 0.0f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = tab + warp % copies * entries;
  float4* my_turn = turn + warp * 32;
  const float* turned = reinterpret_cast<const float*>(my_turn);

  const long long vectors = (n * p + lead + 3) >> 2;
  const long long tile_vectors = static_cast<long long>(kF32TileRows / 4) * p;
  const long long tiles = (vectors + tile_vectors - 1) / tile_vectors;
  const int back = (lead + p - 1) / p;  // rows before a tile's first full row
  const int off0 = back * p - lead;     // the first vector's first float in row r0
  // a round: 32 floats; the rest of a step of 1024 vectors after 4 rounds
  const int round_rows = 32 / p, round_cols = 32 - round_rows * p;
  const int rest = 4 * kF32Threads - 128;
  const int rest_rows = rest / p, rest_cols = rest - rest_rows * p;
  const unsigned ucap = static_cast<unsigned>(cap);
  // tile k's codes into buffer b; a thread's slots are its own until the
  // tile's barrier
  auto stage = [&](long long k, int b) {
    const long long r0 = k * kF32TileRows - back;
    int* sc = scodes + b * kF32CodeSlots;
    for (int i = threadIdx.x; i < kF32CodeSlots; i += kF32Threads) {
      const long long r = r0 + i;
      if (r >= 0 && r < n) {
        cp_async4(sc + i, codes + r);
      } else {
        sc[i] = -1;
      }
    }
  };
  int buf = 0;
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x, buf ^= 1) {
    int* sc = scodes + buf * kF32CodeSlots;
    cp_async_wait_all();
    int kept = 0;
    for (int i = threadIdx.x; i < kF32CodeSlots; i += kF32Threads) {
      kept |= static_cast<unsigned>(sc[i]) < ucap;
    }
    // every warp is done with the other buffer, and this one is whole
    kept = __syncthreads_or(kept);
    if (k + gridDim.x < tiles) stage(k + gridDim.x, buf ^ 1);
    if (!kept) continue;  // block-uniform
    const long long first = k * tile_vectors;
    const int len = static_cast<int>(min(tile_vectors, vectors - first));
    const float4* tile = base + first;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 v[kF32Chunk];
#pragma unroll
    for (int u = 0; u < kF32Chunk; ++u) {
      const int j = threadIdx.x + u * kF32Threads;
      v[u] = j < len ? __ldcs(tile + j) : zero;
    }
    // lane l's float of round 0 of the warp's first slab
    const int le = off0 + 128 * warp + lane;
    int row = le / p, col = le - row * p;
    for (int j0 = 0; j0 < len; j0 += kF32Chunk * kF32Threads) {
#pragma unroll
      for (int u = 0; u < kF32Chunk; ++u) {
        __syncwarp();
        my_turn[lane] = v[u];
        __syncwarp();
        // the next chunk's vector u loads while this one is added
        const int j = j0 + kF32Chunk * kF32Threads + threadIdx.x + u * kF32Threads;
        v[u] = j < len ? __ldcs(tile + j) : zero;
#pragma unroll
        for (int rd = 0; rd < 4; ++rd) {
          // a float past the tile's vectors is a zero: it reads no code
          const float x = turned[32 * rd + lane];
          if (x != 0.0f) {
            const int code = sc[row];
            if (static_cast<unsigned>(code) < ucap) {
              f32_add<kTier>(mine, dst, code, col, p, x);
            }
          }
          f32_advance(row, col, round_rows, round_cols, p);
        }
        f32_advance(row, col, rest_rows, rest_cols, p);
      }
    }
  }

  if constexpr (kTier == kF32TierBlock) {
    __syncthreads();
    float* out = dst + static_cast<long long>(blockIdx.x) * entries;
    for (int i = threadIdx.x; i < entries; i += kF32Threads) {
      float s = tab[i];
      for (int c = 1; c < copies; ++c) s += tab[c * entries + i];
      out[i] = s;
    }
  }
}

// The second pass: entry e of out, the sum of the `parts` partial tables'
// entry e in a fixed order (warp w takes tables w, w + 8, ... in turn, then
// warp 0 adds the warps' sums in turn), so the result is the same on every
// run over the same partials. A block takes 32 entries.
__global__ void __launch_bounds__(32 * kF32MergeWarps)
f32_merge_kernel(const float* __restrict__ part, int parts, long long entries,
                 float* __restrict__ out) {
  __shared__ float acc_s[kF32MergeWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  float acc = 0.0f;
  if (e < entries) {
    for (int q = warp; q < parts; q += kF32MergeWarps) acc += part[q * entries + e];
  }
  acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || e >= entries) return;
  for (int w = 1; w < kF32MergeWarps; ++w) acc += acc_s[w][lane];
  out[e] = acc;
}

using F32Kernel = void (*)(const float4*, int, const int32_t*, float*, long long, int, int,
                           int);

// The first pass's kernel of a tier with its shared memory, or null for a
// tier this file does not take: a block tier whose copies of the cap x P
// table do not fit in a block's shared memory beside the staged codes and
// vectors.
F32Kernel f32_kernel(int tier, int cap, int p, int copies, size_t* smem) {
  if (cap <= 0 || p <= 0) return nullptr;
  *smem = kF32CodeBytes + kF32TurnBytes;
  if (tier == kF32TierGlobal) return f32_partial_kernel<kF32TierGlobal>;
  if (tier != kF32TierBlock || copies < 1) return nullptr;
  *smem += static_cast<size_t>(cap) * p * copies * 4;
  return *smem <= kF32MaxSmem ? f32_partial_kernel<kF32TierBlock> : nullptr;
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

// Reduce rows [0, n) into a table of encoded keys and a nonempty bitmap:
// the block's (CS == 1) or its cluster's (CS > 1) in shared memory, or, for
// the global tier, one table in device memory (CS == 1 again: the same
// atomics reach it through generic pointers). The grid's threads take the
// rows in turn. kRows = 4 reads 16-byte vectors (vals and codes 16-byte
// aligned, mask 4-byte aligned), kRows = 1 single rows.
template <int CS, bool kMin, bool kWarpAgg, int kRows>
__device__ __forceinline__ void k3_scan(unsigned long long* keys, unsigned int* bits, int shift,
                                        const long long* __restrict__ vals,
                                        const unsigned char* __restrict__ mask,
                                        const int32_t* __restrict__ codes, long long n,
                                        int cap) {
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
}

// The first pass: every block (CS == 1) or cluster of CS blocks holds one
// table of `slice` (x CS) entries in shared memory, reduces its share of the
// rows into it, and writes it out as partial table blockIdx.x / CS.
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

  k3_scan<CS, kMin, kWarpAgg, kRows>(keys, bits, shift, vals, mask, codes, n, cap);

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

// The global tier's first pass (caps past a cluster's tables, up to 2^22):
// 64-bit min/max and 32-bit or atomics on one table and bitmap in device
// memory, which the launcher fills with the identity and zeros; the second
// pass reads it as the one partial table.
template <bool kMin, int kRows>
__global__ void __launch_bounds__(kK3Threads)
k3_global_kernel(const long long* __restrict__ vals, const unsigned char* __restrict__ mask,
                 const int32_t* __restrict__ codes, unsigned long long* __restrict__ keys,
                 unsigned int* __restrict__ bits, long long n, int cap) {
  k3_scan<1, kMin, false, kRows>(keys, bits, 0, vals, mask, codes, n, cap);
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

// ---- K1 and K2 -----------------------------------------------------------------

constexpr int kPlaneChunk = 64;  // planes per launch pair
constexpr int kPlaneThreads = 1024;
constexpr int kPlaneBatch = 4;   // planes whose loads a thread has in flight at once
constexpr int kPlaneReduceWarps = 8;
// most shared memory a block may take (H100: 227 KB)
constexpr size_t kPlaneMaxSmem = 232448;
constexpr int kOpSum = 0, kOpMin = 1, kOpMax = 2;
constexpr int kTierBlock = 0, kTierGlobal = 1;

// The planes of one chunk, by value in the kernel's parameters.
struct PlanePtrs {
  const float* p[kPlaneChunk];
};

// What a plane value adds to its entry: the value itself for a sum (an
// integer in [0, 255] by K1's contract), the order key for a max, its
// complement for a min. 0 adds nothing: a zero, or the identity.
template <int kOp>
__device__ __forceinline__ unsigned plane_word(float v) {
  if constexpr (kOp == kOpSum) {
    return static_cast<unsigned>(v);
  } else {
    const unsigned k = f32_order_key(v);
    if constexpr (kOp == kOpMin) {
      return k == 0xff800000u ? 0u : ~k;  // +inf
    } else {
      return k == 0x007fffffu ? 0u : k;   // -inf
    }
  }
}

// An extreme's f32 from its table word (0: an empty segment, the identity).
template <int kOp>
__device__ __forceinline__ float plane_extreme(unsigned w) {
  if (w == 0u) return __int_as_float(kOp == kOpMin ? 0x7f800000 : 0xff800000);
  return f32_from_order_key(kOp == kOpMin ? ~w : w);
}

template <int kOp>
__device__ __forceinline__ void plane_table_add(unsigned* slot, unsigned w) {
  if constexpr (kOp == kOpSum) {
    atomicAdd(slot, w);
  } else if (w > *reinterpret_cast<volatile unsigned*>(slot)) {
    atomicMax(slot, w);  // most rows lose to the entry: read before the atomic
  }
}

// Reduce R consecutive rows from row0 (R = 4: one 16-byte vector per plane,
// R = 1: one row) into planes [j0, j0 + gp) of the table, entry j * cap +
// code. A row whose code lies outside [0, cap) loads no plane value.
template <int kOp, int R>
__device__ __forceinline__ void plane_rows(unsigned* tab, const PlanePtrs& planes, int j0,
                                           int gp, int cap, const int (&code)[R],
                                           long long row0) {
  bool ok[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ok[r] = static_cast<unsigned>(code[r]) < static_cast<unsigned>(cap);
    any = any || ok[r];
  }
  if (!any) return;
  for (int j = 0; j < gp; j += kPlaneBatch) {
    float v[kPlaneBatch][R];
#pragma unroll
    for (int u = 0; u < kPlaneBatch; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[u][r] = 0.0f;
      if (j + u >= gp) continue;
      const float* plane = planes.p[j0 + j + u] + row0;
      if constexpr (R == 4) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(plane));
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
        v[u][0] = __ldcs(plane);
      }
    }
#pragma unroll
    for (int u = 0; u < kPlaneBatch; ++u) {
      if (j + u >= gp) break;
      unsigned* col = tab + (j + u) * cap;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned w = ok[r] ? plane_word<kOp>(v[u][r]) : 0u;
        if (w != 0u) plane_table_add<kOp>(col + code[r], w);
      }
    }
  }
}

// The first pass of the block tier: block b works for plane group b /
// per_group (planes [g * group, g * group + gp)) on its share of the rows,
// reduces them into a table in shared memory and writes it as partial table
// b (group x cap words, plane-major). kRows = 4 reads 16-byte vectors (codes
// and planes 16-byte aligned), kRows = 1 single rows.
template <int kOp, int kRows>
__global__ void __launch_bounds__(kPlaneThreads)
plane_partial_kernel(const __grid_constant__ PlanePtrs planes,
                     const int32_t* __restrict__ codes, unsigned* __restrict__ part,
                     long long n, int cap, int nplanes, int group, int per_group) {
  extern __shared__ __align__(16) unsigned plane_smem[];
  const int g = blockIdx.x / per_group;
  const int share = blockIdx.x - g * per_group;
  const int j0 = g * group;
  const int gp = min(group, nplanes - j0);
  const int entries = gp * cap;
  unsigned* tab = plane_smem;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tab[i] = 0u;
  __syncthreads();

  const long long nthreads = static_cast<long long>(per_group) * blockDim.x;
  const long long tid = static_cast<long long>(share) * blockDim.x + threadIdx.x;
  // The next step's codes load while this step's planes do.
  if constexpr (kRows == 4) {
    const long long nq = n >> 2;
    const int4* quads = reinterpret_cast<const int4*>(codes);
    const int4 none = make_int4(-1, -1, -1, -1);
    long long q = tid;
    int4 c = q < nq ? __ldg(quads + q) : none;
    for (; q < nq; q += nthreads) {
      const int4 next = q + nthreads < nq ? __ldg(quads + q + nthreads) : none;
      const int code[4] = {c.x, c.y, c.z, c.w};
      plane_rows<kOp, 4>(tab, planes, j0, gp, cap, code, q << 2);
      c = next;
    }
    // the last n % 4 rows: the group's first threads
    if (tid < (n & 3)) {
      const long long r = (nq << 2) + tid;
      const int code[1] = {__ldg(codes + r)};
      plane_rows<kOp, 1>(tab, planes, j0, gp, cap, code, r);
    }
  } else {
    long long r = tid;
    int c = r < n ? __ldg(codes + r) : -1;
    for (; r < n; r += nthreads) {
      const int next = r + nthreads < n ? __ldg(codes + r + nthreads) : -1;
      const int code[1] = {c};
      plane_rows<kOp, 1>(tab, planes, j0, gp, cap, code, r);
      c = next;
    }
  }

  __syncthreads();
  unsigned* out = part + static_cast<long long>(blockIdx.x) * group * cap;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) out[i] = tab[i];
}

// The first pass of the global tier: one code-major table (entry code *
// nplanes + j) in device memory, zeroed by the launcher. Lanes cover (row,
// plane) pairs, plane fastest, so the atomics of one warp instruction fall
// on a few rows' adjacent entries and coalesce; lanes on one row share its
// code's load. The pairs advance by the grid's width with a carry, not a
// division.
template <int kOp>
__global__ void __launch_bounds__(kPlaneThreads)
plane_global_kernel(const __grid_constant__ PlanePtrs planes,
                    const int32_t* __restrict__ codes, unsigned* __restrict__ table,
                    long long n, int cap, int nplanes) {
  // the pointers in shared memory: the lanes of a warp read different ones
  __shared__ const float* ptrs[kPlaneChunk];
  if (threadIdx.x < nplanes) ptrs[threadIdx.x] = planes.p[threadIdx.x];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long step_rows = stride / nplanes;
  const int step_j = static_cast<int>(stride - step_rows * nplanes);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long row = first / nplanes;
  int j = static_cast<int>(first - row * nplanes);
  while (row < n) {
    const int code = __ldg(codes + row);
    if (static_cast<unsigned>(code) < static_cast<unsigned>(cap)) {
      const unsigned w = plane_word<kOp>(__ldg(ptrs[j] + row));
      if (w != 0u) plane_table_add<kOp>(table + static_cast<long long>(code) * nplanes + j, w);
    }
    row += step_rows;
    j += step_j;
    if (j >= nplanes) {
      j -= nplanes;
      ++row;
    }
  }
}

// An entry's result into out: an f64 sum, or a decoded f32 extreme.
template <int kOp, typename Acc>
__device__ __forceinline__ void plane_store(void* out, long long at, Acc acc) {
  if constexpr (kOp == kOpSum) {
    static_cast<double*>(out)[at] = static_cast<double>(acc);
  } else {
    static_cast<float*>(out)[at] = plane_extreme<kOp>(acc);
  }
}

// The global tier's second pass: its one table into out, one thread per
// entry e = c * nplanes + j, written to out[c * out_stride + out_col + j].
template <int kOp>
__global__ void plane_finish_kernel(const unsigned* __restrict__ table, int cap, int nplanes,
                                    void* __restrict__ out, int out_stride, int out_col) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(cap) * nplanes) return;
  const int c = static_cast<int>(e / nplanes);
  const int j = static_cast<int>(e - static_cast<long long>(c) * nplanes);
  plane_store<kOp>(out, static_cast<long long>(c) * out_stride + out_col + j, table[e]);
}

// The block tier's second pass: entry e = j * cap + c of the chunk
// (plane j, segment c), combined over the per_group partial tables of plane
// j's group, written to out[c * out_stride + out_col + j]. A block takes 32
// entries; its warps split the partial tables.
template <int kOp>
__global__ void __launch_bounds__(32 * kPlaneReduceWarps)
plane_merge_kernel(const unsigned* __restrict__ part, int cap, int nplanes, int group,
                   int per_group, void* __restrict__ out, int out_stride, int out_col) {
  using Acc = typename std::conditional<kOp == kOpSum, unsigned long long, unsigned>::type;
  __shared__ Acc acc_s[kPlaneReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool in = e < static_cast<long long>(nplanes) * cap;
  const int j = in ? static_cast<int>(e / cap) : 0;
  const int c = static_cast<int>(e - static_cast<long long>(j) * cap);
  Acc acc = 0;
  if (in) {
    const int g = j / group;
    const unsigned* src =
        part + (static_cast<long long>(g) * per_group * group + (j - g * group)) * cap + c;
    const long long table = static_cast<long long>(group) * cap;
#pragma unroll 4
    for (int p = warp; p < per_group; p += kPlaneReduceWarps) {
      const unsigned w = src[p * table];
      acc = kOp == kOpSum ? acc + w : (w > acc ? w : acc);
    }
  }
  acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || !in) return;
  for (int w = 1; w < kPlaneReduceWarps; ++w) {
    const Acc o = acc_s[w][lane];
    acc = kOp == kOpSum ? acc + o : (o > acc ? o : acc);
  }
  plane_store<kOp>(out, static_cast<long long>(c) * out_stride + out_col + j, acc);
}

using PlaneKernel = void (*)(PlanePtrs, const int32_t*, unsigned*, long long, int, int, int,
                             int);
using PlaneGlobalKernel = void (*)(PlanePtrs, const int32_t*, unsigned*, long long, int, int);

template <int kOp>
PlaneKernel plane_variant(bool vec) {
  return vec ? plane_partial_kernel<kOp, 4> : plane_partial_kernel<kOp, 1>;
}

// The first pass's kernel of the block tier (null for the global tier),
// with its shared memory size.
PlaneKernel plane_kernel(int op, int tier, int cap, int group, bool vec, size_t* smem) {
  *smem = static_cast<size_t>(group) * cap * 4;
  switch (tier == kTierGlobal ? -1 : op) {
    case kOpSum:
      return plane_variant<kOpSum>(vec);
    case kOpMin:
      return plane_variant<kOpMin>(vec);
    case kOpMax:
      return plane_variant<kOpMax>(vec);
    default:
      return nullptr;
  }
}

PlaneGlobalKernel plane_global_kernel_for(int op) {
  return op == kOpSum ? plane_global_kernel<kOpSum>
                      : op == kOpMin ? plane_global_kernel<kOpMin> : plane_global_kernel<kOpMax>;
}

// True for a tier this file takes: an op and tier in range, 1 to 64 planes,
// a group of 1 to nplanes planes, a global table of one group of every
// plane, a shared table within a block's shared memory.
bool plane_tier_ok(int op, int tier, int cap, int nplanes, int group) {
  if (op < kOpSum || op > kOpMax || tier < kTierBlock || tier > kTierGlobal || cap <= 0 ||
      nplanes <= 0 || nplanes > kPlaneChunk || group <= 0 || group > nplanes) {
    return false;
  }
  if (tier == kTierGlobal) return group == nplanes;
  return static_cast<size_t>(group) * cap * 4 <= kPlaneMaxSmem;
}

// As many blocks of `threads` threads as fit on the current device at once.
template <typename Kernel>
cudaError_t plane_occupancy(Kernel kernel, size_t smem, int* blocks,
                            int threads = kPlaneThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess) {
    return err;
  }
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// K1a's grid comes from plane_occupancy, for 1024-thread blocks
static_assert(kF32Threads == kPlaneThreads, "K1a sizes its grid by plane_occupancy");

// K1a's first pass takes more than 48 KB of shared memory in both tiers
// (the staged codes and vectors), only by this opt-in, allowed at the
// most a block holds once per device
constexpr int kF32MaxDevices = 64;
bool f32_ready[kF32MaxDevices];

cudaError_t allow_f32_smem() {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kF32MaxDevices && f32_ready[dev]) return cudaSuccess;
  for (const F32Kernel kernel : {f32_partial_kernel<kF32TierBlock>,
                                 f32_partial_kernel<kF32TierGlobal>}) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kF32MaxSmem));
    if (rc != cudaSuccess) return rc;
  }
  if (dev < kF32MaxDevices) f32_ready[dev] = true;
  return rc;
}


// ---- K7 ------------------------------------------------------------------------

constexpr int kK7Threads = 1024;       // the block and global tiers
constexpr int kK7ThreadTierThreads = 256;  // the thread tier: a table per thread
constexpr int kK7TierThread = 0, kK7TierBlock = 1, kK7TierGlobal = 2;
constexpr size_t kK7MaxSmem = 232448;

// The planes of one chunk (f32 or f64), by value in the kernel's parameters.
struct K7Ptrs {
  const void* p[kPlaneChunk];
};

// R consecutive values of a plane from p (R = 1, or one 16-byte vector: 4
// floats or 2 doubles), widened to f64.
template <typename T, int R>
__device__ __forceinline__ void k7_values(const T* p, double (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = static_cast<double>(__ldcs(p));
  } else if constexpr (sizeof(T) == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
}

// The codes of R consecutive rows (R = 4, 2: one 16- or 8-byte load).
template <int R>
__device__ __forceinline__ void k7_codes(const int32_t* c, int (&code)[R]) {
  if constexpr (R == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(c));
    code[0] = x.x;
    code[1] = x.y;
    code[2] = x.z;
    code[3] = x.w;
  } else if constexpr (R == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(c));
    code[0] = x.x;
    code[1] = x.y;
  } else {
    code[0] = __ldg(c);
  }
}

// v into entry (plane j of the block's group, code): the thread tier into
// this thread's own table (entry-major, thread fastest: no two threads
// share a word, so a plain add); the block tier into the block's table by a
// shared-memory atomic; the global tier into out by a device-memory atomic.
// out_col is the group's first column.
template <int kTier>
__device__ __forceinline__ void k7_add(double* tab, double* out, int j, int code, int cap,
                                       int out_stride, int out_col, double v) {
  if constexpr (kTier == kK7TierThread) {
    tab[(static_cast<long long>(j) * cap + code) * kK7ThreadTierThreads + threadIdx.x] += v;
  } else if constexpr (kTier == kK7TierBlock) {
    atomicAdd(tab + j * cap + code, v);
  } else {
    atomicAdd(out + static_cast<long long>(code) * out_stride + out_col + j, v);
  }
}

// Rows [row0, row0 + R) into planes [j0, j0 + gp): the codes first, and no
// plane value is loaded when every code lies outside [0, cap) (padding and
// filtered rows); a zero adds nothing and makes no add.
template <typename T, int R, int kTier>
__device__ __forceinline__ void k7_rows(double* tab, double* out, const K7Ptrs& planes, int j0,
                                        int gp, int cap, int out_stride, int out_col,
                                        const int32_t* __restrict__ codes,
                                        long long row0) {
  int code[R];
  k7_codes<R>(codes + row0, code);
  bool ok[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ok[r] = static_cast<unsigned>(code[r]) < static_cast<unsigned>(cap);
    any = any || ok[r];
  }
  if (!any) return;
  for (int j = 0; j < gp; j += kPlaneBatch) {
    double v[kPlaneBatch][R];
#pragma unroll
    for (int u = 0; u < kPlaneBatch; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[u][r] = 0.0;
      if (j + u < gp) k7_values<T, R>(static_cast<const T*>(planes.p[j0 + j + u]) + row0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kPlaneBatch; ++u) {
      if (j + u >= gp) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (ok[r] && v[u][r] != 0.0) {
          k7_add<kTier>(tab, out, j + u, code[r], cap, out_stride, out_col + j0, v[u][r]);
        }
      }
    }
  }
}

// The first pass of the thread, block and global tiers. Block b works for
// plane group b / per_group (planes [g * group, g * group + gp)) on its
// share of the rows, R rows a thread a step (R = 16 bytes of a plane when
// the codes and every plane are 16-byte aligned, else 1). The thread and
// block tiers keep a table of cap entries a plane (the thread tier one copy
// per thread) and write it as partial table b (group x cap doubles,
// plane-major); the thread tier first adds its threads' copies of each
// entry in a fixed order. The global tier adds into out.
template <typename T, int R, int kTier>
__global__ void __launch_bounds__(kK7Threads)
k7_partial_kernel(const __grid_constant__ K7Ptrs planes, const int32_t* __restrict__ codes,
                  double* __restrict__ part, double* __restrict__ out, long long n, int cap,
                  int nplanes, int group, int per_group, int out_stride, int out_col) {
  extern __shared__ __align__(16) double k7_smem[];
  const int g = blockIdx.x / per_group;
  const int share = blockIdx.x - g * per_group;
  const int j0 = g * group;
  const int gp = min(group, nplanes - j0);
  const int entries = gp * cap;
  if constexpr (kTier != kK7TierGlobal) {
    const int words = kTier == kK7TierThread ? entries * kK7ThreadTierThreads : entries;
    for (int i = threadIdx.x; i < words; i += blockDim.x) k7_smem[i] = 0.0;
    __syncthreads();
  }
  const long long nthreads = static_cast<long long>(per_group) * blockDim.x;
  const long long tid = static_cast<long long>(share) * blockDim.x + threadIdx.x;
  const long long nv = n / R;
  for (long long q = tid; q < nv; q += nthreads) {
    k7_rows<T, R, kTier>(k7_smem, out, planes, j0, gp, cap, out_stride, out_col, codes, q * R);
  }
  // the last n % R rows: the group's first threads
  if (tid < n - nv * R) {
    k7_rows<T, 1, kTier>(k7_smem, out, planes, j0, gp, cap, out_stride, out_col, codes,
                         nv * R + tid);
  }
  if constexpr (kTier != kK7TierGlobal) {
    __syncthreads();
    double* dst = part + static_cast<long long>(blockIdx.x) * group * cap;
    if constexpr (kTier == kK7TierBlock) {
      for (int i = threadIdx.x; i < entries; i += blockDim.x) dst[i] = k7_smem[i];
    } else {
      // warp w takes entries w, w + warps, ...: lane l adds copies l, l +
      // 32, ..., then the lanes combine in a fixed tree
      const int lane = threadIdx.x & 31;
      const int warps = blockDim.x >> 5;
      for (int i = threadIdx.x >> 5; i < entries; i += warps) {
        const double* copies = k7_smem + static_cast<long long>(i) * kK7ThreadTierThreads;
        double s = 0.0;
        for (int t = lane; t < kK7ThreadTierThreads; t += 32) s += copies[t];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFullWarp, s, o);
        if (lane == 0) dst[i] = s;
      }
    }
  }
}

// The second pass of the thread and block tiers: entry e = j * cap + c of
// the chunk (plane j, segment c), the sum of the per_group partial tables of
// plane j's group in a fixed order (warp w takes tables w, w + 8, ..., then
// warp 0 adds the warps' sums in turn), written to out[c * out_stride +
// out_col + j]. A block takes 32 entries.
__global__ void __launch_bounds__(32 * kPlaneReduceWarps)
k7_merge_kernel(const double* __restrict__ part, int cap, int nplanes, int group, int per_group,
                double* __restrict__ out, int out_stride, int out_col) {
  __shared__ double acc_s[kPlaneReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool in = e < static_cast<long long>(nplanes) * cap;
  const int j = in ? static_cast<int>(e / cap) : 0;
  const int c = static_cast<int>(e - static_cast<long long>(j) * cap);
  double acc = 0.0;
  if (in) {
    const int g = j / group;
    const double* src =
        part + (static_cast<long long>(g) * per_group * group + (j - g * group)) * cap + c;
    const long long table = static_cast<long long>(group) * cap;
    for (int p = warp; p < per_group; p += kPlaneReduceWarps) acc += src[p * table];
  }
  acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || !in) return;
  for (int w = 1; w < kPlaneReduceWarps; ++w) acc += acc_s[w][lane];
  out[static_cast<long long>(c) * out_stride + out_col + j] = acc;
}

// ---- K7's warp tier: rings of tiles filled by bulk copies ---------------------

// Every row of a tile goes through shared memory. Warp 0 keeps the codes of
// the block's tiles in flight, by cp.async.bulk into a ring of code stages;
// warp 1 reads each tile's codes once they land and loads only the runs of
// kK7RunRows rows of each plane that hold a row with a code in [0, cap)
// into a ring of plane stages (a tile of padding or of filtered rows loads
// no plane value); the consumer warps add the tiles whose planes have
// landed, each into its own table. Every stage completes on an mbarrier,
// and the consumers free it on another.
constexpr int kK7TierWarp = 3;
constexpr int kK7WarpCopies = 16;    // the consumer warps, a table each
constexpr int kK7Loaders = 2;        // the codes' loader and the planes' loader
constexpr int kK7Tile = 2048;        // rows a stage holds
constexpr int kK7MaxStages = 4;      // plane stages; code stages are twice as many
constexpr int kK7RunShift = 8;       // the runs whose plane values load together:
constexpr int kK7RunRows = 1 << kK7RunShift;  // 256 rows, 8 a tile
constexpr size_t kK7Reserve = 1024;  // shared memory kept for the barriers

__device__ __forceinline__ unsigned k7_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void k7_bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(k7_smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void k7_bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   k7_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void k7_bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(k7_smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void k7_bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(k7_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void k7_bulk_load(void* dst, uintptr_t src, unsigned bytes,
                                             unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(k7_smem_addr(dst)), "l"(src), "r"(bytes), "r"(k7_smem_addr(bar))
      : "memory");
}

// Bytes of one code stage and of one plane stage (`group` planes), each
// array with 16 bytes of room for a start off 16-byte alignment.
__host__ __device__ __forceinline__ size_t k7_code_stage_bytes(int tile) {
  return static_cast<size_t>(tile) * 4 + 16;
}

__host__ __device__ __forceinline__ size_t k7_plane_stage_bytes(int tile, int group,
                                                                int esize) {
  return static_cast<size_t>(group) * (static_cast<size_t>(tile) * esize + 16);
}

// The 16-byte aligned byte range that holds elements [r0, r1) of an array
// at `base` with `esize`-byte elements: loads never leave the 16-byte
// blocks that hold an element of the array.
__device__ __forceinline__ void k7_span(uintptr_t base, long long r0, long long r1, int esize,
                                        uintptr_t* a0, unsigned* bytes) {
  const uintptr_t lo = (base + static_cast<uintptr_t>(r0) * esize) & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = (base + static_cast<uintptr_t>(r1) * esize + 15) &
                       ~static_cast<uintptr_t>(15);
  *a0 = lo;
  *bytes = static_cast<unsigned>(hi - lo);
}

// Row `r` of a lane's values of planes [jb, jb + left) (up to B of them)
// added into `row` (entry (jb, code), planes cap entries apart): the old
// entries are all loaded before any is stored, and a zero makes no store.
template <int B, int R>
__device__ __forceinline__ void k7_row_add(double* row, int cap, int left,
                                           const double (&v)[B][R], int r) {
  double old[B];
#pragma unroll
  for (int u = 0; u < B; ++u) old[u] = u < left ? row[u * cap] : 0.0;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    if (u < left && v[u][r] != 0.0) row[u * cap] = old[u] + v[u][r];
  }
}

// Run [q0, q1) of `runs` (the lowest stretch of set bits), cleared from it.
__device__ __forceinline__ void k7_next_run(unsigned* runs, int* q0, int* q1) {
  *q0 = __ffs(*runs) - 1;
  const unsigned above = ~*runs & ~((1u << *q0) - 1);
  *q1 = __ffs(above) - 1;  // runs hold kK7Tile / kK7RunRows bits: bit 31 of above is set
  *runs &= ~((1u << *q1) - 1);
}

// R consecutive values from a stage (R = 4: one 16-byte load of floats, or
// two of doubles), widened to f64.
template <typename T, int R>
__device__ __forceinline__ void k7_stage_values(const unsigned char* p, double (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = static_cast<double>(*reinterpret_cast<const T*>(p));
  } else if constexpr (sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const double2 x = *reinterpret_cast<const double2*>(p);
    const double2 y = *reinterpret_cast<const double2*>(p + 16);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = y.x;
    v[3] = y.y;
  }
}

// The first pass of the warp tier. Block b works for plane group b /
// per_group on tiles share, share + per_group, ... of kK7Tile rows. Each
// consumer lane takes R consecutive rows of a tile a step (R = 4 when the
// codes and every plane of the chunk start on a 16-byte boundary, else 1).
// The shared memory holds a table per consumer warp, then `2 x
// plane_stages` code stages and `plane_stages` plane stages. The block then
// adds its warps' tables in a fixed order into partial table b.
template <typename T, int R>
__global__ void __launch_bounds__(32 * (kK7WarpCopies + kK7Loaders), 1)
k7_warp_kernel(const __grid_constant__ K7Ptrs planes, const int32_t* __restrict__ codes,
               double* __restrict__ part, long long n, int cap, int nplanes, int group,
               int per_group, int plane_stages) {
  constexpr int tile = kK7Tile;
  extern __shared__ __align__(128) unsigned char k7_warp_smem[];
  __shared__ __align__(8) unsigned long long code_full[2 * kK7MaxStages];
  __shared__ __align__(8) unsigned long long code_free[2 * kK7MaxStages];
  __shared__ __align__(8) unsigned long long plane_full[kK7MaxStages];
  __shared__ __align__(8) unsigned long long plane_free[kK7MaxStages];
  constexpr int esize = sizeof(T);
  const int code_stages = 2 * plane_stages;
  const int consumers = blockDim.x / 32 - kK7Loaders;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x / per_group;
  const int share = blockIdx.x - g * per_group;
  const int j0 = g * group;
  const int gp = min(group, nplanes - j0);
  const int copies = consumers;
  const int entries = gp * cap;
  double* tab = reinterpret_cast<double*>(k7_warp_smem);
  const size_t table_bytes =
      (static_cast<size_t>(copies) * group * cap * 8 + 127) & ~static_cast<size_t>(127);
  unsigned char* code_ring = k7_warp_smem + table_bytes;
  const size_t code_bytes = k7_code_stage_bytes(tile);
  unsigned char* plane_ring = code_ring + code_stages * code_bytes;
  const size_t plane_bytes = static_cast<size_t>(tile) * esize + 16;  // one plane
  const size_t stage_bytes = k7_plane_stage_bytes(tile, group, esize);
  const uintptr_t cbase = reinterpret_cast<uintptr_t>(codes);
  const int clead = static_cast<int>(cbase & 15);

  for (int i = threadIdx.x; i < copies * entries; i += blockDim.x) tab[i] = 0.0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < code_stages; ++s) {
      k7_bar_init(&code_full[s], 1);
      k7_bar_init(&code_free[s], consumers);
    }
    for (int s = 0; s < plane_stages; ++s) {
      k7_bar_init(&plane_full[s], 1);
      k7_bar_init(&plane_free[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (n + tile - 1) / tile;
  const long long count = ntiles > share ? (ntiles - share + per_group - 1) / per_group : 0;
  if (warp == 0) {
    // the codes' loader: tile k into code stage k % code_stages
    if (lane == 0) {
      for (long long k = 0; k < count; ++k) {
        const int s = static_cast<int>(k % code_stages);
        if (k >= code_stages) {
          k7_bar_wait(&code_free[s], static_cast<unsigned>((k / code_stages - 1) & 1));
        }
        const long long r0 = (share + k * per_group) * tile;
        uintptr_t a0;
        unsigned bytes;
        k7_span(cbase, r0, min(r0 + tile, n), 4, &a0, &bytes);
        k7_bar_expect(&code_full[s], bytes);
        k7_bulk_load(code_ring + s * code_bytes, a0, bytes, &code_full[s]);
      }
    }
  } else if (warp == 1) {
    // the planes' loader: 256-row runs only when every plane starts on a
    // 16-byte boundary (a run's range then never shares a 16-byte block
    // with the next run's); else the tile's one run
    bool aligned = true;
    for (int j = 0; j < gp; ++j) {
      aligned = aligned && (reinterpret_cast<uintptr_t>(planes.p[j0 + j]) & 15) == 0;
    }
    const int shift = aligned ? kK7RunShift : 31 - __clz(tile);
    for (long long k = 0; k < count; ++k) {
      const int cs = static_cast<int>(k % code_stages);
      const int ps = static_cast<int>(k % plane_stages);
      const long long r0 = (share + k * per_group) * tile;
      const int rows = static_cast<int>(min(static_cast<long long>(tile), n - r0));
      k7_bar_wait(&code_full[cs], static_cast<unsigned>((k / code_stages) & 1));
      const unsigned char* cst = code_ring + cs * code_bytes + clead;
      unsigned runs = 0;  // bit q: run q holds a kept row
      if (clead == 0) {
        for (int i0 = 0; i0 < rows; i0 += 128) {
          const int i = i0 + lane * 4;
          const int4 c = *reinterpret_cast<const int4*>(cst + i * 4);
          const unsigned u = static_cast<unsigned>(cap);
          const bool kept = (i < rows && static_cast<unsigned>(c.x) < u) ||
                            (i + 1 < rows && static_cast<unsigned>(c.y) < u) ||
                            (i + 2 < rows && static_cast<unsigned>(c.z) < u) ||
                            (i + 3 < rows && static_cast<unsigned>(c.w) < u);
          if (__any_sync(kFullWarp, kept)) runs |= 1u << (i0 >> shift);
        }
      } else {
        for (int i0 = 0; i0 < rows; i0 += 32) {
          const int i = i0 + lane;
          const bool kept = i < rows && static_cast<unsigned>(reinterpret_cast<const int*>(
                                            cst)[i]) < static_cast<unsigned>(cap);
          if (__any_sync(kFullWarp, kept)) runs |= 1u << (i0 >> shift);
        }
      }
      if (k >= plane_stages) {
        k7_bar_wait(&plane_free[ps], static_cast<unsigned>((k / plane_stages - 1) & 1));
      }
      // each stretch of kept runs loads as one copy per plane, lane j
      // issuing plane j's
      unsigned total = 0;
      for (int j = lane; j < gp; j += 32) {
        const uintptr_t base = reinterpret_cast<uintptr_t>(planes.p[j0 + j]);
        for (unsigned left = runs; left;) {
          int q0, q1;
          k7_next_run(&left, &q0, &q1);
          uintptr_t a0;
          unsigned bytes;
          k7_span(base, r0 + (q0 << shift), min(r0 + (static_cast<long long>(q1) << shift),
                                                r0 + rows), esize, &a0, &bytes);
          total += bytes;
        }
      }
      total = __reduce_add_sync(kFullWarp, total);
      if (lane == 0) k7_bar_expect(&plane_full[ps], total);
      __syncwarp();
      unsigned char* pst = plane_ring + ps * stage_bytes;
      for (int j = lane; j < gp; j += 32) {
        const uintptr_t base = reinterpret_cast<uintptr_t>(planes.p[j0 + j]);
        const uintptr_t lo0 =
            (base + static_cast<uintptr_t>(r0) * esize) & ~static_cast<uintptr_t>(15);
        for (unsigned left = runs; left;) {
          int q0, q1;
          k7_next_run(&left, &q0, &q1);
          uintptr_t a0;
          unsigned bytes;
          k7_span(base, r0 + (q0 << shift), min(r0 + (static_cast<long long>(q1) << shift),
                                                r0 + rows), esize, &a0, &bytes);
          k7_bulk_load(pst + j * plane_bytes + (a0 - lo0), a0, bytes, &plane_full[ps]);
        }
      }
    }
  } else {
    const int c = warp - kK7Loaders;
    const unsigned below = (1u << lane) - 1;
    double* mine = tab + static_cast<long long>(c) * entries;
    for (long long k = 0; k < count; ++k) {
      const int cs = static_cast<int>(k % code_stages);
      const int ps = static_cast<int>(k % plane_stages);
      k7_bar_wait(&code_full[cs], static_cast<unsigned>((k / code_stages) & 1));
      k7_bar_wait(&plane_full[ps], static_cast<unsigned>((k / plane_stages) & 1));
      const long long r0 = (share + k * per_group) * tile;
      const int rows = static_cast<int>(min(static_cast<long long>(tile), n - r0));
      const unsigned char* cst = code_ring + cs * code_bytes + clead;
      const unsigned char* pst = plane_ring + ps * stage_bytes;
      for (int i0 = c * 32 * R; i0 < rows; i0 += consumers * 32 * R) {
        const int i = i0 + lane * R;
        int code[R];
        bool ok[R];
        bool any = false;
        if constexpr (R == 4) {
          const int4 x = *reinterpret_cast<const int4*>(cst + i * 4);
          code[0] = x.x;
          code[1] = x.y;
          code[2] = x.z;
          code[3] = x.w;
        } else {
          code[0] = reinterpret_cast<const int*>(cst)[i];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ok[r] = i + r < rows && static_cast<unsigned>(code[r]) < static_cast<unsigned>(cap);
          any = any || ok[r];
        }
        if (!__any_sync(kFullWarp, any)) continue;
        // each of the lane's rows in turn: the lanes with one code, rank 0
        // the lowest lane; most < 0 where no lane keeps its row
        unsigned peers[R];
        int rank[R], most[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          most[r] = -1;
          rank[r] = 0;
          if (__any_sync(kFullWarp, ok[r])) {
            peers[r] = __match_any_sync(kFullWarp, ok[r] ? code[r] : -1);
            rank[r] = __popc(peers[r] & below);
            most[r] = __reduce_max_sync(kFullWarp, ok[r] ? rank[r] : 0);
          }
        }
        // no other warp writes this table: the lanes of one code add in rank
        // order, a round each, with plain loads and stores, kPlaneBatch
        // planes at a time (their values read only where a row of the lane
        // is kept: else their run may not have been loaded)
        for (int jb = 0; jb < gp; jb += kPlaneBatch) {
          double v[kPlaneBatch][R];
#pragma unroll
          for (int u = 0; u < kPlaneBatch; ++u) {
#pragma unroll
            for (int r = 0; r < R; ++r) v[u][r] = 0.0;
            if (any && jb + u < gp) {
              const uintptr_t base = reinterpret_cast<uintptr_t>(planes.p[j0 + jb + u]);
              k7_stage_values<T, R>(pst + (jb + u) * plane_bytes + (base & 15) + i * esize,
                                    v[u]);
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (most[r] < 0) continue;
            // the lowest lane of each code sums its lanes' values in lane order
            unsigned rest = peers[r] & ~(1u << lane);
            double w[kPlaneBatch][1];
#pragma unroll
            for (int u = 0; u < kPlaneBatch; ++u) w[u][0] = v[u][r];
            for (int q = 0; q < most[r]; ++q) {
              const bool take = rank[r] == 0 && rest != 0;
              const int src = take ? __ffs(rest) - 1 : lane;
#pragma unroll
              for (int u = 0; u < kPlaneBatch; ++u) {
                const double x = __shfl_sync(kFullWarp, v[u][r], src);
                if (take) w[u][0] += x;
              }
              if (take) rest &= rest - 1;
            }
            if (ok[r] && rank[r] == 0) {
              k7_row_add<kPlaneBatch, 1>(mine + jb * cap + code[r], cap, gp - jb, w, 0);
            }
            __syncwarp();
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        k7_bar_arrive(&code_free[cs]);
        k7_bar_arrive(&plane_free[ps]);
      }
    }
  }
  __syncthreads();
  // partial table b: the block's copies added in a fixed order
  double* dst = part + static_cast<long long>(blockIdx.x) * group * cap;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    double sum = 0.0;
    for (int t = 0; t < copies; ++t) sum += tab[static_cast<long long>(t) * entries + i];
    dst[i] = sum;
  }
}

using K7Kernel = void (*)(K7Ptrs, const int32_t*, double*, double*, long long, int, int, int,
                          int, int, int);
using K7WarpKernel = void (*)(K7Ptrs, const int32_t*, double*, long long, int, int, int, int,
                              int);

template <typename T, int R>
K7Kernel k7_variant(int tier) {
  if (tier == kK7TierThread) return k7_partial_kernel<T, R, kK7TierThread>;
  if (tier == kK7TierBlock) return k7_partial_kernel<T, R, kK7TierBlock>;
  return k7_partial_kernel<T, R, kK7TierGlobal>;
}

// The thread, block and global tiers' first pass: f64 or f32 planes,
// 16-byte vectors or single rows.
K7Kernel k7_kernel(int f64, int tier, bool vec) {
  if (f64) return vec ? k7_variant<double, 2>(tier) : k7_variant<double, 1>(tier);
  return vec ? k7_variant<float, 4>(tier) : k7_variant<float, 1>(tier);
}

// The warp tier's first pass: f64 or f32 planes, 4 rows a lane (every
// array 16-byte aligned) or one.
K7WarpKernel k7_warp_kernel_for(int f64, bool vec) {
  if (f64) return vec ? k7_warp_kernel<double, 4> : k7_warp_kernel<double, 1>;
  return vec ? k7_warp_kernel<float, 4> : k7_warp_kernel<float, 1>;
}

int k7_threads(int tier) {
  if (tier == kK7TierThread) return kK7ThreadTierThreads;
  if (tier == kK7TierWarp) return 32 * (kK7WarpCopies + kK7Loaders);
  return kK7Threads;
}

// The warp tier's launch shape: its tables, then the most plane stages (4
// down to 2, with twice as many code stages) that fit beside them.
struct K7Ring {
  size_t smem;
  int plane_stages;
};

bool k7_warp_plan(int cap, int group, int esize, K7Ring* plan) {
  const size_t table =
      (static_cast<size_t>(kK7WarpCopies) * group * cap * 8 + 127) & ~static_cast<size_t>(127);
  for (int stages = kK7MaxStages; stages >= 2; --stages) {
    const size_t smem = table + 2 * stages * k7_code_stage_bytes(kK7Tile) +
                        stages * k7_plane_stage_bytes(kK7Tile, group, esize);
    if (smem + kK7Reserve <= kK7MaxSmem) {
      *plan = {smem, stages};
      return true;
    }
  }
  return false;
}

// A block's shared memory at the thread or block tier: one copy of its
// table per thread, or one table.
size_t k7_smem_bytes(int tier, int cap, int group) {
  if (tier == kK7TierThread) return static_cast<size_t>(group) * cap * 8 * kK7ThreadTierThreads;
  if (tier == kK7TierBlock) return static_cast<size_t>(group) * cap * 8;
  return 0;
}

// True for a tier this file takes: a tier in range, 1 to 64 planes, a group
// of 1 to nplanes planes, the global tier's one group of every plane, the
// thread and block tiers' tables within a block's shared memory, the warp
// tier's tables and smallest ring too.
bool k7_tier_ok(int tier, int cap, int nplanes, int group, int esize) {
  if (tier < kK7TierThread || tier > kK7TierWarp || cap <= 0 || nplanes <= 0 ||
      nplanes > kPlaneChunk || group <= 0 || group > nplanes) {
    return false;
  }
  if (tier == kK7TierGlobal) return group == nplanes;
  if (tier == kK7TierThread || tier == kK7TierBlock) {
    return k7_smem_bytes(tier, cap, group) <= kK7MaxSmem;
  }
  K7Ring plan;
  return k7_warp_plan(cap, group, esize, &plan);
}

}  // namespace

extern "C" {

// K1 and K2's first-pass blocks that fit on the current device at once at a
// tier (op 0 sum, 1 min, 2 max; tier 0 block, 1 global), for a
// chunk of nplanes planes in tables of `group` planes.
int daft_segment_planes_blocks(int op, int tier, int cap, int nplanes, int group,
                               int* blocks) {
  if (!plane_tier_ok(op, tier, cap, nplanes, group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tier == kTierGlobal) {
    return static_cast<int>(plane_occupancy(plane_global_kernel_for(op), 0, blocks));
  }
  size_t smem = 0;
  const PlaneKernel kernel = plane_kernel(op, tier, cap, group, true, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(plane_occupancy(kernel, smem, blocks));
}

// K1 (op 0) and K2 (op 1 min, 2 max) over one chunk of nplanes <= 64 planes
// (`planes`: a host array of device pointers, copied into the kernel's
// parameters): out (cap x out_stride; f64 for K1, f32 for K2) gets columns
// [out_col, out_col + nplanes). `blocks` first-pass blocks: block tier,
// ceil(nplanes / group) groups of equally many blocks, each writing
// a partial table of group x cap words into `part`; global tier, a grid of
// `blocks` on one table of cap x nplanes words in `part`. Two launches: the
// tables, then their combination into out.
int daft_segment_planes(int op, const void* const* planes, int nplanes, const void* codes,
                        void* part, void* out, long long n, int cap, int tier, int group,
                        int blocks, int out_stride, int out_col, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plane_tier_ok(op, tier, cap, nplanes, group) || blocks <= 0 || out_col < 0 ||
      out_col + nplanes > out_stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanePtrs ptrs = {};
  bool vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  for (int j = 0; j < nplanes; ++j) {
    ptrs.p[j] = static_cast<const float*>(planes[j]);
    vec = vec && (reinterpret_cast<uintptr_t>(planes[j]) & 15) == 0;
  }
  const int32_t* c = static_cast<const int32_t*>(codes);
  unsigned* p = static_cast<unsigned*>(part);
  const long long entries = static_cast<long long>(nplanes) * cap;
  cudaError_t err;
  if (tier == kTierGlobal) {
    err = cudaMemsetAsync(part, 0, static_cast<size_t>(entries) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const PlaneGlobalKernel kernel = plane_global_kernel_for(op);
    kernel<<<blocks, kPlaneThreads, 0, s>>>(ptrs, c, p, n, cap, nplanes);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int finish_blocks = static_cast<int>((entries + kThreads - 1) / kThreads);
    if (op == kOpSum) {
      plane_finish_kernel<kOpSum><<<finish_blocks, kThreads, 0, s>>>(p, cap, nplanes, out,
                                                                     out_stride, out_col);
    } else if (op == kOpMin) {
      plane_finish_kernel<kOpMin><<<finish_blocks, kThreads, 0, s>>>(p, cap, nplanes, out,
                                                                     out_stride, out_col);
    } else {
      plane_finish_kernel<kOpMax><<<finish_blocks, kThreads, 0, s>>>(p, cap, nplanes, out,
                                                                     out_stride, out_col);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = (nplanes + group - 1) / group;
  if (blocks % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const PlaneKernel kernel = plane_kernel(op, tier, cap, group, vec, &smem);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tables = blocks / groups;
  kernel<<<blocks, kPlaneThreads, smem, s>>>(ptrs, c, p, n, cap, nplanes, group, tables);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int merge_blocks = static_cast<int>((entries + 31) / 32);
  if (op == kOpSum) {
    plane_merge_kernel<kOpSum><<<merge_blocks, 32 * kPlaneReduceWarps, 0, s>>>(
        p, cap, nplanes, group, tables, out, out_stride, out_col);
  } else if (op == kOpMin) {
    plane_merge_kernel<kOpMin><<<merge_blocks, 32 * kPlaneReduceWarps, 0, s>>>(
        p, cap, nplanes, group, tables, out, out_stride, out_col);
  } else {
    plane_merge_kernel<kOpMax><<<merge_blocks, 32 * kPlaneReduceWarps, 0, s>>>(
        p, cap, nplanes, group, tables, out, out_stride, out_col);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1a's first-pass grid for a tier (0 block, 1 global) on the current
// device: as many blocks as fit on the card at once. The block tier writes
// that many partial tables of cap x P floats.
int daft_segment_sum_planes_f32_parts(int tier, int cap, int p, int copies, int* parts) {
  size_t smem = 0;
  const F32Kernel kernel = f32_kernel(tier, cap, p, copies, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_f32_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(plane_occupancy(kernel, smem, parts));
}

// K1a: planes (n x P f32, row-major, 4-byte aligned), codes (n int32), out
// (cap x P f32). The block tier writes `parts` partial tables of cap x P
// floats into `part` and combines them into out in a second launch; the
// global tier adds into out, which the caller zero-fills (part unused).
// `parts` comes from daft_segment_sum_planes_f32_parts for the same tier,
// cap, P and copies on this device, which also allows the shared memory
// there.
int daft_segment_sum_planes_f32(const void* planes, const void* codes, void* part, void* out,
                                long long n, int p, int cap, int tier, int copies, int parts,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  const F32Kernel kernel = f32_kernel(tier, cap, p, copies, &smem);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(planes);
  if (kernel == nullptr || parts <= 0 || n <= 0 || (addr & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const float4* base = reinterpret_cast<const float4*>(addr & ~static_cast<uintptr_t>(15));
  const int lead = static_cast<int>((addr & 15) >> 2);
  kernel<<<parts, kF32Threads, smem, s>>>(base, lead, static_cast<const int32_t*>(codes),
                                          static_cast<float*>(tier == kF32TierGlobal ? out
                                                                                     : part),
                                          n, p, cap, copies);
  if ((err = cudaGetLastError()) != cudaSuccess || tier == kF32TierGlobal) {
    return static_cast<int>(err);
  }
  const long long entries = static_cast<long long>(cap) * p;
  f32_merge_kernel<<<static_cast<int>((entries + 31) / 32), 32 * kF32MergeWarps, 0, s>>>(
      static_cast<const float*>(part), parts, entries, static_cast<float*>(out));
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

// K3's global tier (caps past a cluster's tables): the grid of its first
// pass on the current device, as many 1024-thread blocks as fit at once.
int daft_segment_extreme_int64_global_blocks(int* blocks) {
  return static_cast<int>(plane_occupancy(k3_global_kernel<true, 4>, 0, blocks, kK3Threads));
}

// K3's global tier: keys (cap_pad uint64) and bits (cap_pad / 32 uint32) are
// scratch, filled here with the identity and zeros; out (cap, int64) and
// nonempty (cap, uint8) are written. Three steps on the stream: the fills,
// the atomics of `blocks` blocks, then the decode (K3's second pass over
// one partial table).
int daft_segment_extreme_int64_global(const void* vals, const void* mask, const void* codes,
                                      void* keys, void* bits, void* out, void* nonempty,
                                      long long n, int cap, int cap_pad, int blocks,
                                      int is_min, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap <= 0 || cap_pad < cap || cap_pad % 32 != 0 || blocks <= 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (reinterpret_cast<uintptr_t>(vals) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  cudaError_t err = cudaMemsetAsync(keys, is_min ? 0xff : 0, static_cast<size_t>(cap_pad) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(bits, 0, static_cast<size_t>(cap_pad) / 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* v = static_cast<const long long*>(vals);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const int32_t* c = static_cast<const int32_t*>(codes);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  unsigned int* b = static_cast<unsigned int*>(bits);
  using K3GlobalKernel = void (*)(const long long*, const unsigned char*, const int32_t*,
                                  unsigned long long*, unsigned int*, long long, int);
  const K3GlobalKernel kernel =
      is_min ? (vec ? k3_global_kernel<true, 4> : k3_global_kernel<true, 1>)
             : (vec ? k3_global_kernel<false, 4> : k3_global_kernel<false, 1>);
  kernel<<<blocks, kK3Threads, 0, s>>>(v, m, c, k, b, n, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int reduce_blocks = (cap + 31) / 32;
  if (is_min) {
    k3_reduce_kernel<true><<<reduce_blocks, 32 * kK3ReduceWarps, 0, s>>>(
        k, b, 1, cap, cap_pad, static_cast<long long*>(out),
        static_cast<unsigned char*>(nonempty));
  } else {
    k3_reduce_kernel<false><<<reduce_blocks, 32 * kK3ReduceWarps, 0, s>>>(
        k, b, 1, cap, cap_pad, static_cast<long long*>(out),
        static_cast<unsigned char*>(nonempty));
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's first-pass blocks that fit on the current device at once at a tier
// (0 thread, 1 block, 2 global, 3 warp), for a chunk of nplanes planes
// (f64 != 0: f64 planes, else f32) in tables of `group` planes; allows the
// kernel its shared memory there.
int daft_segment_sum_float_planes_blocks(int f64, int tier, int cap, int nplanes, int group,
                                         int* blocks) {
  const int esize = f64 ? 8 : 4;
  if (!k7_tier_ok(tier, cap, nplanes, group, esize)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (tier == kK7TierWarp) {
    K7Ring plan;
    k7_warp_plan(cap, group, esize, &plan);
    const K7WarpKernel kernel = k7_warp_kernel_for(f64, true);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(plane_occupancy(kernel, plan.smem, blocks, k7_threads(tier)));
  }
  const size_t smem = k7_smem_bytes(tier, cap, group);
  const K7Kernel kernel = k7_kernel(f64, tier, true);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(plane_occupancy(kernel, smem, blocks, k7_threads(tier)));
}

// K7 over one chunk of nplanes <= 64 planes (`planes`: a host array of
// device pointers to n values each, f64 or f32 by `f64`, copied into the
// kernel's parameters): out (cap x out_stride, f64) gets columns [out_col,
// out_col + nplanes). `blocks` first-pass blocks in ceil(nplanes / group)
// groups of equally many. The thread, warp and block tiers write a partial
// table of group x cap doubles per block into `part` and combine them into
// out in a second launch; the global tier adds into out, which the caller
// zero-fills.
int daft_segment_sum_float_planes(int f64, const void* const* planes, int nplanes,
                                  const void* codes, void* part, void* out, long long n, int cap,
                                  int tier, int group, int blocks, int out_stride, int out_col,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = f64 ? 8 : 4;
  if (!k7_tier_ok(tier, cap, nplanes, group, esize) || blocks <= 0 || n < 0 || out_col < 0 ||
      out_col + nplanes > out_stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (nplanes + group - 1) / group;
  if (blocks % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  K7Ptrs ptrs = {};
  bool vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  for (int j = 0; j < nplanes; ++j) {
    ptrs.p[j] = planes[j];
    vec = vec && (reinterpret_cast<uintptr_t>(planes[j]) & 15) == 0;
  }
  const int per_group = blocks / groups;
  const int32_t* c = static_cast<const int32_t*>(codes);
  cudaError_t err;
  if (tier == kK7TierWarp) {
    K7Ring plan;
    k7_warp_plan(cap, group, esize, &plan);
    const K7WarpKernel kernel = k7_warp_kernel_for(f64, vec);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, k7_threads(tier), plan.smem, s>>>(ptrs, c, static_cast<double*>(part), n,
                                                      cap, nplanes, group, per_group,
                                                      plan.plane_stages);
  } else {
    const size_t smem = k7_smem_bytes(tier, cap, group);
    const K7Kernel kernel = k7_kernel(f64, tier, vec);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, k7_threads(tier), smem, s>>>(ptrs, c, static_cast<double*>(part),
                                                  static_cast<double*>(out), n, cap, nplanes,
                                                  group, per_group, out_stride, out_col);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || tier == kK7TierGlobal) {
    return static_cast<int>(err);
  }
  const long long entries = static_cast<long long>(nplanes) * cap;
  k7_merge_kernel<<<static_cast<int>((entries + 31) / 32), 32 * kPlaneReduceWarps, 0, s>>>(
      static_cast<const double*>(part), cap, nplanes, group, per_group,
      static_cast<double*>(out), out_stride, out_col);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
