// The port's host kernel library: hashing, factorize, grouped sums and
// extremes, the bucket join, open-addressed int64 maps, the probe table's
// fused lookups and fills, and the selection vector of a boolean bitmap.
// Every kernel is one O(n) pass with a plain C interface, called through
// ctypes (daft_tpu_torch/native.py), which drops the GIL for the call.
//
// The same exports, arguments and results as the reference's
// native/src/kernels.cpp, kept as the port's own source, and exports of the
// port's own: png_unfilter (the PNG codec, core/kernels/png.py), the JPEG
// codec's stages (core/kernels/jpeg.py), cv2's uint8 resize
// (core/kernels/image.py) and the tokenizer-file reader's split and word
// cache (functions/tokenizer_file.py), and LZ4's block and frame codec with
// xxh32 (io/arrow_ipc.py's LZ4_FRAME bodies). Built at first use
// by ops/_build.py ``host_library`` with the host compiler (``$CXX``, else
// ``c++``) into ops/_kbuild/.
//
// Conventions every caller keeps: a negative code never matches; an output
// buffer is allocated with at least one element (numpy's max(n, 1)), since
// a kernel writes nothing for n = 0 but takes the pointer.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------------
// xxhash64 (public domain algorithm, fresh implementation)
// ---------------------------------------------------------------------------------

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  acc *= P1;
  return acc;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = round1(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

uint64_t xxhash64(const uint8_t* data, uint64_t len, uint64_t seed) {
  uint64_t h;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    do {
      uint64_t k;
      memcpy(&k, p, 8); v1 = round1(v1, k); p += 8;
      memcpy(&k, p, 8); v2 = round1(v2, k); p += 8;
      memcpy(&k, p, 8); v3 = round1(v3, k); p += 8;
      memcpy(&k, p, 8); v4 = round1(v4, k); p += 8;
    } while (p + 32 <= end);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1); h = merge_round(h, v2);
    h = merge_round(h, v3); h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    uint64_t k; memcpy(&k, p, 8);
    h ^= round1(0, k);
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t k; memcpy(&k, p, 4);
    h ^= (uint64_t)k * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// hash a binary column given arrow offsets (int64) + data buffer
void hash_binary_column(const uint8_t* data, const int64_t* offsets, int64_t n,
                        uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = xxhash64(data + offsets[i], (uint64_t)(offsets[i + 1] - offsets[i]), seed);
  }
}

void hash_u64_column(const uint64_t* vals, int64_t n, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t v = vals[i];
    out[i] = xxhash64((const uint8_t*)&v, 8, seed);
  }
}

// ---------------------------------------------------------------------------------
// factorize: int64 keys -> dense first-occurrence codes (open addressing)
// ---------------------------------------------------------------------------------

int64_t factorize_i64(const int64_t* keys, int64_t n, int64_t* out_codes) {
  if (n == 0) return 0;
  // table size: next pow2 >= 2n
  uint64_t cap = 16;
  while (cap < (uint64_t)(n * 2)) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::vector<int64_t> slot_key(cap);
  std::vector<int64_t> slot_code(cap, -1);  // -1 = empty
  int64_t next_code = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t k = keys[i];
    uint64_t h = (uint64_t)k;
    // splitmix64 finalizer as the hash
    h ^= h >> 30; h *= 0xBF58476D1CE4E5B9ULL;
    h ^= h >> 27; h *= 0x94D049BB133111EBULL;
    h ^= h >> 31;
    uint64_t s = h & mask;
    for (;;) {
      int64_t c = slot_code[s];
      if (c == -1) {
        slot_key[s] = k;
        slot_code[s] = next_code;
        out_codes[i] = next_code;
        next_code++;
        break;
      }
      if (slot_key[s] == k) {
        out_codes[i] = c;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  return next_code;
}

// combine two compact code columns into pair codes, then factorize:
// out = factorize(a * (max_b + 2) + b) without materializing the pair array twice
int64_t combine_factorize_i64(const int64_t* a, const int64_t* b, int64_t n,
                              int64_t b_domain, int64_t* out_codes) {
  std::vector<int64_t> pair(n);
  const int64_t g = b_domain + 2;
  for (int64_t i = 0; i < n; i++) pair[i] = (a[i] + 1) * g + (b[i] + 1);
  return factorize_i64(pair.data(), n, out_codes);
}

// ---------------------------------------------------------------------------------
// grouped aggregation: single-pass scatter over group ids
// ---------------------------------------------------------------------------------

void grouped_sum_f64(const int64_t* gids, const double* vals, const uint8_t* valid,
                     int64_t n, int64_t num_groups, double* out_sum, int64_t* out_cnt) {
  memset(out_sum, 0, sizeof(double) * num_groups);
  memset(out_cnt, 0, sizeof(int64_t) * num_groups);
  for (int64_t i = 0; i < n; i++) {
    if (valid[i]) {
      out_sum[gids[i]] += vals[i];
      out_cnt[gids[i]]++;
    }
  }
}

void grouped_sum_i64(const int64_t* gids, const int64_t* vals, const uint8_t* valid,
                     int64_t n, int64_t num_groups, int64_t* out_sum, int64_t* out_cnt) {
  memset(out_sum, 0, sizeof(int64_t) * num_groups);
  memset(out_cnt, 0, sizeof(int64_t) * num_groups);
  for (int64_t i = 0; i < n; i++) {
    if (valid[i]) {
      out_sum[gids[i]] += vals[i];
      out_cnt[gids[i]]++;
    }
  }
}

void grouped_minmax_f64(const int64_t* gids, const double* vals, const uint8_t* valid,
                        int64_t n, int64_t num_groups, double* out_min, double* out_max) {
  for (int64_t g = 0; g < num_groups; g++) {
    out_min[g] = 1.0 / 0.0;   // +inf
    out_max[g] = -1.0 / 0.0;  // -inf
  }
  for (int64_t i = 0; i < n; i++) {
    if (valid[i]) {
      const int64_t g = gids[i];
      const double v = vals[i];
      if (v < out_min[g]) out_min[g] = v;
      if (v > out_max[g]) out_max[g] = v;
    }
  }
}

void grouped_minmax_i64(const int64_t* gids, const int64_t* vals, const uint8_t* valid,
                        int64_t n, int64_t num_groups, int64_t* out_min, int64_t* out_max) {
  for (int64_t g = 0; g < num_groups; g++) {
    out_min[g] = INT64_MAX;
    out_max[g] = INT64_MIN;
  }
  for (int64_t i = 0; i < n; i++) {
    if (valid[i]) {
      const int64_t g = gids[i];
      const int64_t v = vals[i];
      if (v < out_min[g]) out_min[g] = v;
      if (v > out_max[g]) out_max[g] = v;
    }
  }
}

// ---------------------------------------------------------------------------------
// bucket join on compact codes (codes in [0, G); negatives never match)
// ---------------------------------------------------------------------------------

// Phase 1: returns total number of matched pairs and fills per-left counts.
int64_t join_count(const int64_t* lcodes, int64_t nl, const int64_t* rcodes, int64_t nr,
                   int64_t num_codes, int64_t* bucket_counts /* size num_codes */,
                   int64_t* l_match_counts /* size nl */) {
  memset(bucket_counts, 0, sizeof(int64_t) * num_codes);
  for (int64_t j = 0; j < nr; j++) {
    if (rcodes[j] >= 0) bucket_counts[rcodes[j]]++;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < nl; i++) {
    const int64_t c = lcodes[i];
    const int64_t m = (c >= 0 && c < num_codes) ? bucket_counts[c] : 0;
    l_match_counts[i] = m;
    total += m;
  }
  return total;
}

// Phase 2: fill matched index pairs. bucket_offsets = exclusive prefix of counts.
void join_fill(const int64_t* lcodes, int64_t nl, const int64_t* rcodes, int64_t nr,
               int64_t num_codes, const int64_t* bucket_offsets,
               int64_t* bucket_rows /* size nr */, int64_t* out_l, int64_t* out_r) {
  // scatter right rows into buckets (stable)
  std::vector<int64_t> cursor(bucket_offsets, bucket_offsets + num_codes);
  for (int64_t j = 0; j < nr; j++) {
    if (rcodes[j] >= 0) bucket_rows[cursor[rcodes[j]]++] = j;
  }
  int64_t out = 0;
  for (int64_t i = 0; i < nl; i++) {
    const int64_t c = lcodes[i];
    if (c < 0 || c >= num_codes) continue;
    const int64_t s = bucket_offsets[c];
    const int64_t e = cursor[c];
    for (int64_t j = s; j < e; j++) {
      out_l[out] = i;
      out_r[out] = bucket_rows[j];
      out++;
    }
  }
}

// ---------------------------------------------------------------------------------
// probe-table lookups: buckets prebuilt ONCE (ProbeTable), probed per morsel
// ---------------------------------------------------------------------------------

// Count matches per left row against prebuilt bucket counts. Returns total.
int64_t probe_count(const int64_t* lcodes, int64_t nl, int64_t num_codes,
                    const int64_t* bucket_counts, int64_t* l_match_counts) {
  int64_t total = 0;
  for (int64_t i = 0; i < nl; i++) {
    const int64_t c = lcodes[i];
    const int64_t m = (c >= 0 && c < num_codes) ? bucket_counts[c] : 0;
    l_match_counts[i] = m;
    total += m;
  }
  return total;
}

// ---------------------------------------------------------------------------------
// open-addressing int64 -> int64 map (power-of-2 capacity, linear probing):
// sparse-domain join-key dictionaries where dense subtraction doesn't apply
// ---------------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

// keys must be unique; slot_vals pre-filled with -1 (empty marker).
void i64_map_build(const int64_t* keys, int64_t n, int64_t cap,
                   int64_t* slot_keys, int64_t* slot_vals) {
  const uint64_t mask = (uint64_t)cap - 1;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = mix64((uint64_t)keys[i]) & mask;
    while (slot_vals[h] != -1) h = (h + 1) & mask;
    slot_keys[h] = keys[i];
    slot_vals[h] = i;
  }
}

void i64_map_lookup(const int64_t* slot_keys, const int64_t* slot_vals, int64_t cap,
                    const int64_t* vals, int64_t n, int64_t* out) {
  const uint64_t mask = (uint64_t)cap - 1;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = mix64((uint64_t)vals[i]) & mask;
    int64_t r = -1;
    while (slot_vals[h] != -1) {
      if (slot_keys[h] == vals[i]) { r = slot_vals[h]; break; }
      h = (h + 1) & mask;
    }
    out[i] = r;
  }
}

// Arrow boolean bitmap -> selection vector in one word-wise pass (replaces
// the Python fill_null -> to_numpy(bytes) -> flatnonzero chain, which
// materializes a byte mask and scans twice). Emits row indices where
// value bit is set AND validity bit (if present) is set; returns the count.
int64_t bool_mask_indices(const uint8_t* bits, const uint8_t* validity,
                          int64_t offset, int64_t n, int64_t* out) {
  int64_t m = 0;
  int64_t i = 0;
  // head: unaligned bits until offset+i is a multiple of 64
  while (i < n && ((offset + i) & 63) != 0) {
    const int64_t j = offset + i;
    bool v = bits[j >> 3] & (1u << (j & 7));
    if (v && validity) v = validity[j >> 3] & (1u << (j & 7));
    if (v) out[m++] = i;
    i++;
  }
  // body: 64 rows per iteration, iterate set bits only
  while (i + 64 <= n) {
    const int64_t w = (offset + i) >> 6;
    uint64_t word;
    memcpy(&word, ((const uint64_t*)bits) + w, 8);
    if (validity) {
      uint64_t vw;
      memcpy(&vw, ((const uint64_t*)validity) + w, 8);
      word &= vw;
    }
    while (word) {
      out[m++] = i + __builtin_ctzll(word);
      word &= word - 1;
    }
    i += 64;
  }
  // tail
  while (i < n) {
    const int64_t j = offset + i;
    bool v = bits[j >> 3] & (1u << (j & 7));
    if (v && validity) v = validity[j >> 3] & (1u << (j & 7));
    if (v) out[m++] = i;
    i++;
  }
  return m;
}

// Interleaved (key,val) pair layout: one cache line serves both the key check
// and the value read, halving the random accesses per probe vs the split
// slot_keys/slot_vals arrays above. slots[2h] = key, slots[2h+1] = val
// (-1 = empty). keys must be unique; slots pre-filled with val = -1.
void i64_pairmap_build(const int64_t* keys, int64_t n, int64_t cap, int64_t* slots) {
  const uint64_t mask = (uint64_t)cap - 1;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = mix64((uint64_t)keys[i]) & mask;
    while (slots[2 * h + 1] != -1) h = (h + 1) & mask;
    slots[2 * h] = keys[i];
    slots[2 * h + 1] = i;
  }
}

void i64_pairmap_lookup(const int64_t* slots, int64_t cap,
                        const int64_t* vals, int64_t n, int64_t* out) {
  const uint64_t mask = (uint64_t)cap - 1;
  const int64_t D = 24;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n)
      __builtin_prefetch(&slots[2 * (mix64((uint64_t)vals[i + D]) & mask)], 0, 1);
    uint64_t h = mix64((uint64_t)vals[i]) & mask;
    int64_t r = -1;
    while (slots[2 * h + 1] != -1) {
      if (slots[2 * h] == vals[i]) { r = slots[2 * h + 1]; break; }
      h = (h + 1) & mask;
    }
    out[i] = r;
  }
}

// Fused pairmap lookup + match count (pair-layout variant of
// probe_lookup_count_hash).
int64_t probe_lookup_count_pair(const int64_t* vals, const uint8_t* valid,
                                int64_t n, const int64_t* slots, int64_t cap,
                                const int64_t* bucket_counts, int64_t num_codes,
                                int64_t* codes_out, int64_t* l_match) {
  const uint64_t mask = (uint64_t)cap - 1;
  const int64_t D = 24;
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n && (!valid || valid[i + D]))
      __builtin_prefetch(&slots[2 * (mix64((uint64_t)vals[i + D]) & mask)], 0, 1);
    int64_t code = -1;
    if (!valid || valid[i]) {
      const int64_t v = vals[i];
      uint64_t h = mix64((uint64_t)v) & mask;
      while (slots[2 * h + 1] != -1) {
        if (slots[2 * h] == v) { code = slots[2 * h + 1]; break; }
        h = (h + 1) & mask;
      }
    }
    codes_out[i] = code;
    const int64_t m = (code >= 0 && code < num_codes) ? bucket_counts[code] : 0;
    l_match[i] = m;
    total += m;
  }
  return total;
}

// Emit matched pairs from prebuilt buckets (left-major; build rows in
// original order within a key — bucket_rows is stable-sorted by code).
void probe_fill(const int64_t* lcodes, int64_t nl, int64_t num_codes,
                const int64_t* bucket_offsets, const int64_t* bucket_counts,
                const int64_t* bucket_rows, int64_t* out_l, int64_t* out_r) {
  const int64_t D = 24;
  int64_t out = 0;
  for (int64_t i = 0; i < nl; i++) {
    if (i + D < nl) {
      const int64_t cp = lcodes[i + D];
      if (cp >= 0 && cp < num_codes) {
        __builtin_prefetch(&bucket_offsets[cp], 0, 1);
        __builtin_prefetch(&bucket_counts[cp], 0, 1);
      }
    }
    const int64_t c = lcodes[i];
    if (c < 0 || c >= num_codes) continue;
    const int64_t s = bucket_offsets[c];
    const int64_t e = s + bucket_counts[c];
    for (int64_t j = s; j < e; j++) {
      out_l[out] = i;
      out_r[out] = bucket_rows[j];
      out++;
    }
  }
}

// Fused single-int64-key probe lookups: map probe values straight to build
// joint codes AND count matches in ONE pass, instead of the Python chain of
// lookup -> -1/-2 fixup writes -> probe_count (each a full O(n) sweep).
// valid may be null (all rows valid); invalid rows never match. Returns total
// match count; codes_out feeds probe_fill.
int64_t probe_lookup_count_hash(const int64_t* vals, const uint8_t* valid,
                                int64_t n, const int64_t* slot_keys,
                                const int64_t* slot_vals, int64_t cap,
                                const int64_t* bucket_counts, int64_t num_codes,
                                int64_t* codes_out, int64_t* l_match) {
  const uint64_t mask = (uint64_t)cap - 1;
  const int64_t D = 24;  // prefetch distance: probes are DRAM-latency-bound
                         // once the slot table outgrows LLC (~40ns/lookup
                         // measured); prefetching ahead overlaps the misses
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n && (!valid || valid[i + D])) {
      const uint64_t hp = mix64((uint64_t)vals[i + D]) & mask;
      __builtin_prefetch(&slot_keys[hp], 0, 1);
      __builtin_prefetch(&slot_vals[hp], 0, 1);
    }
    int64_t code = -1;
    if (!valid || valid[i]) {
      const int64_t v = vals[i];
      uint64_t h = mix64((uint64_t)v) & mask;
      while (slot_vals[h] != -1) {
        if (slot_keys[h] == v) { code = slot_vals[h]; break; }
        h = (h + 1) & mask;
      }
    }
    codes_out[i] = code;
    const int64_t m = (code >= 0 && code < num_codes) ? bucket_counts[code] : 0;
    l_match[i] = m;
    total += m;
  }
  return total;
}

// Same fusion for dense-domain keys (code = value - lo).
int64_t probe_lookup_count_dense(const int64_t* vals, const uint8_t* valid,
                                 int64_t n, int64_t lo, int64_t hi,
                                 const int64_t* bucket_counts, int64_t num_codes,
                                 int64_t* codes_out, int64_t* l_match) {
  const int64_t D = 24;
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n) {
      const int64_t vp = vals[i + D];
      if (vp >= lo && vp <= hi) __builtin_prefetch(&bucket_counts[vp - lo], 0, 1);
    }
    int64_t code = -1;
    if ((!valid || valid[i]) && vals[i] >= lo && vals[i] <= hi) code = vals[i] - lo;
    codes_out[i] = code;
    const int64_t m = (code >= 0 && code < num_codes) ? bucket_counts[code] : 0;
    l_match[i] = m;
    total += m;
  }
  return total;
}

// One-pass bucket build for ProbeTable: per-code counts + exclusive prefix
// offsets. codes < 0 (null / unmatchable) are skipped. Replaces the Python
// np.bincount + np.cumsum pair, which allocates and scans the full code
// domain twice for dense join keys.
int64_t bucket_build(const int64_t* codes, int64_t n, int64_t num_codes,
                     int64_t* counts /* size num_codes */,
                     int64_t* offsets /* size num_codes */) {
  memset(counts, 0, sizeof(int64_t) * num_codes);
  for (int64_t i = 0; i < n; i++) {
    if (codes[i] >= 0) counts[codes[i]]++;
  }
  int64_t acc = 0, mx = 0;
  for (int64_t g = 0; g < num_codes; g++) {
    offsets[g] = acc;
    acc += counts[g];
    if (counts[g] > mx) mx = counts[g];
  }
  return mx;  // max bucket size: 1 => unique build keys => direct-lookup joins
}

// Unique-build-key probe: ONE random access per probe row. slots is a
// (key, build_row) pairmap over ALL valid build rows (legal only when keys
// are unique — bucket_build reported max count 1). Writes the full per-row
// build-row array (-1 = no match) AND the compacted matched (l, r) pairs in
// the same pass; returns the match count. This replaces the general
// lookup -> counts -> offsets -> bucket_rows chain (3-4 dependent random
// accesses per row) for the dimension-join shape where keys are unique.
int64_t probe_unique_pair(const int64_t* vals, const uint8_t* valid, int64_t n,
                          const int64_t* slots, int64_t cap,
                          int64_t* ridx_full, int64_t* out_l, int64_t* out_r) {
  const uint64_t mask = (uint64_t)cap - 1;
  const int64_t D = 24;
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n && (!valid || valid[i + D]))
      __builtin_prefetch(&slots[2 * (mix64((uint64_t)vals[i + D]) & mask)], 0, 1);
    int64_t r = -1;
    if (!valid || valid[i]) {
      const int64_t v = vals[i];
      uint64_t h = mix64((uint64_t)v) & mask;
      while (slots[2 * h + 1] != -1) {
        if (slots[2 * h] == v) { r = slots[2 * h + 1]; break; }
        h = (h + 1) & mask;
      }
    }
    ridx_full[i] = r;
    if (r >= 0) {
      out_l[m] = i;
      out_r[m] = r;
      m++;
    }
  }
  return m;
}

// Dense-domain variant: row_of_code[v - lo] is the build row (-1 = absent).
int64_t probe_unique_dense(const int64_t* vals, const uint8_t* valid, int64_t n,
                           int64_t lo, int64_t hi, const int64_t* row_of_code,
                           int64_t* ridx_full, int64_t* out_l, int64_t* out_r) {
  const int64_t D = 24;
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    if (i + D < n) {
      const int64_t vp = vals[i + D];
      if (vp >= lo && vp <= hi) __builtin_prefetch(&row_of_code[vp - lo], 0, 1);
    }
    int64_t r = -1;
    if ((!valid || valid[i]) && vals[i] >= lo && vals[i] <= hi)
      r = row_of_code[vals[i] - lo];
    ridx_full[i] = r;
    if (r >= 0) {
      out_l[m] = i;
      out_r[m] = r;
      m++;
    }
  }
  return m;
}

// Stable counting-sort scatter of build rows into their buckets — O(n + G),
// replaces the O(n log n) np.argsort in ProbeTable._ensure_bucket_rows.
void bucket_scatter(const int64_t* codes, int64_t n, int64_t num_codes,
                    const int64_t* offsets, int64_t* rows /* size sum(counts) */) {
  std::vector<int64_t> cursor(offsets, offsets + num_codes);
  for (int64_t i = 0; i < n; i++) {
    if (codes[i] >= 0) rows[cursor[codes[i]]++] = i;
  }
}

// PNG row unfiltering (the port's own: the reference leaves PNG to PIL).
// raw holds h rows of 1 filter byte + stride bytes; out receives h x stride
// bytes. bpp is the bytes of one whole pixel (1 below 8 bits a pixel).
// Returns 0, or -(row + 1) at a row whose filter byte is not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ft = in[0];
    in++;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, in, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------------
// JPEG (the port's own: the reference leaves JPEG to PIL over libjpeg-turbo).
// core/kernels/jpeg.py parses the markers; these are the per-pixel stages,
// each held bit for bit to libjpeg-turbo's decoder (jdhuff.c / jdphuff.c,
// jidctint.c, jdsample.c, jdcolor.c) and its baseline Huffman encoder.
// ---------------------------------------------------------------------------------

// zigzag index -> natural index; 16 extra entries of 63 absorb a corrupt run
// past the end of a block, as libjpeg's jpeg_natural_order does
static const int kJpegNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// a decoding table's int32 layout (built by jpeg.py ``huffman_table``):
// [0, 256) 8-bit lookahead, (length << 8) | symbol, 0 for a longer code;
// [256, 274) maxcode by length (-1: none); [274, 292) value offset by
// length; [292, 548) the symbols
enum { kHuffInts = 548, kHuffMax = 256, kHuffOff = 274, kHuffVal = 292 };

struct JpegBits {
  const uint8_t* d;
  int64_t n, pos, marker;  // marker: index of the 0xFF of the marker that ended the data
  uint64_t buf;            // MSB-aligned
  int bits;

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (marker < 0 && pos < n) {
        const uint8_t c = d[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;  // fill bytes
          if (q >= n) {
            pos = n;
          } else if (d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            marker = q - 1;  // past a marker libjpeg reads zeros
          }
        } else {
          b = c;
          pos++;
        }
      }
      buf |= b << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t get(int s) {  // 1 <= s <= 16
    if (bits < s) fill();
    const uint32_t v = (uint32_t)(buf >> (64 - s));
    buf <<= s;
    bits -= s;
    return v;
  }
  inline int decode(const int32_t* t) {
    if (bits < 16) fill();
    const int32_t e = t[buf >> 56];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      bits -= l;
      return e & 0xFF;
    }
    const int32_t code16 = (int32_t)(buf >> 48);
    for (int l = 9; l <= 16; l++) {
      const int32_t code = code16 >> (16 - l);
      if (code <= t[kHuffMax + l]) {
        buf <<= l;
        bits -= l;
        return t[kHuffVal + ((t[kHuffOff + l] + code) & 0xFF)];
      }
    }
    buf <<= 16;  // a bad code: libjpeg warns, reads 16 bits and gives symbol 0
    bits -= 16;
    return 0;
  }
  void restart() {  // drop the padding bits and read an RSTn marker
    buf = 0;
    bits = 0;
    if (marker < 0) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) pos++;
      if (pos + 1 >= n) {
        pos = n;
        return;
      }
      marker = pos;
    }
    if (d[marker + 1] >= 0xD0 && d[marker + 1] <= 0xD7) {
      pos = marker + 2;
      marker = -1;
    }
  }
};

static inline int jpeg_extend(uint32_t v, int s) {
  return s == 0 ? 0 : ((int)v < (1 << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v);
}

// One scan's entropy-coded data, from data[pos], into the coefficient
// blocks (int16, natural order, zeroed before the first scan). params:
// [progressive, Ss, Se, Ah, Al, restart interval, components in the scan,
// MCUs per row, MCU rows], then per component of the scan: [offset of its
// blocks in coefs (in blocks), blocks per row allocated, h, v, DC table,
// AC table (0-3 each), blocks per row, block rows]. A scan of one
// component walks its own blocks; an interleaved scan walks MCUs. huff
// holds 8 tables: DC 0-3, then AC 0-3. Returns the index where the data
// stopped: the 0xFF of the marker after it, or n at the end of the bytes.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t pos, const int32_t* params,
                         const int32_t* huff, int16_t* coefs) {
  const int prog = params[0], ss = params[1], se = params[2], ah = params[3], al = params[4];
  const int64_t ri = params[5];
  const int nc = params[6];
  const int64_t mcus_x = params[7], mcus_y = params[8];
  const int32_t* comp = params + 9;
  JpegBits br{data, n, pos, -1, 0, 0};
  int pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  const int p1 = 1 << al, m1 = -1 * (1 << al);

  auto block = [&](int c, int64_t bx, int64_t by) {
    const int32_t* cp = comp + 8 * c;
    int16_t* blk = coefs + (cp[0] + by * cp[1] + bx) * 64;
    const int32_t* dct = huff + cp[4] * kHuffInts;
    const int32_t* act = huff + (4 + cp[5]) * kHuffInts;
    if (!prog) {
      const int s = br.decode(dct);
      pred[c] += s ? jpeg_extend(br.get(s), s) : 0;
      blk[0] = (int16_t)pred[c];
      for (int k = 1; k < 64; k++) {
        const int rs = br.decode(act);
        const int r = rs >> 4, s2 = rs & 15;
        if (s2) {
          k += r;
          blk[kJpegNatural[k]] = (int16_t)jpeg_extend(br.get(s2), s2);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans (interleaved or not)
      if (ah == 0) {
        const int s = br.decode(dct);
        pred[c] += s ? jpeg_extend(br.get(s), s) : 0;
        blk[0] = (int16_t)(pred[c] * (1 << al));
      } else if (br.get(1)) {
        blk[0] = (int16_t)(blk[0] | p1);
      }
      return;
    }
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = ss; k <= se; k++) {
        const int rs = br.decode(act);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kJpegNatural[k]] = (int16_t)(jpeg_extend(br.get(s), s) * (1 << al));
        } else {
          if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        const int rs = br.decode(act);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* co = blk + kJpegNatural[k];
          if (*co != 0) {
            if (br.get(1)) {
              if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kJpegNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* co = blk + kJpegNatural[k];
        if (*co != 0) {
          if (br.get(1)) {
            if ((*co & p1) == 0) *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
          }
        }
      }
      eobrun--;
    }
  };

  const int64_t total = nc == 1 ? (int64_t)comp[6] * comp[7] : mcus_x * mcus_y;
  for (int64_t m = 0; m < total; m++) {
    if (ri > 0 && m > 0 && m % ri == 0) {
      br.restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    if (nc == 1) {
      block(0, m % comp[6], m / comp[6]);
      continue;
    }
    const int64_t mx = m % mcus_x, my = m / mcus_x;
    for (int c = 0; c < nc; c++) {
      const int h = comp[8 * c + 2], v = comp[8 * c + 3];
      for (int y = 0; y < v; y++)
        for (int x = 0; x < h; x++) block(c, mx * h + x, my * v + y);
    }
  }
  if (br.marker >= 0) return br.marker;
  int64_t q = br.pos;  // the padding and any stray bytes before the next marker
  while (q + 1 < n && !(data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF)) q++;
  return q + 1 < n ? q : n;
}

// libjpeg's islow IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) over bw x bh
// blocks of a component (stride blocks a row in coefs), dequantized by the
// natural-order table qt, into an (8 bh, 8 bw) plane. The output is
// clamped to 0-255, as libjpeg-turbo's SIMD path saturates it.
void jpeg_idct(const int16_t* coefs, int64_t stride, int64_t bw, int64_t bh, const uint16_t* qt,
               uint8_t* out) {
  const int64_t ow = bw * 8;
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++) {
      const int16_t* in = coefs + (by * stride + bx) * 64;
      int64_t ws[64];
      for (int c = 0; c < 8; c++) {
        const int16_t* ip = in + c;
        const uint16_t* q = qt + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
            ip[48] == 0 && ip[56] == 0) {
          const int64_t dc = (int64_t)ip[0] * q[0] * 4;
          for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
          continue;
        }
        int64_t z2 = (int64_t)ip[16] * q[16], z3 = (int64_t)ip[48] * q[48];
        int64_t z1 = (z2 + z3) * 4433;
        const int64_t t2 = z1 + z3 * -15137, t3 = z1 + z2 * 6270;
        z2 = (int64_t)ip[0] * q[0];
        z3 = (int64_t)ip[32] * q[32];
        const int64_t t0 = (z2 + z3) * 8192, t1 = (z2 - z3) * 8192;
        const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        int64_t o0 = (int64_t)ip[56] * q[56], o1 = (int64_t)ip[40] * q[40];
        int64_t o2 = (int64_t)ip[24] * q[24], o3 = (int64_t)ip[8] * q[8];
        z1 = o0 + o3;
        z2 = o1 + o2;
        z3 = o0 + o2;
        int64_t z4 = o1 + o3;
        const int64_t z5 = (z3 + z4) * 9633;
        o0 *= 2446;
        o1 *= 16819;
        o2 *= 25172;
        o3 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        o0 += z1 + z3;
        o1 += z2 + z4;
        o2 += z2 + z3;
        o3 += z1 + z4;
        const int64_t rnd = 1 << 10;
        ws[0 * 8 + c] = (t10 + o3 + rnd) >> 11;
        ws[7 * 8 + c] = (t10 - o3 + rnd) >> 11;
        ws[1 * 8 + c] = (t11 + o2 + rnd) >> 11;
        ws[6 * 8 + c] = (t11 - o2 + rnd) >> 11;
        ws[2 * 8 + c] = (t12 + o1 + rnd) >> 11;
        ws[5 * 8 + c] = (t12 - o1 + rnd) >> 11;
        ws[3 * 8 + c] = (t13 + o0 + rnd) >> 11;
        ws[4 * 8 + c] = (t13 - o0 + rnd) >> 11;
      }
      for (int r = 0; r < 8; r++) {
        const int64_t* w = ws + r * 8;
        uint8_t* op = out + (by * 8 + r) * ow + bx * 8;
        auto lim = [](int64_t v) -> uint8_t {
          v += 128;
          return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        };
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * 4433;
        const int64_t t2 = z1 + z3 * -15137, t3 = z1 + z2 * 6270;
        const int64_t t0 = (w[0] + w[4]) * 8192, t1 = (w[0] - w[4]) * 8192;
        const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        int64_t o0 = w[7], o1 = w[5], o2 = w[3], o3 = w[1];
        z1 = o0 + o3;
        z2 = o1 + o2;
        z3 = o0 + o2;
        int64_t z4 = o1 + o3;
        const int64_t z5 = (z3 + z4) * 9633;
        o0 *= 2446;
        o1 *= 16819;
        o2 *= 25172;
        o3 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        o0 += z1 + z3;
        o1 += z2 + z4;
        o2 += z2 + z3;
        o3 += z1 + z4;
        const int64_t rnd = (int64_t)1 << 17;
        op[0] = lim((t10 + o3 + rnd) >> 18);
        op[7] = lim((t10 - o3 + rnd) >> 18);
        op[1] = lim((t11 + o2 + rnd) >> 18);
        op[6] = lim((t11 - o2 + rnd) >> 18);
        op[2] = lim((t12 + o1 + rnd) >> 18);
        op[5] = lim((t12 - o1 + rnd) >> 18);
        op[3] = lim((t13 + o0 + rnd) >> 18);
        op[4] = lim((t13 - o0 + rnd) >> 18);
      }
    }
  }
}

// A component's samples (dw x dh real, rows of in_stride bytes) brought up
// to the frame's sampling, hf x vf, into an (out_h, out_w) plane as
// jdsample.c does: fancy (triangle) filters for h2v1, h1v2 and h2v2
// (h2 only where dw > 2), replication for every other integral factor. A
// row past dh reads the last real row, as jdmainct.c's context does.
void jpeg_upsample(const uint8_t* in, int64_t in_stride, int64_t dw, int64_t dh, int64_t hf,
                   int64_t vf, uint8_t* out, int64_t out_w, int64_t out_h) {
  std::vector<uint8_t> line((size_t)(dw * hf + 16));
  auto row = [&](int64_t r) { return in + (r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * in_stride; };
  const bool fancy_h = hf == 2 && dw > 2;
  const bool fancy_v = vf == 2 && (hf == 1 || fancy_h);
  for (int64_t y = 0; y < out_h; y++) {
    const int64_t r = y / vf;
    const uint8_t* near = row(r);
    uint8_t* l = line.data();
    if (fancy_v && hf == 2) {
      const uint8_t* far = (y & 1) ? row(r + 1) : row(r - 1);
      int prev = near[0] * 3 + far[0], cur = prev;
      for (int64_t i = 0; i < dw; i++) {
        const int next = i + 1 < dw ? near[i + 1] * 3 + far[i + 1] : cur;
        if (i == 0) {
          l[0] = (uint8_t)((cur * 4 + 8) >> 4);
        } else {
          l[2 * i] = (uint8_t)((cur * 3 + prev + 8) >> 4);
        }
        if (i + 1 < dw) {
          l[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        } else {
          l[2 * i + 1] = (uint8_t)((cur * 4 + 7) >> 4);
        }
        prev = cur;
        cur = next;
      }
    } else if (fancy_v) {  // h1v2
      const uint8_t* far = (y & 1) ? row(r + 1) : row(r - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int64_t i = 0; i < dw; i++) l[i] = (uint8_t)((near[i] * 3 + far[i] + bias) >> 2);
    } else if (fancy_h && vf == 1) {  // h2v1
      for (int64_t i = 0; i < dw; i++) {
        const int v3 = near[i] * 3;
        l[2 * i] = i == 0 ? near[0] : (uint8_t)((v3 + near[i - 1] + 1) >> 2);
        l[2 * i + 1] = i + 1 < dw ? (uint8_t)((v3 + near[i + 1] + 2) >> 2) : near[i];
      }
    } else {
      for (int64_t i = 0; i < dw; i++)
        for (int64_t k = 0; k < hf; k++) l[i * hf + k] = near[i];
    }
    std::memcpy(out + y * out_w, l, (size_t)out_w);
  }
}

// Full-size planes (npix samples each) to PIL's pixels: space 0 YCbCr ->
// RGB (jdcolor.c's 16-bit fixed-point tables), 1 RGB kept, 2 CMYK and 3
// YCCK -> CMYK, both then inverted as PIL's "CMYK;I" reads Adobe's CMYK.
void jpeg_color(const uint8_t* p0, const uint8_t* p1, const uint8_t* p2, const uint8_t* p3,
                int64_t npix, int64_t space, uint8_t* out) {
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static const bool ready = [] {
    const int64_t half = (int64_t)1 << 15;
    for (int i = 0; i < 256; i++) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + half) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + half) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                        // FIX(0.71414)
      cb_g[i] = -22554 * x + half;                 // FIX(0.34414)
    }
    return true;
  }();
  (void)ready;
  auto lim = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (int64_t i = 0; i < npix; i++) {
    if (space == 0 || space == 3) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      const int r = lim(y + cr_r[cr]);
      const int g = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      const int b = lim(y + cb_b[cb]);
      if (space == 0) {
        out[3 * i] = (uint8_t)r;
        out[3 * i + 1] = (uint8_t)g;
        out[3 * i + 2] = (uint8_t)b;
      } else {  // libjpeg gives 255 - rgb; PIL inverts it back
        out[4 * i] = (uint8_t)r;
        out[4 * i + 1] = (uint8_t)g;
        out[4 * i + 2] = (uint8_t)b;
        out[4 * i + 3] = (uint8_t)(255 - p3[i]);
      }
    } else if (space == 1) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    } else {
      out[4 * i] = (uint8_t)(255 - p0[i]);
      out[4 * i + 1] = (uint8_t)(255 - p1[i]);
      out[4 * i + 2] = (uint8_t)(255 - p2[i]);
      out[4 * i + 3] = (uint8_t)(255 - p3[i]);
    }
  }
}

// The baseline Huffman encoder: quantized blocks (int16, natural order) in
// MCU order into entropy-coded bytes with 0xFF stuffing, padded with 1 bits.
// params: [components, MCUs per row, MCU rows], then per component [offset
// of its blocks (in blocks), blocks per row allocated, h, v, DC table, AC
// table]; ehuf holds 4 tables (DC 0-1, AC 0-1) of 256 codes then 256
// lengths. Returns the bytes written, or -1 when cap is too small.
int64_t jpeg_encode_scan(const int16_t* coefs, const int32_t* params, const int32_t* ehuf,
                         uint8_t* out, int64_t cap) {
  const int nc = params[0];
  const int64_t mcus_x = params[1], mcus_y = params[2];
  const int32_t* comp = params + 3;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t o = 0;
  bool over = false;
  auto put = [&](uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nbits - 8));
      nbits -= 8;
      if (o + 2 > cap) {
        over = true;
        return;
      }
      out[o++] = b;
      if (b == 0xFF) out[o++] = 0;
    }
  };
  int pred[4] = {0, 0, 0, 0};
  for (int64_t m = 0; m < mcus_x * mcus_y && !over; m++) {
    const int64_t mx = m % mcus_x, my = m / mcus_x;
    for (int c = 0; c < nc; c++) {
      const int32_t* cp = comp + 6 * c;
      const int32_t* dc = ehuf + cp[4] * 512;
      const int32_t* ac = ehuf + (2 + cp[5]) * 512;
      for (int y = 0; y < cp[3]; y++) {
        for (int x = 0; x < cp[2]; x++) {
          const int16_t* blk = coefs + (cp[0] + (my * cp[3] + y) * cp[1] + mx * cp[2] + x) * 64;
          int t = blk[0] - pred[c], t2 = t;
          pred[c] = blk[0];
          if (t < 0) {
            t = -t;
            t2--;
          }
          int s = 0;
          while (t) {
            s++;
            t >>= 1;
          }
          put((uint32_t)dc[s], dc[256 + s]);
          if (s) put((uint32_t)t2, s);
          int r = 0;
          for (int k = 1; k < 64; k++) {
            int v = blk[kJpegNatural[k]];
            if (v == 0) {
              r++;
              continue;
            }
            while (r > 15) {
              put((uint32_t)ac[0xF0], ac[256 + 0xF0]);
              r -= 16;
            }
            int v2 = v;
            if (v < 0) {
              v = -v;
              v2--;
            }
            int sz = 0;
            while (v) {
              sz++;
              v >>= 1;
            }
            const int sym = (r << 4) + sz;
            put((uint32_t)ac[sym], ac[256 + sym]);
            put((uint32_t)v2, sz);
            r = 0;
          }
          if (r > 0) put((uint32_t)ac[0], ac[256]);
        }
      }
    }
  }
  if (!over) put(0x7F, 7);  // libjpeg's flush: seven 1 bits, the rest dropped
  return over ? -1 : o;
}

// GPT-2's pre-tokenizer split ('s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
// ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+) over n code points: cls gives each code
// point's class (0 other, 1 letter, 2 number, 3 whitespace as Oniguruma's
// \s). Writes each word's end into ends; returns the number of words.
static int64_t gpt2_split(const uint32_t* cp, int64_t n, const uint8_t* cls, int64_t* ends) {
  auto k = [&](int64_t i) -> int { return cp[i] < 0x110000 ? cls[cp[i]] : 0; };
  int64_t i = 0, m = 0;
  while (i < n) {
    const uint32_t c = cp[i];
    if (c == '\'' && i + 1 < n) {
      const uint32_t a = cp[i + 1];
      if (a == 's' || a == 't' || a == 'm' || a == 'd') {
        ends[m++] = i + 2;
        i += 2;
        continue;
      }
      if (i + 2 < n) {
        const uint32_t b = cp[i + 2];
        if ((a == 'r' && b == 'e') || (a == 'v' && b == 'e') || (a == 'l' && b == 'l')) {
          ends[m++] = i + 3;
          i += 3;
          continue;
        }
      }
    }
    int64_t j;
    const int t = k(i);
    if (c == ' ' && i + 1 < n && k(i + 1) != 3) {  // an optional space, then a run
      const int t1 = k(i + 1);
      j = i + 2;
      while (j < n && k(j) == t1) j++;
    } else if (t != 3) {
      j = i + 1;
      while (j < n && k(j) == t) j++;
    } else {  // whitespace: all of it at the end, else all but the last before a word
      j = i + 1;
      while (j < n && k(j) == 3) j++;
      if (j < n && j - i >= 2) j--;
    }
    ends[m++] = j;
    i = j;
  }
  return m;
}

// The encoder's islow FDCT (jfdctint.c) and libjpeg-turbo's reciprocal
// quantization (jcdctmgr.c, its 16-bit SIMD build) of every block of an
// (8 bh, 8 bw) plane of samples; quant holds 64 reciprocals, 64
// corrections and 64 shifts (natural order). Writes (bh, bw, 64) int16
// coefficients, natural order.
void jpeg_fdct_quant(const uint8_t* plane, int64_t bw, int64_t bh, const int32_t* quant,
                     int16_t* out) {
  const int64_t stride = bw * 8;
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++) {
      int64_t d[64];
      for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) d[r * 8 + c] = (int64_t)plane[(by * 8 + r) * stride + bx * 8 + c] - 128;
      for (int pass = 0; pass < 2; pass++) {
        const int step = pass == 0 ? 1 : 8;   // along a row, then down a column
        const int next = pass == 0 ? 8 : 1;
        const int sh = pass == 0 ? 11 : 15;
        for (int line = 0; line < 8; line++) {
          int64_t* p = d + line * next;
          const int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
          const int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
          const int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
          const int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
          const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
          if (pass == 0) {
            p[0] = (t10 + t11) * 4;
            p[4 * step] = (t10 - t11) * 4;
          } else {
            p[0] = (t10 + t11 + 2) >> 2;
            p[4 * step] = (t10 - t11 + 2) >> 2;
          }
          const int64_t rnd = (int64_t)1 << (sh - 1);
          int64_t z1 = (t12 + t13) * 4433;
          p[2 * step] = (z1 + t13 * 6270 + rnd) >> sh;
          p[6 * step] = (z1 + t12 * -15137 + rnd) >> sh;
          z1 = t4 + t7;
          int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
          const int64_t z5 = (z3 + z4) * 9633;
          z1 *= -7373;
          z2 *= -20995;
          z3 = z3 * -16069 + z5;
          z4 = z4 * -3196 + z5;
          p[7 * step] = (t4 * 2446 + z1 + z3 + rnd) >> sh;
          p[5 * step] = (t5 * 16819 + z2 + z4 + rnd) >> sh;
          p[3 * step] = (t6 * 25172 + z2 + z3 + rnd) >> sh;
          p[step] = (t7 * 12299 + z1 + z4 + rnd) >> sh;
        }
      }
      int16_t* o = out + (by * bw + bx) * 64;
      for (int i = 0; i < 64; i++) {
        const int64_t v = d[i];
        const int64_t m = (((v < 0 ? -v : v) + quant[64 + i]) * quant[i]) >> quant[128 + i];
        o[i] = (int16_t)(v < 0 ? -m : m);
      }
    }
  }
}

// A cache of BPE words for the tokenizer-file reader: each word's code
// points to its ids, in an open-addressed table over two flat pools, emptied
// when it holds max_words words. bpe_encode splits a text as gpt2_split does
// and looks every word up; the words it misses go back to the caller, which
// merges them (functions/tokenizer_file.py), fills them in and puts them in.
struct BpeCache {
  struct Slot {
    uint64_t hash;
    int64_t key_off, ids_off;
    int32_t key_len, ids_len;  // key_len < 0: an empty slot
  };
  std::vector<uint32_t> keys;
  std::vector<int32_t> ids;
  std::vector<Slot> slots;
  int64_t used = 0;
  const int64_t max_words;
  std::shared_mutex mu;

  explicit BpeCache(int64_t max_words) : max_words(max_words > 0 ? max_words : 1) { reset(); }
  void reset() {
    keys.clear();
    ids.clear();
    slots.assign((size_t)1 << 12, Slot{0, 0, 0, -1, 0});
    used = 0;
  }
  static uint64_t hash(const uint32_t* cp, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; i++) h = (h ^ cp[i]) * 1099511628211ULL;
    return h;
  }
  const Slot* find(const uint32_t* cp, int64_t n, uint64_t h) const {
    const size_t mask = slots.size() - 1;
    for (size_t i = (size_t)h & mask;; i = (i + 1) & mask) {
      const Slot& s = slots[i];
      if (s.key_len < 0) return nullptr;
      if (s.hash == h && s.key_len == n &&
          std::memcmp(keys.data() + s.key_off, cp, (size_t)n * 4) == 0)
        return &s;
    }
  }
  void insert(const Slot& s) {
    const size_t mask = slots.size() - 1;
    size_t i = (size_t)s.hash & mask;
    while (slots[i].key_len >= 0) i = (i + 1) & mask;
    slots[i] = s;
  }
  void put(const uint32_t* cp, int64_t n, const int32_t* w, int64_t k) {
    const uint64_t h = hash(cp, n);
    if (find(cp, n, h)) return;
    if (used >= max_words) reset();  // a bounded cache
    if ((used + 1) * 2 > (int64_t)slots.size()) {
      std::vector<Slot> old;
      old.swap(slots);
      slots.assign(old.size() * 2, Slot{0, 0, 0, -1, 0});
      for (const Slot& s : old)
        if (s.key_len >= 0) insert(s);
    }
    Slot s{h, (int64_t)keys.size(), (int64_t)ids.size(), (int32_t)n, (int32_t)k};
    keys.insert(keys.end(), cp, cp + n);
    ids.insert(ids.end(), w, w + k);
    insert(s);
    used++;
  }
};

int64_t bpe_cache_new(int64_t max_words) { return (int64_t)(intptr_t) new BpeCache(max_words); }

void bpe_cache_free(int64_t h) { delete (BpeCache*)(intptr_t)h; }

void bpe_cache_put(int64_t h, const uint32_t* cp, int64_t n, const int32_t* ids, int64_t k) {
  BpeCache* c = (BpeCache*)(intptr_t)h;
  std::unique_lock<std::shared_mutex> lock(c->mu);
  c->put(cp, n, ids, k);
}

// Writes the ids of the text's words found in the cache into out (cap
// out_cap), in order, and returns their number; for each word missing from
// the cache, writes its start, its end and the place in out where its ids
// belong into miss (triples; a text of n code points has at most n words)
// and counts it in n_miss. -2 when out is too small.
int64_t bpe_encode(int64_t h, const uint32_t* cp, int64_t n, const uint8_t* cls, int32_t* out,
                   int64_t out_cap, int64_t* miss, int64_t* n_miss) {
  BpeCache* c = (BpeCache*)(intptr_t)h;
  std::vector<int64_t> ends((size_t)(n > 0 ? n : 1));
  const int64_t m = gpt2_split(cp, n, cls, ends.data());
  std::shared_lock<std::shared_mutex> lock(c->mu);
  int64_t o = 0, nm = 0;
  for (int64_t w = 0, start = 0; w < m; start = ends[w], w++) {
    const int64_t len = ends[w] - start;
    const BpeCache::Slot* s = c->find(cp + start, len, BpeCache::hash(cp + start, len));
    if (s == nullptr) {
      miss[3 * nm] = start;
      miss[3 * nm + 1] = ends[w];
      miss[3 * nm + 2] = o;
      nm++;
      continue;
    }
    if (o + s->ids_len > out_cap) return -2;
    std::memcpy(out + o, c->ids.data() + s->ids_off, (size_t)s->ids_len * sizeof(int32_t));
    o += s->ids_len;
  }
  *n_miss = nm;
  return o;
}

// cv2's INTER_LINEAR resize of a uint8 (sh, sw, c) image to (oh, ow, c) in
// its fixed point (core/kernels/image.py computes the taps: each output
// column's two source columns and the first's 11-bit weight a0, each output
// row's b0): a horizontal pass in int32 (>> 4), then the vertical pass as
// cv2's vector path rounds it, ((h0 b0 >> 16) + (h1 b1 >> 16) + 2) >> 2.
void image_resize_u8(const uint8_t* src, int64_t sw, int64_t c, const int64_t* xs0,
                     const int64_t* xs1, const int32_t* a0, const int64_t* ys0,
                     const int64_t* ys1, const int32_t* b0, int64_t ow, int64_t oh,
                     uint8_t* out) {
  const int64_t n = ow * c;
  std::vector<int32_t> h0((size_t)(n > 0 ? n : 1)), h1((size_t)(n > 0 ? n : 1));
  auto horiz = [&](int64_t r, int32_t* h) {
    const uint8_t* row = src + r * sw * c;
    for (int64_t x = 0; x < ow; x++) {
      const int32_t a = a0[x], a1 = 2048 - a;
      const uint8_t* p0 = row + xs0[x] * c;
      const uint8_t* p1 = row + xs1[x] * c;
      for (int64_t k = 0; k < c; k++) h[x * c + k] = (p0[k] * a + p1[k] * a1) >> 4;
    }
  };
  for (int64_t y = 0; y < oh; y++) {
    horiz(ys0[y], h0.data());
    horiz(ys1[y], h1.data());
    const int32_t b = b0[y], b1 = 2048 - b;
    uint8_t* o = out + y * n;
    for (int64_t i = 0; i < n; i++) {
      const int32_t v = (((h0[i] * b) >> 16) + ((h1[i] * b1) >> 16) + 2) >> 2;
      o[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// The writer's samples of one component (jccolor.c, jcprep.c, jcsample.c):
// component comp (0 Y, 1 Cb, 2 Cr; 0 of a gray image) of the (h, w, c)
// uint8 pixels (c 1 or 3), the image padded by its edge samples down to a
// row group (max_v rows) and right to bw * 8 * hf columns, downsampled hf x
// vf (h2v2 with its 1, 2 bias, h2v1 with 0, 1, int_downsample otherwise),
// then padded down by its last row: out is (bh * 8, bw * 8).
void jpeg_component_plane(const uint8_t* px, int64_t h, int64_t w, int64_t c, int64_t comp,
                          int64_t hf, int64_t vf, int64_t max_v, int64_t bw, int64_t bh,
                          uint8_t* out) {
  const int64_t rows = (h + max_v - 1) / max_v * max_v;  // the padded rows
  const int64_t drows = rows / vf;                      // the downsampled rows
  const int64_t ow = bw * 8;
  auto sample = [&](int64_t r, int64_t x) -> int32_t {
    const uint8_t* p = px + ((r < h ? r : h - 1) * w + (x < w ? x : w - 1)) * c;
    if (c == 1) return p[0];
    const int32_t R = p[0], G = p[1], B = p[2];
    if (comp == 0) return (19595 * R + 38470 * G + 7471 * B + 32768) >> 16;
    if (comp == 1) return (-11059 * R - 21709 * G + 32768 * B + 8421375) >> 16;
    return (32768 * R - 27439 * G - 5329 * B + 8421375) >> 16;
  };
  for (int64_t y = 0; y < bh * 8; y++) {
    const int64_t dr = y < drows ? y : drows - 1;
    uint8_t* o = out + y * ow;
    for (int64_t x = 0; x < ow; x++) {
      int32_t v;
      if (hf == 1 && vf == 1) {
        v = sample(dr, x);
      } else if (hf == 2 && vf == 2) {
        v = (sample(2 * dr, 2 * x) + sample(2 * dr, 2 * x + 1) + sample(2 * dr + 1, 2 * x) +
             sample(2 * dr + 1, 2 * x + 1) + ((x & 1) ? 2 : 1)) >> 2;
      } else if (hf == 2 && vf == 1) {
        v = (sample(dr, 2 * x) + sample(dr, 2 * x + 1) + (int32_t)(x & 1)) >> 1;
      } else {
        int32_t sum = 0;
        for (int64_t a = 0; a < vf; a++)
          for (int64_t b = 0; b < hf; b++) sum += sample(dr * vf + a, x * hf + b);
        v = (sum + (int32_t)(hf * vf / 2)) / (int32_t)(hf * vf);
      }
      o[x] = (uint8_t)v;
    }
  }
}

// ---------------------------------------------------------------------------------
// LZ4 (the block and frame formats of the public LZ4 specification; a fresh
// implementation): Arrow IPC's LZ4_FRAME body compression
// (io/arrow_ipc.py). The compressor is a greedy single-pass matcher over a
// 2^16-entry table of 4-byte hashes; native.py's plain versions run the same
// algorithm, byte for byte. The decompressor takes any valid frame (linked or
// independent blocks, block and content checksums, content size, stored
// blocks, skippable frames, several frames in a row), as pyarrow writes them.
// ---------------------------------------------------------------------------------

static const uint32_t X32_1 = 2654435761U, X32_2 = 2246822519U, X32_3 = 3266489917U;
static const uint32_t X32_4 = 668265263U, X32_5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

uint32_t lz4_xxh32(const uint8_t* p, int64_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + X32_1 + X32_2, v2 = seed + X32_2, v3 = seed, v4 = seed - X32_1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32(p) * X32_2, 13) * X32_1; p += 4;
      v2 = rotl32(v2 + rd32(p) * X32_2, 13) * X32_1; p += 4;
      v3 = rotl32(v3 + rd32(p) * X32_2, 13) * X32_1; p += 4;
      v4 = rotl32(v4 + rd32(p) * X32_2, 13) * X32_1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + X32_5;
  }
  h += (uint32_t)n;
  while (p + 4 <= end) {
    h = rotl32(h + rd32(p) * X32_3, 17) * X32_4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * X32_5, 11) * X32_1;
    p++;
  }
  h ^= h >> 15;
  h *= X32_2;
  h ^= h >> 13;
  h *= X32_3;
  h ^= h >> 16;
  return h;
}

static const int LZ4_HASH_LOG = 16;
static const int64_t LZ4_MIN_MATCH = 4, LZ4_LAST_LITERALS = 5, LZ4_MFLIMIT = 12;

static inline int64_t lz4_put_length(uint8_t* dst, int64_t op, int64_t cap, int64_t len) {
  // the bytes of a length past its token's 15
  while (len >= 255) {
    if (op >= cap) return -1;
    dst[op++] = 255;
    len -= 255;
  }
  if (op >= cap) return -1;
  dst[op++] = (uint8_t)len;
  return op;
}

static int64_t lz4_emit(const uint8_t* src, int64_t anchor, int64_t lit, uint8_t* dst,
                        int64_t op, int64_t cap, int64_t offset, int64_t mlen) {
  // one sequence: token, literal length, literals, then (mlen > 0) the offset
  // and the match length; returns the new output position or -1 (no room)
  if (op >= cap) return -1;
  const int64_t tok = op++;
  const int64_t ml = mlen > 0 ? mlen - LZ4_MIN_MATCH : 0;
  dst[tok] = (uint8_t)(((lit >= 15 ? 15 : lit) << 4) | (ml >= 15 ? 15 : ml));
  if (lit >= 15 && (op = lz4_put_length(dst, op, cap, lit - 15)) < 0) return -1;
  if (op + lit > cap) return -1;
  memcpy(dst + op, src + anchor, (size_t)lit);
  op += lit;
  if (mlen > 0) {
    if (op + 2 > cap) return -1;
    dst[op++] = (uint8_t)(offset & 0xFF);
    dst[op++] = (uint8_t)(offset >> 8);
    if (ml >= 15 && (op = lz4_put_length(dst, op, cap, ml - 15)) < 0) return -1;
  }
  return op;
}

int64_t lz4_block_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  // an LZ4 block of src[0:n]; the bytes written, or -1 when cap is short
  std::vector<int32_t> table((size_t)1 << LZ4_HASH_LOG, -1);
  int64_t ip = 0, anchor = 0, op = 0;
  const int64_t mflimit = n - LZ4_MFLIMIT, matchlimit = n - LZ4_LAST_LITERALS;
  while (ip < mflimit) {
    const uint32_t seq = rd32(src + ip);
    const uint32_t h = (seq * 2654435761U) >> (32 - LZ4_HASH_LOG);
    const int64_t ref = table[h];
    table[h] = (int32_t)ip;
    if (ref < 0 || ip - ref > 65535 || rd32(src + ref) != seq) {
      ip++;
      continue;
    }
    int64_t mlen = LZ4_MIN_MATCH;
    while (ip + mlen < matchlimit && src[ref + mlen] == src[ip + mlen]) mlen++;
    op = lz4_emit(src, anchor, ip - anchor, dst, op, cap, ip - ref, mlen);
    if (op < 0) return -1;
    ip += mlen;
    anchor = ip;
  }
  return lz4_emit(src, anchor, n - anchor, dst, op, cap, 0, 0);
}

static int64_t lz4_block_into(const uint8_t* src, int64_t n, uint8_t* base, int64_t pos,
                              int64_t cap) {
  // decode one block into base[pos:cap]; a match may reach back into what
  // earlier blocks wrote to base (linked blocks). The new position, or a
  // negative code: -2 malformed input, -3 output past cap
  int64_t ip = 0;
  while (ip < n) {
    const int tok = src[ip++];
    int64_t lit = tok >> 4;
    if (lit == 15) {
      int b;
      do {
        if (ip >= n) return -2;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n) return -2;
    if (pos + lit > cap) return -3;
    memcpy(base + pos, src + ip, (size_t)lit);
    ip += lit;
    pos += lit;
    if (ip == n) break;  // the last sequence has no match
    if (ip + 2 > n) return -2;
    const int64_t offset = src[ip] | ((int64_t)src[ip + 1] << 8);
    ip += 2;
    if (offset == 0 || offset > pos) return -2;
    int64_t mlen = tok & 15;
    if (mlen == 15) {
      int b;
      do {
        if (ip >= n) return -2;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += LZ4_MIN_MATCH;
    if (pos + mlen > cap) return -3;
    const uint8_t* m = base + pos - offset;
    for (int64_t k = 0; k < mlen; k++) base[pos + k] = m[k];  // may overlap
    pos += mlen;
  }
  return pos;
}

int64_t lz4_block_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  return lz4_block_into(src, n, dst, 0, cap);
}

static const uint32_t LZ4F_MAGIC = 0x184D2204U;
static const int64_t LZ4F_BLOCK = (int64_t)4 << 20;  // BD 7: 4 MiB blocks

int64_t lz4_frame_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  // one LZ4 frame: independent 4 MiB blocks (a block that does not shrink is
  // stored), no checksums, no content size; the bytes written, or -1
  if (cap < 11) return -1;
  uint32_t magic = LZ4F_MAGIC;
  memcpy(dst, &magic, 4);
  dst[4] = 0x60;  // version 01, independent blocks
  dst[5] = 0x70;  // 4 MiB blocks
  dst[6] = (uint8_t)((lz4_xxh32(dst + 4, 2, 0) >> 8) & 0xFF);
  int64_t op = 7;
  for (int64_t at = 0; at < n; at += LZ4F_BLOCK) {
    const int64_t len = std::min(LZ4F_BLOCK, n - at);
    if (op + 4 > cap) return -1;
    int64_t c = lz4_block_compress(src + at, len, dst + op + 4, std::min(cap - op - 4, len - 1));
    uint32_t word;
    if (c < 0) {  // no gain: stored
      if (op + 4 + len > cap) return -1;
      memcpy(dst + op + 4, src + at, (size_t)len);
      word = (uint32_t)len | 0x80000000U;
      c = len;
    } else {
      word = (uint32_t)c;
    }
    memcpy(dst + op, &word, 4);
    op += 4 + c;
  }
  if (op + 4 > cap) return -1;
  memset(dst + op, 0, 4);  // EndMark
  return op + 4;
}

int64_t lz4_frame_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  // every frame of src[0:n] (skippable frames skipped); the bytes written,
  // or a negative code: -1 not LZ4, -2 malformed, -3 past cap, -4 a
  // checksum differs, -5 a dictionary is named
  int64_t ip = 0, pos = 0;
  while (ip < n) {
    if (ip + 4 > n) return -2;
    const uint32_t magic = rd32(src + ip);
    if ((magic & 0xFFFFFFF0U) == 0x184D2A50U) {
      if (ip + 8 > n) return -2;
      ip += 8 + (int64_t)rd32(src + ip + 4);
      continue;
    }
    if (magic != LZ4F_MAGIC) return ip == 0 ? -1 : -2;
    if (ip + 7 > n) return -2;
    const int flg = src[ip + 4];
    if ((flg >> 6) != 1) return -2;
    const bool indep = flg & 0x20, bsum = flg & 0x10, csize = flg & 0x08;
    const bool csum = flg & 0x04, dict = flg & 0x01;
    const int64_t desc = 2 + (csize ? 8 : 0) + (dict ? 4 : 0);
    if (ip + 4 + desc + 1 > n) return -2;
    if (((lz4_xxh32(src + ip + 4, desc, 0) >> 8) & 0xFF) != src[ip + 4 + desc]) return -4;
    if (dict) return -5;
    int64_t content = -1;
    if (csize) {
      uint64_t v;
      memcpy(&v, src + ip + 6, 8);
      content = (int64_t)v;
    }
    const int64_t bmax = (int64_t)1 << (8 + 2 * ((src[ip + 5] >> 4) & 7));
    ip += 4 + desc + 1;
    const int64_t start = pos;
    while (true) {
      if (ip + 4 > n) return -2;
      const uint32_t word = rd32(src + ip);
      ip += 4;
      if (word == 0) break;
      const int64_t len = word & 0x7FFFFFFFU;
      if (len > bmax || ip + len + (bsum ? 4 : 0) > n) return -2;
      if (bsum && lz4_xxh32(src + ip, len, 0) != rd32(src + ip + len)) return -4;
      if (word & 0x80000000U) {
        if (pos + len > cap) return -3;
        memcpy(dst + pos, src + ip, (size_t)len);
        pos += len;
      } else {
        // an independent block's matches stay inside it: decode it from its
        // own start; a linked block's may reach the frame's earlier output
        const int64_t r = indep ? lz4_block_into(src + ip, len, dst + pos, 0, cap - pos)
                                : lz4_block_into(src + ip, len, dst + start, pos - start,
                                                 cap - start);
        if (r < 0) return r;
        pos = indep ? pos + r : start + r;
      }
      ip += len + (bsum ? 4 : 0);
    }
    if (csum) {
      if (ip + 4 > n) return -2;
      if (lz4_xxh32(dst + start, pos - start, 0) != rd32(src + ip)) return -4;
      ip += 4;
    }
    if (content >= 0 && content != pos - start) return -2;
  }
  return pos;
}

}  // extern "C"
