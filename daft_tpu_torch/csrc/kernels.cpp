// The port's host kernel library: hashing, factorize, grouped sums and
// extremes, the bucket join, open-addressed int64 maps, the probe table's
// fused lookups and fills, and the selection vector of a boolean bitmap.
// Every kernel is one O(n) pass with a plain C interface, called through
// ctypes (daft_tpu_torch/native.py), which drops the GIL for the call.
//
// The same exports, arguments and results as the reference's
// native/src/kernels.cpp, kept as the port's own source, and one export of
// the port's own: png_unfilter (the PNG codec, core/kernels/png.py). Built at first use
// by ops/_build.py ``host_library`` with the host compiler (``$CXX``, else
// ``c++``) into ops/_kbuild/.
//
// Conventions every caller keeps: a negative code never matches; an output
// buffer is allocated with at least one element (numpy's max(n, 1)), since
// a kernel writes nothing for n = 0 but takes the pointer.

#include <cstdint>
#include <cstring>
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

}  // extern "C"
