// Snappy block compression and decompression (the raw format Parquet pages
// use: a varint of the uncompressed length, then literal and copy elements),
// host C++ with a plain C interface for ctypes (io/codecs.py). Built at first
// use by ops/_build.py with the host compiler.
//
// The compressor is the format's greedy LZ77: the input in 64 KiB blocks, a
// hash table of 4-byte sequences per block, each match extended as far as it
// goes and emitted as copies of at most 64 bytes, everything else as
// literals. Every offset stays inside its block (< 65,536), so a copy is a
// 1-byte-offset element (length 4..11, offset < 2048) or a 2-byte-offset one.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlockLog = 16;
constexpr size_t kBlockSize = size_t(1) << kBlockLog;
constexpr int kHashBits = 14;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v) { return (v * 0x1e35a7bdu) >> (32 - kHashBits); }

inline uint8_t* put_varint(uint8_t* out, uint64_t n) {
  while (n >= 0x80) {
    *out++ = uint8_t(n | 0x80);
    n >>= 7;
  }
  *out++ = uint8_t(n);
  return out;
}

inline uint8_t* emit_literal(uint8_t* out, const uint8_t* lit, size_t len) {
  size_t n = len - 1;
  if (n < 60) {
    *out++ = uint8_t(n << 2);
  } else {
    int bytes = n < (1u << 8) ? 1 : n < (1u << 16) ? 2 : n < (1u << 24) ? 3 : 4;
    *out++ = uint8_t((59 + bytes) << 2);
    for (int i = 0; i < bytes; ++i) *out++ = uint8_t(n >> (8 * i));
  }
  std::memcpy(out, lit, len);
  return out + len;
}

inline uint8_t* emit_copy_upto64(uint8_t* out, size_t offset, size_t len) {
  if (len >= 4 && len <= 11 && offset < 2048) {
    *out++ = uint8_t(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *out++ = uint8_t(offset & 0xff);
  } else {
    *out++ = uint8_t(2 | ((len - 1) << 2));
    *out++ = uint8_t(offset & 0xff);
    *out++ = uint8_t(offset >> 8);
  }
  return out;
}

inline uint8_t* emit_copy(uint8_t* out, size_t offset, size_t len) {
  // copies of at most 64 bytes; keep the tail at >= 4 bytes
  while (len >= 68) {
    out = emit_copy_upto64(out, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    out = emit_copy_upto64(out, offset, 60);
    len -= 60;
  }
  return emit_copy_upto64(out, offset, len);
}

uint8_t* compress_block(const uint8_t* in, size_t n, uint8_t* out, uint16_t* table) {
  std::memset(table, 0, sizeof(uint16_t) << kHashBits);
  size_t lit_start = 0;
  if (n >= 16) {
    size_t ip = 1;
    const size_t limit = n - 4;
    while (ip <= limit) {
      uint32_t cur = load32(in + ip);
      uint32_t h = hash32(cur);
      size_t cand = table[h];
      table[h] = uint16_t(ip);
      if (cand < ip && load32(in + cand) == cur) {
        size_t len = 4;
        while (ip + len < n && in[cand + len] == in[ip + len]) ++len;
        if (ip > lit_start) out = emit_literal(out, in + lit_start, ip - lit_start);
        out = emit_copy(out, ip - cand, len);
        ip += len;
        lit_start = ip;
        if (ip <= limit) table[hash32(load32(in + ip - 1))] = uint16_t(ip - 1);
      } else {
        ++ip;
      }
    }
  }
  if (lit_start < n) out = emit_literal(out, in + lit_start, n - lit_start);
  return out;
}

}  // namespace

extern "C" {

uint64_t daft_snappy_max_compressed_length(uint64_t n) { return 32 + n + n / 6; }

// Compress n bytes; out must hold daft_snappy_max_compressed_length(n) bytes.
// Returns the compressed length.
int64_t daft_snappy_compress(const uint8_t* in, uint64_t n, uint8_t* out) {
  uint16_t table[1 << kHashBits];
  uint8_t* p = put_varint(out, n);
  for (uint64_t start = 0; start < n; start += kBlockSize) {
    uint64_t len = n - start < kBlockSize ? n - start : kBlockSize;
    p = compress_block(in + start, len, p, table);
  }
  return int64_t(p - out);
}

// The uncompressed length a compressed buffer declares, or -1.
int64_t daft_snappy_uncompressed_length(const uint8_t* in, uint64_t n) {
  uint64_t out = 0;
  int shift = 0;
  for (uint64_t i = 0; i < n && shift <= 63; ++i, shift += 7) {
    out |= uint64_t(in[i] & 0x7f) << shift;
    if (!(in[i] & 0x80)) return int64_t(out);
  }
  return -1;
}

// Decompress into out (cap bytes). Returns the length written, or a negative
// code: -1 bad length header, -2 output too small, -3 truncated input,
// -4 offset out of range, -5 length differs from the header.
int64_t daft_snappy_decompress(const uint8_t* in, uint64_t n, uint8_t* out, uint64_t cap) {
  uint64_t want = 0;
  int shift = 0;
  uint64_t ip = 0;
  for (;; ++ip, shift += 7) {
    if (ip >= n || shift > 63) return -1;
    want |= uint64_t(in[ip] & 0x7f) << shift;
    if (!(in[ip] & 0x80)) {
      ++ip;
      break;
    }
  }
  if (want > cap) return -2;
  uint64_t op = 0;
  while (ip < n) {
    uint8_t tag = in[ip++];
    uint64_t len, offset;
    switch (tag & 3) {
      case 0: {
        len = tag >> 2;
        if (len >= 60) {
          int bytes = int(len) - 59;
          if (ip + bytes > n) return -3;
          len = 0;
          for (int i = 0; i < bytes; ++i) len |= uint64_t(in[ip + i]) << (8 * i);
          ip += bytes;
        }
        len += 1;
        if (ip + len > n) return -3;
        if (op + len > want) return -5;
        std::memcpy(out + op, in + ip, len);
        ip += len;
        op += len;
        continue;
      }
      case 1:
        if (ip + 1 > n) return -3;
        len = 4 + ((tag >> 2) & 7);
        offset = (uint64_t(tag >> 5) << 8) | in[ip];
        ip += 1;
        break;
      case 2:
        if (ip + 2 > n) return -3;
        len = 1 + (tag >> 2);
        offset = uint64_t(in[ip]) | (uint64_t(in[ip + 1]) << 8);
        ip += 2;
        break;
      default:
        if (ip + 4 > n) return -3;
        len = 1 + (tag >> 2);
        offset = uint64_t(load32(in + ip));
        ip += 4;
        break;
    }
    if (offset == 0 || offset > op) return -4;
    if (op + len > want) return -5;
    uint8_t* dst = out + op;
    const uint8_t* src = dst - offset;
    if (offset >= len) {
      std::memcpy(dst, src, len);
    } else {
      for (uint64_t i = 0; i < len; ++i) dst[i] = src[i];  // overlapping: byte by byte
    }
    op += len;
  }
  return op == want ? int64_t(op) : -5;
}

}  // extern "C"
