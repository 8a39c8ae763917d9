"""Parquet page codecs (the port's own; the reference's pages go through
pyarrow).

- UNCOMPRESSED;
- GZIP through the standard library's zlib;
- SNAPPY, the reference's default, in host C++ (io/csrc/snappy.cpp), built
  with the host compiler at first use (ops/_build.py ``host_library``) and
  loaded with ctypes. A failed build raises: there is no fallback.
  ``plain_snappy_decompress`` is a plain Python decoder of the same format,
  which the tests hold the library against;
- LZO, BROTLI, LZ4, ZSTD and LZ4_RAW raise NotImplementedError naming the
  codec: the card's machine has no library for them.
"""

from __future__ import annotations

import ctypes
import os
import zlib

import numpy as np

UNCOMPRESSED, SNAPPY, GZIP, LZO, BROTLI, LZ4, ZSTD, LZ4_RAW = range(8)
CODEC_NAMES = {UNCOMPRESSED: "UNCOMPRESSED", SNAPPY: "SNAPPY", GZIP: "GZIP", LZO: "LZO",
               BROTLI: "BROTLI", LZ4: "LZ4", ZSTD: "ZSTD", LZ4_RAW: "LZ4_RAW"}
SNAPPY_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                             "snappy.cpp")

_SNAPPY = None


def _snappy():
    global _SNAPPY
    if _SNAPPY is None:
        from ..ops._build import host_library

        lib = host_library(SNAPPY_SOURCE)
        u8p = ctypes.c_void_p
        lib.daft_snappy_max_compressed_length.restype = ctypes.c_uint64
        lib.daft_snappy_max_compressed_length.argtypes = [ctypes.c_uint64]
        lib.daft_snappy_compress.restype = ctypes.c_int64
        lib.daft_snappy_compress.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.daft_snappy_uncompressed_length.restype = ctypes.c_int64
        lib.daft_snappy_uncompressed_length.argtypes = [u8p, ctypes.c_uint64]
        lib.daft_snappy_decompress.restype = ctypes.c_int64
        lib.daft_snappy_decompress.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64]
        _SNAPPY = lib
    return _SNAPPY


def _addr(buf: np.ndarray) -> int:
    return buf.ctypes.data


def snappy_compress(data) -> bytes:
    lib = _snappy()
    src = np.frombuffer(data, dtype=np.uint8) if len(data) else np.zeros(1, np.uint8)
    out = np.empty(lib.daft_snappy_max_compressed_length(len(data)), dtype=np.uint8)
    n = lib.daft_snappy_compress(_addr(src), len(data), _addr(out))
    return out[:n].tobytes()


def snappy_decompress(data, expected: int = None) -> bytes:
    lib = _snappy()
    src = np.frombuffer(data, dtype=np.uint8)
    if not len(src):
        raise ValueError("snappy: empty input")
    want = lib.daft_snappy_uncompressed_length(_addr(src), len(src))
    if want < 0 or (expected is not None and want != expected):
        raise ValueError(f"snappy: bad length header ({want}, expected {expected})")
    out = np.empty(max(want, 1), dtype=np.uint8)
    n = lib.daft_snappy_decompress(_addr(src), len(src), _addr(out), want)
    if n != want:
        raise ValueError(f"snappy: corrupt input (code {n})")
    return out[:n].tobytes()


def plain_snappy_decompress(data) -> bytes:
    """The snappy format decoded in plain Python (the tests' reference)."""
    buf = bytes(data)
    want = shift = pos = 0
    while True:
        b = buf[pos]
        pos += 1
        want |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                nb = n - 59
                n = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            n += 1
            out += buf[pos:pos + n]
            pos += n
            continue
        if kind == 1:
            n = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            n = 1 + (tag >> 2)
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:
            n = 1 + (tag >> 2)
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("snappy: offset out of range")
        start = len(out) - off
        if off >= n:
            out += out[start:start + n]
        else:
            for i in range(n):
                out.append(out[start + i])
    if len(out) != want:
        raise ValueError("snappy: length differs from the header")
    return bytes(out)


def _unsupported(codec: int):
    name = CODEC_NAMES.get(codec, f"codec {codec}")
    return NotImplementedError(f"Parquet compression {name} is not supported by the port "
                               "(UNCOMPRESSED, SNAPPY and GZIP are)")


def decompress(codec: int, data, uncompressed_size: int) -> bytes:
    if codec == UNCOMPRESSED:
        return bytes(data)
    if codec == SNAPPY:
        return snappy_decompress(data, uncompressed_size)
    if codec == GZIP:
        return zlib.decompress(bytes(data), 47)  # gzip or zlib header
    raise _unsupported(codec)


def compress(codec: int, data) -> bytes:
    if codec == UNCOMPRESSED:
        return bytes(data)
    if codec == SNAPPY:
        return snappy_compress(data)
    if codec == GZIP:
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        return c.compress(bytes(data)) + c.flush()
    raise _unsupported(codec)


def codec_by_name(name) -> int:
    key = "UNCOMPRESSED" if name is None else str(name).upper()
    if key == "NONE":
        key = "UNCOMPRESSED"
    for code, n in CODEC_NAMES.items():
        if n == key:
            if code not in (UNCOMPRESSED, SNAPPY, GZIP):
                raise _unsupported(code)
            return code
    raise ValueError(f"unknown Parquet compression {name!r}")
