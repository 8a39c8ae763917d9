"""The port's JPEG codec: what the reference asks of PIL in
daft_tpu/core/kernels/image.py:82-128, without PIL, held bit for bit to
PIL 12 over libjpeg-turbo 3.

Decode reads baseline, extended (SOF1) and progressive frames at 8 bits:
DQT of 8- and 16-bit tables, DHT, DRI with RST0-7 markers, JFIF and Adobe
APP markers (the Adobe transform flag picks RGB / YCbCr and CMYK / YCCK
as libjpeg does), COM and other APPn skipped. The markers are parsed here;
the entropy decode, libjpeg's integer "islow" IDCT, jdsample.c's
upsampling (fancy h2v1, h1v2 and h2v2; replication for other factors, as
4:1:1's h4v1) and jdcolor.c's fixed-point YCbCr -> RGB run in the host
kernel library (native.py ``jpeg_decode_scan``, ``jpeg_idct``,
``jpeg_upsample``, ``jpeg_color``). The pixels are PIL's: one component
is mode "L", three "RGB", four "CMYK" (read as PIL's inverted "CMYK;I").
Arithmetic coding, 12-bit samples, lossless and hierarchical frames raise
``NotImplementedError`` naming ROADMAP Queue 1's image-codec entry; bytes
that end before the EOI marker raise ``ImageDecodeError`` (an OSError, as
PIL's "image file is truncated" is).

Encode writes what PIL's ``save(format="JPEG")`` writes by default: a
JFIF header, quality 75 with the standard IJG tables scaled as
jcparam.c scales them, 4:2:0 for RGB (jcsample.c's h2v2 with its 1, 2
bias) or one component for "L", jccolor.c's RGB -> YCbCr, the islow FDCT
(jfdctint.c), libjpeg-turbo's reciprocal quantization, the standard
Huffman tables and libjpeg's dummy blocks at the edges. ``quality`` and
``subsampling`` ("4:2:0", "4:2:2", "4:4:4", or "4:1:1" by jcsample.c's
``int_downsample``) are the writer's own options; the
entropy coding runs in the host library (``jpeg_encode_scan``).
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ... import native
from .png import ImageDecodeError, PngImage

DEFERRED_JPEG = ("the image codecs entry of ROADMAP Queue 1 (GIF, BMP, TIFF and WebP, and "
                 "the JPEG variants: arithmetic coding, 12-bit samples, lossless and "
                 "hierarchical frames)")

NATURAL = native.JPEG_NATURAL[:64]

# jcparam.c's tables, natural order
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int64)
STD_CHROMA_Q = np.full(64, 99, dtype=np.int64)
STD_CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                      [24, 26, 56, 99], [47, 66, 99, 99]]

_AC_TAIL = [r * 16 + s for r in range(16) for s in range(1, 11)]


def _ac_values(head: List[int]) -> List[int]:
    """A standard AC table's symbols: ``head`` then every (run, size)
    symbol not in it, in order."""
    seen = set(head)
    return head + [v for v in _AC_TAIL if v not in seen]


STD_HUFF = {  # (class, id) -> (counts of codes of length 1-16, symbols): Annex K.3
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values(
        [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
         0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
         0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
         0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
         0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
         0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
         0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
         0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
         0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
         0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
         0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA])),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values(
        [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
         0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
         0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
         0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
         0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
         0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
         0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
         0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
         0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
         0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
         0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA])),
}

_SOF_KIND = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive"}
_SOF_DEFERRED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                 0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
                 0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
                 0xCF: "arithmetic-coded"}


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} JPEG images are not supported by the port yet: they "
                               f"come with {DEFERRED_JPEG}")


def _broken(what: str) -> ImageDecodeError:
    return ImageDecodeError(f"broken JPEG data: {what}")


def huffman_table(counts, symbols) -> np.ndarray:
    """A DHT table as the decoder's int32 layout (csrc/kernels.cpp):
    8-bit lookahead, maxcode and value offset by code length, symbols."""
    t = np.zeros(native.JPEG_HUFF_INTS, dtype=np.int32)
    t[256:274] = -1
    code = k = 0
    for ln in range(1, 17):
        n = counts[ln - 1]
        if n:
            t[274 + ln] = k - code
            for i in range(n):
                if ln <= 8:
                    lo = (code + i) << (8 - ln)
                    t[lo:lo + (1 << (8 - ln))] = (ln << 8) | symbols[k + i]
            code += n
            k += n
            t[256 + ln] = code - 1
        code <<= 1
    t[292:292 + len(symbols)] = symbols
    return t


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "dw", "dh", "stride", "rows", "offset",
                 "qt")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


def next_marker(data: bytes, pos: int) -> int:
    """The index of the next marker's 0xFF at or after ``pos`` (0xFF then
    a byte that is neither 0 nor 0xFF), or ``len(data)``."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            return n
        nxt = data[pos + 1]
        if nxt != 0 and nxt != 0xFF:
            return pos
        pos += 1


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise ImageDecodeError("image file is truncated")
    return (data[pos] << 8) | data[pos + 1]


def decode_jpeg(data: bytes) -> PngImage:
    """JPEG bytes as PIL reads them: (h, w) "L", (h, w, 3) "RGB" or (h, w,
    4) "CMYK" pixels."""
    if data[:2] != b"\xff\xd8":
        raise ImageDecodeError("cannot identify image file")
    n = len(data)
    qts: Dict[int, np.ndarray] = {}
    tables = np.zeros((8, native.JPEG_HUFF_INTS), dtype=np.int32)
    comps: List[_Component] = []
    frame: Optional[Tuple[str, int, int]] = None
    coefs = None
    ri = 0
    jfif = False
    adobe: Optional[int] = None
    pos = 2
    while True:
        pos = next_marker(data, pos)
        if pos >= n:
            raise ImageDecodeError("image file is truncated")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker == 0xD8:
            raise _broken("a second SOI marker")
        length = _u16(data, pos)
        if length < 2 or pos + length > n:
            raise ImageDecodeError("image file is truncated")
        seg = data[pos + 2:pos + length]
        if marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            _read_dqt(seg, qts)
        elif marker == 0xC4:
            _read_dht(seg, tables)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise _broken("short DRI marker")
            ri = (seg[0] << 8) | seg[1]
        elif marker in _SOF_DEFERRED or marker == 0xCC:
            raise _deferred(_SOF_DEFERRED.get(marker, "arithmetic-coded"))
        elif marker in _SOF_KIND:
            if frame is not None:
                raise _broken("a second frame")
            frame, comps = _read_sof(marker, seg)
            coefs = _allocate(comps, frame)
        elif marker == 0xDA:
            if frame is None:
                raise _broken("a scan before its frame")
            pos = _scan(data, pos, seg, frame, comps, qts, tables, coefs, ri)
            continue
        pos += length
    if frame is None or any(c.qt is None for c in comps):
        raise _broken("no image data")
    return _finish(frame, comps, coefs, jfif, adobe)


def _read_dqt(seg: bytes, qts: Dict[int, np.ndarray]) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 128 if pq else 64
        if i + 1 + size > len(seg) or tq > 3:
            raise _broken("bad DQT marker")
        vals = np.frombuffer(seg[i + 1:i + 1 + size], dtype=">u2" if pq else np.uint8)
        q = np.zeros(64, dtype=np.uint16)
        q[NATURAL] = vals
        qts[tq] = q
        i += 1 + size


def _read_dht(seg: bytes, tables: np.ndarray) -> None:
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        if i + 17 > len(seg) or tc > 1 or th > 3:
            raise _broken("bad DHT marker")
        counts = list(seg[i + 1:i + 17])
        total = sum(counts)
        if total > 256 or i + 17 + total > len(seg):
            raise _broken("bad DHT marker")
        tables[tc * 4 + th] = huffman_table(counts, list(seg[i + 17:i + 17 + total]))
        i += 17 + total


def _read_sof(marker: int, seg: bytes):
    if len(seg) < 6:
        raise _broken("short SOF marker")
    precision, height, width, nc = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
    if precision != 8:
        raise _deferred(f"{precision}-bit")
    if height == 0 or width == 0 or nc not in (1, 3, 4) or len(seg) < 6 + 3 * nc:
        raise _broken(f"unsupported frame ({width} x {height}, {nc} components)")
    comps = []
    for c in range(nc):
        cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise _broken("bad sampling factors")
        comps.append(_Component(cid, h, v, tq))
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    for c in comps:
        if max_h % c.h or max_v % c.v:
            raise ImageDecodeError("fractional sampling not implemented yet")
        c.dw = -(-width * c.h // max_h)
        c.dh = -(-height * c.v // max_v)
        c.bw = -(-c.dw // 8)
        c.bh = -(-c.dh // 8)
    return (_SOF_KIND[marker], width, height), comps


def _allocate(comps: List[_Component], frame) -> np.ndarray:
    """One int16 buffer for every component's blocks: the MCU grid of an
    interleaved frame (dummy blocks included), a lone component's own."""
    _kind, width, height = frame
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    mcus_x, mcus_y = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    off = 0
    for c in comps:
        if len(comps) == 1:
            c.stride, c.rows = c.bw, c.bh
        else:
            c.stride, c.rows = mcus_x * c.h, mcus_y * c.v
        c.offset = off
        off += c.stride * c.rows
    return np.zeros((off, 64), dtype=np.int16)


def _scan(data, pos, seg, frame, comps, qts, tables, coefs, ri) -> int:
    ns = seg[0] if seg else 0
    if ns < 1 or ns > 4 or len(seg) < 4 + 2 * ns:
        raise _broken("bad SOS marker")
    ids = {c.cid: i for i, c in enumerate(comps)}
    members = []
    for k in range(ns):
        cid, tt = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid not in ids:
            raise _broken("a scan of an unknown component")
        members.append((comps[ids[cid]], tt >> 4, tt & 15))
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    progressive = frame[0] == "progressive"
    if not progressive:
        ss, se, ahal = 0, 63, 0
    elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and ns != 1):
        raise _broken("bad progression parameters")
    for c, _td, _ta in members:
        if c.qt is None:
            if c.tq not in qts:
                raise _broken("a component without its quantization table")
            c.qt = qts[c.tq].copy()  # latched at the component's first scan, as libjpeg does
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    _kind, width, height = frame
    params = [int(progressive), ss, se, ahal >> 4, ahal & 15, ri, ns,
              -(-width // (8 * max_h)), -(-height // (8 * max_v))]
    for c, td, ta in members:
        params += [c.offset, c.stride, c.h, c.v, td & 3, ta & 3, c.bw, c.bh]
    return native.jpeg_decode_scan(data, pos + len(seg) + 2, np.array(params, np.int32),
                                   tables.reshape(-1), coefs)


def _finish(frame, comps, coefs, jfif, adobe) -> PngImage:
    _kind, width, height = frame
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        plane = native.jpeg_idct(coefs[c.offset:c.offset + c.stride * c.rows], c.stride,
                                 c.bw, c.bh, c.qt)
        hf, vf = max_h // c.h, max_v // c.v
        if hf == 1 and vf == 1:
            planes.append(np.ascontiguousarray(plane[:height, :width]))
        else:
            planes.append(native.jpeg_upsample(plane, c.dw, c.dh, hf, vf, width, height))
    if len(comps) == 1:
        return PngImage(planes[0], "L")
    if len(comps) == 3:
        # jdapimin.c default_decompress_parms: JFIF, then Adobe, then the ids
        if jfif:
            space = 0
        elif adobe is not None:
            space = 1 if adobe == 0 else 0
        else:
            space = 1 if [c.cid for c in comps] == [82, 71, 66] else 0
        return PngImage(native.jpeg_color(planes, space), "RGB")
    space = 3 if adobe is not None and adobe != 0 else 2
    return PngImage(native.jpeg_color(planes, space), "CMYK")


def cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a CMYK image (Convert.c ``cmyk2rgb``)."""
    p = px.astype(np.int32)
    nk = 255 - p[:, :, 3:4]
    t = p[:, :, :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# ---- encode ---------------------------------------------------------------------------


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c ``jpeg_set_quality`` with force_baseline: the natural-order
    table scaled by quality."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _quantizer(q: tuple) -> np.ndarray:
    return quantizer(np.array(q, dtype=np.int64))


def quantizer(q: np.ndarray) -> np.ndarray:
    """jcdctmgr.c ``compute_reciprocal`` of each divisor (q << 3) as
    libjpeg-turbo's 16-bit SIMD build computes it: 64 reciprocals, 64
    corrections and 64 shifts, as ``native.jpeg_fdct_quant`` takes them."""
    recip, corr, shift = [], [], []
    for d in (q * 8).tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip + corr + shift, dtype=np.int32)


def _huff_codes(counts, symbols) -> np.ndarray:
    """jchuff.c's derived table: code then length, indexed by symbol."""
    t = np.zeros(512, dtype=np.int32)
    code = k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            t[symbols[k]] = code
            t[256 + symbols[k]] = ln
            code += 1
            k += 1
        code <<= 1
    return t


_SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:1:1": (4, 1)}
_EHUF = np.concatenate([_huff_codes(*STD_HUFF[k]) for k in ((0, 0), (0, 1), (1, 0), (1, 1))])


def encode_jpeg(pixels: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """(h, w) or (h, w, 1) gray or (h, w, 3) RGB uint8 pixels as baseline
    JPEG bytes, what PIL's ``save(format="JPEG", quality=quality,
    subsampling=...)`` codes: PIL decodes both to the same pixels."""
    px = np.asarray(pixels)
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[:, :, 0]
    if px.dtype != np.uint8 or not (px.ndim == 2 or (px.ndim == 3 and px.shape[2] == 3)):
        raise OSError(f"cannot write mode {_mode_of(px)} as JPEG")
    height, width = px.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"cannot write a {width} x {height} image as JPEG")
    if px.ndim == 2:
        samp = [(1, 1)]
    else:
        if subsampling not in _SAMPLINGS:
            raise ValueError(f"the writer has no {subsampling!r} subsampling")
        samp = [_SAMPLINGS[subsampling], (1, 1), (1, 1)]
    qtabs = [quant_table(STD_LUMA_Q, quality), quant_table(STD_CHROMA_Q, quality)]
    max_h, max_v = max(h for h, _ in samp), max(v for _, v in samp)
    mcus_x, mcus_y = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    blocks, params, off = [], [len(samp), mcus_x, mcus_y], 0
    for ci, (h, v) in enumerate(samp):
        t = 0 if ci == 0 else 1
        bw = -(-(-(-width * h // max_h)) // 8)
        bh = -(-(-(-height * v // max_v)) // 8)
        plane = native.jpeg_component_plane(px, ci, max_h // h, max_v // v, max_v, bw, bh)
        real = native.jpeg_fdct_quant(plane, _quantizer(tuple(qtabs[t].tolist())))
        grid = np.zeros((mcus_y * v, mcus_x * h, 64), dtype=np.int16)
        grid[:bh, :bw] = real
        # jccoefct.c's dummy blocks: AC zero, DC of the block before them
        if mcus_x * h > bw:
            grid[:bh, bw:, 0] = grid[:bh, bw - 1:bw, 0]
        for y in range(bh, mcus_y * v):
            grid[y, :, 0] = np.repeat(grid[y - 1, h - 1::h, 0], h)
        blocks.append(grid.reshape(-1, 64))
        params += [off, mcus_x * h, h, v, t, t]
        off += grid.shape[0] * grid.shape[1]
    data = native.jpeg_encode_scan(np.concatenate(blocks), np.array(params, np.int32), _EHUF)
    return _headers(width, height, samp, qtabs) + data + b"\xff\xd9"


def _mode_of(px: np.ndarray) -> str:
    c = 1 if px.ndim == 2 else px.shape[2]
    return {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(c, f"{c}-channel")


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _headers(width, height, samp, qtabs) -> bytes:
    nc = len(samp)
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(1 if nc == 1 else 2):
        out.append(_marker(0xDB, bytes([t]) + bytes(qtabs[t][NATURAL].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, height, width, nc)
    for ci, (h, v) in enumerate(samp):
        sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
    out.append(_marker(0xC0, sof))
    for t in range(1 if nc == 1 else 2):
        for cls in (0, 1):
            counts, symbols = STD_HUFF[(cls, t)]
            out.append(_marker(0xC4, bytes([(cls << 4) | t] + counts + symbols)))
    sos = bytes([nc])
    for ci in range(nc):
        t = 0 if ci == 0 else 1
        sos += bytes([ci + 1, (t << 4) | t])
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(out)
