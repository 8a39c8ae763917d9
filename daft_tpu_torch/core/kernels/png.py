"""The port's PNG codec: what the reference asks of PIL in
daft_tpu/core/kernels/image.py:82-128, without PIL.

Decode reads every PNG colour type (gray, gray + alpha, RGB, RGBA, palette,
with ``tRNS``), bit depths 1-16 and Adam7 interlacing, and gives the pixels
as PIL's PNG reader does (PngImagePlugin's modes):

- gray at 1 bit is mode "1" (0 / 255), at 2 and 4 bits "L" scaled to 8 bits
  (x 85, x 17), at 8 bits "L", at 16 bits "I;16";
- RGB and RGBA at 16 bits keep each sample's high byte; gray + alpha at 16
  bits is "RGBA" of the high bytes;
- a palette image is "P", its palette and ``tRNS`` alphas beside it;
- ``tRNS`` of a gray or RGB image is its transparent colour.

``convert`` then gives PIL's ``Image.convert`` among the modes an image
column holds (L, LA, RGB, RGBA): gray from colour by ITU-R 601-2 luma in
PIL's integers, ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``; "I;16" to
8 bits clipped at 255; a colour key or the palette's alphas where the
target has alpha (an RGB key's pixels in LA keep their red sample, as
PIL's do). Unfiltering runs in the host kernel library
(native.py ``png_unfilter``); zlib is the standard library's.

Encode writes 8-bit L, LA, RGB and RGBA, every row with the Sub filter, at
zlib level 6 (PIL's default); its bytes are its own, its pixels PIL's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# (bit depth, colour type) -> PIL's mode (PngImagePlugin._MODES)
_PIL_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB",
    (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA",
    (8, 6): "RGBA", (16, 6): "RGBA",
}
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))

# magic numbers of the formats the port does not decode yet (ROADMAP Queue 1)
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"))
DEFERRED_CODECS = ("the image codecs entry of ROADMAP Queue 1 (GIF, BMP, TIFF and WebP, the "
                   "other formats PIL reads)")


class ImageDecodeError(OSError, ValueError):
    """Bytes the port cannot read as an image: an OSError, as PIL's errors
    are (``UnidentifiedImageError``, "image file is truncated"), and a
    ValueError, as the port's image decode has always raised."""


class PngImage:
    """A decoded PNG in PIL's representation: ``pixels`` (h, w) or (h, w, c)
    of PIL's mode ``mode``; ``palette`` ((k, 3) uint8) of a "P" image;
    ``transparency``: a palette image's alphas (k,), a gray image's key, an
    RGB image's (r, g, b) key, or None."""

    __slots__ = ("pixels", "mode", "palette", "transparency")

    def __init__(self, pixels, mode, palette=None, transparency=None):
        self.pixels = pixels
        self.mode = mode
        self.palette = palette
        self.transparency = transparency


def sniff_format(data: bytes) -> Optional[str]:
    """"PNG", "JPEG", the name of another image format the port cannot
    decode yet (GIF, BMP, TIFF, WebP), or None for bytes of no known image."""
    if data[:8] == SIGNATURE:
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return None


def deferred_format_error(fmt: str) -> NotImplementedError:
    return NotImplementedError(f"{fmt} images are not supported by the port yet: they come "
                               f"with {DEFERRED_CODECS}")


def _chunks(data: bytes):
    pos = 8
    n = len(data)
    while pos + 8 <= n:
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > n:
            raise ValueError("truncated PNG chunk")
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[end - 4:end])[0]
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"broken PNG file: bad CRC in {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError("truncated PNG file: no IEND chunk")


def _samples(lines: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered scanlines (h, stride) as (h, w, channels) samples (uint8
    below 16 bits, uint16 at 16)."""
    h = lines.shape[0]
    if depth == 8:
        return lines[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return lines[:, :2 * w * channels].copy().view(">u2").astype(np.uint16) \
            .reshape(h, w, channels)
    per = 8 // depth
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
    vals = (lines[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w].reshape(h, w, 1)


def _pass_samples(raw: np.ndarray, w: int, h: int, depth: int, channels: int):
    """(samples of a w x h (sub-)image, bytes of raw it took)."""
    from ...native import png_unfilter

    stride = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    used = h * (stride + 1)
    if len(raw) < used:
        raise ValueError("truncated PNG image data")
    lines = png_unfilter(raw[:used], h, stride, bpp)
    return _samples(lines, w, depth, channels), used


def decode_png(data: bytes) -> PngImage:
    """Decode one PNG file into PIL's representation (module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    ihdr = None
    idat = []
    palette = None
    trns = None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype_, comp, filt, interlace = ihdr
    mode = _PIL_MODES.get((depth, ctype_))
    if mode is None or comp != 0 or filt != 0 or interlace > 1 or w == 0 or h == 0:
        raise ValueError(f"unsupported PNG header: {w}x{h}, depth {depth}, colour type "
                         f"{ctype_}, interlace {interlace}")
    if ctype_ == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    channels = _SAMPLES[ctype_]
    if not interlace:
        samples, _used = _pass_samples(raw, w, h, depth, channels)
    else:
        samples = np.zeros((h, w, channels), dtype=np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for xs, ys, dx, dy in _ADAM7:
            pw, ph = (w - xs + dx - 1) // dx, (h - ys + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _pass_samples(raw[pos:], pw, ph, depth, channels)
            samples[ys::dy, xs::dx] = sub
            pos += used
    return _to_pil(samples, depth, ctype_, mode, palette, trns)


def _to_pil(samples: np.ndarray, depth: int, ctype: int, mode: str, palette, trns):
    transparency = None
    if ctype == 0:
        g = samples[:, :, 0]
        if depth == 1:
            pixels = (g * 255).astype(np.uint8)
        elif depth in (2, 4):
            pixels = (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        else:
            pixels = g
        if trns is not None and len(trns) >= 2:
            transparency = struct.unpack(">H", trns[:2])[0]
        return PngImage(pixels, mode, transparency=transparency)
    if ctype == 3:
        alphas = None
        if trns is not None:
            alphas = np.full(max(len(palette), 256), 255, dtype=np.uint8)
            t = np.frombuffer(trns, dtype=np.uint8)[:len(alphas)]
            alphas[:len(t)] = t
        return PngImage(samples[:, :, 0].astype(np.uint8), mode, palette, alphas)
    high = (samples >> 8).astype(np.uint8) if depth == 16 else samples
    if ctype == 2:
        if trns is not None and len(trns) >= 6:
            transparency = struct.unpack(">HHH", trns[:6])
        return PngImage(high, mode, transparency=transparency)
    if ctype == 4 and depth == 16:
        g, a = high[:, :, 0], high[:, :, 1]
        return PngImage(np.stack([g, g, g, a], axis=2), mode)
    return PngImage(high, mode)


# ---- conversion (PIL's Image.convert among the image column's modes) -------------------

_TARGETS = ("L", "LA", "RGB", "RGBA")


def luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma in PIL's integers, of (..., 3+) uint8 colour."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def convert(img: PngImage, target: str) -> np.ndarray:
    """``img`` in mode ``target`` (L, LA, RGB or RGBA) as PIL converts it,
    (h, w, c) uint8."""
    if target not in _TARGETS:
        raise ValueError(f"conversion from {img.mode} to {target} not supported")
    mode, px = img.mode, img.pixels
    h, w = px.shape[:2]
    opaque = np.full((h, w), 255, dtype=np.uint8)
    if mode in ("1", "L", "I;16"):
        g = np.minimum(px, 255).astype(np.uint8) if mode == "I;16" else px
        alpha = opaque
        if img.transparency is not None and target in ("LA", "RGBA") and mode != "I;16":
            key = img.transparency if mode != "1" else (255 if img.transparency else 0)
            alpha = np.where(px == key, 0, 255).astype(np.uint8)
        return _from_gray(g, alpha, target)
    if mode == "P":
        pal = np.zeros((256, 3), dtype=np.uint8)
        pal[:min(len(img.palette), 256)] = img.palette[:256]
        rgb = pal[px]
        alpha = img.transparency[px] if img.transparency is not None else opaque
        if target in ("L", "LA"):
            lum = luma(pal)[px]
            return lum[:, :, None] if target == "L" else np.stack([lum, alpha], axis=2)
        return rgb if target == "RGB" else np.concatenate([rgb, alpha[:, :, None]], axis=2)
    if mode == "LA":
        return _from_gray(px[:, :, 0], px[:, :, 1], target)
    if mode == "RGB":
        alpha = opaque
        if img.transparency is not None and target in ("LA", "RGBA"):
            key = (px == np.asarray(img.transparency)).all(axis=2)
            alpha = np.where(key, 0, 255).astype(np.uint8)
            if target == "LA":  # PIL gives a keyed pixel its red sample as gray
                return np.stack([np.where(key, px[:, :, 0], luma(px)), alpha], axis=2)
        return _from_color(px, alpha, target)
    if mode == "RGBA":
        return _from_color(px[:, :, :3], px[:, :, 3], target)
    raise ValueError(f"conversion from {mode} to {target} not supported")


def _from_gray(g: np.ndarray, alpha: np.ndarray, target: str) -> np.ndarray:
    if target == "L":
        return g[:, :, None]
    if target == "LA":
        return np.stack([g, alpha], axis=2)
    if target == "RGB":
        return np.stack([g, g, g], axis=2)
    return np.stack([g, g, g, alpha], axis=2)


def _from_color(rgb: np.ndarray, alpha: np.ndarray, target: str) -> np.ndarray:
    if target == "L":
        return luma(rgb)[:, :, None]
    if target == "LA":
        return np.stack([luma(rgb), alpha], axis=2)
    if target == "RGB":
        return np.ascontiguousarray(rgb)
    return np.concatenate([rgb, alpha[:, :, None]], axis=2)


# ---- encode ---------------------------------------------------------------------------

_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + \
        struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit (h, w, c) image (c of 1-4: L, LA, RGB, RGBA) as PNG bytes:
    every row Sub-filtered, zlib at ``level``."""
    px = np.ascontiguousarray(pixels)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, c = px.shape
    if px.dtype != np.uint8 or c not in _COLOUR_TYPES:
        raise ValueError(f"PNG encode takes 8-bit images of 1-4 channels, got {px.dtype} "
                         f"x {c}")
    rows = px.reshape(h, w * c)
    filtered = np.empty((h, w * c + 1), dtype=np.uint8)
    filtered[:, 0] = 1
    filtered[:, 1:c + 1] = rows[:, :c]
    np.subtract(rows[:, c:], rows[:, :-c], out=filtered[:, c + 1:], dtype=np.uint8,
                casting="unsafe")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPES[c], 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + \
        _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)) + _chunk(b"IEND", b"")
