"""Image kernels: decode, encode, resize, crop, to_mode and to_fixed_shape
over image columns (counterpart of daft_tpu/core/kernels/image.py).

An image column is the reference's struct {data, mode, height, width,
channels}: each row's raw pixels (uint8, uint16 or float32 by its mode) in
``data``, so a fixed-shape column goes to the device as one dense plane
without decoding again. Where the reference asks PIL and cv2, the port has
its own code: PNG through core/kernels/png.py and JPEG through
core/kernels/jpeg.py (other formats raise ``NotImplementedError`` naming
the ROADMAP entry that brings them; a CMYK JPEG becomes RGB as PIL's
``convert`` makes it), PIL's
mode conversions among L, LA, RGB and RGBA in its integer formulas, and
cv2's ``INTER_LINEAR`` resize, fixed point for uint8 images (11-bit
weights, a horizontal pass in integers, the vertical pass as cv2's vector
path rounds it; in the host library, native.py ``image_resize_u8``), and
an exact 2x downscale as cv2's area average. Images
decode, convert and resize on a small thread pool of their own (zlib, the
host library's PNG and JPEG stages and numpy's large operations drop the GIL); the
results are the sequential loop's, row for row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...datatype import DataType, ImageMode
from ..series import Series
from . import jpeg, png

_MODES = ["L", "LA", "RGB", "RGBA", "L16", "LA16", "RGB16", "RGBA16", "RGB32F", "RGBA32F"]
_MODE_INDEX = {m: i for i, m in enumerate(_MODES)}
_INDEX_MODE = {i: m for m, i in _MODE_INDEX.items()}
_PIL_CONVERTIBLE = ("L", "LA", "RGB", "RGBA")

_POOL = None


def _pool():
    global _POOL
    if _POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                   thread_name_prefix="image")
    return _POOL


def _map(fn, items: list) -> list:
    """``fn`` over ``items``, in order: each result, or the exception it
    raised (the caller decides, row by row, what an exception means)."""
    def safe(x):
        try:
            return fn(x)
        except Exception as e:  # noqa: BLE001  (handed back to the caller)
            return e
    if len(items) < 8:
        return [safe(x) for x in items]
    return list(_pool().map(safe, items))


def build_image_series(name: str, images: List[Optional[np.ndarray]],
                       modes: List[Optional[str]]) -> Series:
    """Pack decoded (H, W, C) images into an image struct column
    (image.py:31-59)."""
    n = len(images)
    data = np.empty(n, dtype=object)
    mode_idx = np.zeros(n, dtype=np.uint8)
    hs = np.zeros(n, dtype=np.uint32)
    ws = np.zeros(n, dtype=np.uint32)
    cs = np.zeros(n, dtype=np.uint8)
    valid = np.zeros(n, dtype=bool)
    for i, (img, mode) in enumerate(zip(images, modes)):
        if img is None:
            continue
        if img.ndim == 2:
            img = img[:, :, None]
        data[i] = img.tobytes()
        mode_idx[i] = _MODE_INDEX[mode]
        hs[i], ws[i], cs[i] = img.shape
        valid[i] = True
    kids = [Series("data", DataType.binary(), data, valid.copy()),
            Series("mode", DataType.uint8(), mode_idx, valid.copy()),
            Series("height", DataType.uint32(), hs, valid.copy()),
            Series("width", DataType.uint32(), ws, valid.copy()),
            Series("channels", DataType.uint8(), cs, valid.copy())]
    return Series.nested(name, DataType.image(), None, kids, valid)


IMAGE_FIELDS = ("data", "mode", "height", "width", "channels")


def image_children(series: Series) -> List[Series]:
    """An image column's children in IMAGE_FIELDS order. A column that is
    not a struct raises AttributeError, and a struct without one of the
    fields KeyError, as the reference's ``arr.field`` does (image.py:67-69)."""
    storage = series.dtype.storage
    if not storage.is_struct():
        raise AttributeError(f"a {series.dtype} column has no attribute 'field'")
    names = [f for f, _dt in storage.struct_fields]
    for f in IMAGE_FIELDS:
        if f not in names:
            raise KeyError(f)
    children = series.layout.children
    return [children[names.index(f)] for f in IMAGE_FIELDS]


def _rows(series: Series):
    """[(data bytes, mode, h, w, c) or None] per row of an image column."""
    data, modes, hs, ws, cs = image_children(series)
    ok = (series.validity_numpy() & data.validity_numpy()).tolist()
    return [(d, _INDEX_MODE[m], h, w, c) if v else None
            for d, m, h, w, c, v in zip(data.to_numpy().tolist(), modes.to_numpy().tolist(),
                                        hs.to_numpy().tolist(), ws.to_numpy().tolist(),
                                        cs.to_numpy().tolist(), ok)]


def _pixels(row) -> np.ndarray:
    d, mode, h, w, c = row
    return np.frombuffer(d, dtype=ImageMode.np_dtype(mode)).reshape(h, w, c)


def unpack_images(series: Series):
    """Yield (np image (H, W, C) | None, mode | None) per row
    (image.py:62-79)."""
    for row in _rows(series):
        if row is None:
            yield None, None
        else:
            yield _pixels(row), row[1]


def _decode_one(data: bytes, mode: Optional[str]):
    fmt = png.sniff_format(data)
    if fmt is None:
        raise png.ImageDecodeError("cannot identify image file")
    if fmt == "PNG":
        img = png.decode_png(data)
    elif fmt == "JPEG":
        img = jpeg.decode_jpeg(data)
        if img.mode == "CMYK":
            if mode is not None and mode not in _MODE_INDEX:
                raise ValueError(f"conversion from CMYK to {mode} not supported")
            # PIL converts CMYK to the other modes by way of RGB
            img = png.PngImage(jpeg.cmyk_to_rgb(img.pixels), "RGB")
    else:
        raise png.deferred_format_error(fmt)
    target = mode or ("RGB" if img.mode not in _MODE_INDEX else img.mode)
    if img.mode == target:
        px = img.pixels
        return (px[:, :, None] if px.ndim == 2 else px), target
    return png.convert(img, target), target


def decode(series: Series, mode: Optional[str] = None, on_error: str = "raise") -> Series:
    """Decode encoded image bytes into an image column (image.py:82-105): a
    mode outside the image modes (PIL's "1", "P", "I;16") becomes "RGB"
    unless ``mode`` names one. Bytes of no image raise, or give null under
    ``on_error="null"``; bytes of a format the port cannot decode yet raise
    ``NotImplementedError`` either way."""
    values = series.to_pylist()
    results = _map(lambda v: None if v is None else _decode_one(v, mode), values)
    imgs, modes = [], []
    for r in results:
        if isinstance(r, NotImplementedError) or (isinstance(r, Exception)
                                                  and on_error == "raise"):
            raise r
        if r is None or isinstance(r, Exception):
            imgs.append(None)
            modes.append(None)
        else:
            imgs.append(r[0])
            modes.append(r[1])
    return build_image_series(series.name, imgs, modes)


def encode(series: Series, image_format: str = "PNG") -> Series:
    """Encode an image column back to bytes (image.py:108-128): PNG at zlib
    level 6, JPEG as PIL's default save writes it (quality 75, 4:2:0; L
    and RGB images, others raise as PIL does); another format raises
    ``NotImplementedError`` naming the ROADMAP entry that brings it."""
    fmt = image_format.upper().replace("JPG", "JPEG")
    if fmt not in ("PNG", "JPEG"):
        raise png.deferred_format_error(fmt)
    rows = _rows(series)

    def one(row):
        if row is None:
            return None
        if row[1] not in _PIL_CONVERTIBLE:
            raise ValueError(f"cannot encode a {row[1]} image as {fmt}")
        if fmt == "JPEG":
            if row[1] not in ("L", "RGB"):
                raise OSError(f"cannot write mode {row[1]} as JPEG")
            return jpeg.encode_jpeg(_pixels(row))
        return png.encode_png(_pixels(row))
    out = _map(one, rows)
    for r in out:
        if isinstance(r, Exception):
            raise r
    values = np.empty(len(out), dtype=object)
    values[:] = out
    return Series(series.name, DataType.binary(), values,
                  np.array([v is not None for v in out], dtype=bool))


# ---- resize: cv2's INTER_LINEAR ---------------------------------------------------------

_COEF = 2048  # cv2's INTER_RESIZE_COEF_SCALE


def _taps(src: int, dst: int):
    """(first source index, second, weight of the first as a float32 in
    [0, 1]) per output index, clamped at the borders as cv2 clamps them."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    low = s < 0
    high = s >= src - 1
    s = np.where(low, 0, np.where(high, src - 1, s))
    f = np.where(low | high, np.float32(0), f).astype(np.float32)
    return s, np.minimum(s + 1, src - 1), f


def _resize_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    from ... import native

    sh, sw, _c = img.shape
    xs0, xs1, fx = _taps(sw, w)
    ys0, ys1, fy = _taps(sh, h)
    a0 = np.rint((np.float32(1) - fx) * np.float32(_COEF)).astype(np.int32)
    b0 = np.rint((np.float32(1) - fy) * np.float32(_COEF)).astype(np.int32)
    return native.image_resize_u8(img, xs0, xs1, a0, ys0, ys1, b0)


def _resize_float(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint16 and float32 images: cv2's float weights, rounded to the
    nearest integer (half to even) for uint16."""
    sh, sw, _c = img.shape
    xs0, xs1, fx = _taps(sw, w)
    ys0, ys1, fy = _taps(sh, h)
    src = img.astype(np.float32)
    horiz = src[:, xs0, :] * (np.float32(1) - fx)[None, :, None] + \
        src[:, xs1, :] * fx[None, :, None]
    out = horiz[ys0] * (np.float32(1) - fy)[:, None, None] + horiz[ys1] * fy[:, None, None]
    if img.dtype == np.uint16:
        return np.clip(np.rint(out), 0, 65535).astype(np.uint16)
    return out.astype(img.dtype)


def resize_image(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """One (H, W, C) image resized to (h, w, C) as ``cv2.resize(img, (w,
    h), interpolation=cv2.INTER_LINEAR)``: an exact 2x downscale averages
    each 2 x 2 block, as cv2 switches to its area path there."""
    sh, sw, c = img.shape
    if (sh, sw) == (h, w):
        return img.copy()
    if img.dtype == np.uint8 and sw == 2 * w and sh == 2 * h:
        q = img.astype(np.uint16)
        s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    if img.dtype == np.uint8:
        return _resize_u8(img, w, h)
    return _resize_float(img, w, h)


def _per_image(series: Series, fn) -> Series:
    rows = _rows(series)
    out = _map(lambda r: None if r is None else fn(_pixels(r), r[1]), rows)
    for r in out:
        if isinstance(r, Exception):
            raise r
    return build_image_series(series.name, [None if r is None else r[0] for r in out],
                              [None if r is None else r[1] for r in out])


def resize(series: Series, w: int, h: int) -> Series:
    """Each image resized to w x h (image.py:131-145)."""
    return _per_image(series, lambda img, m: (resize_image(img, w, h), m))


def crop(series: Series, bbox: Sequence[int]) -> Series:
    """bbox = (x, y, w, h) (image.py:148-160)."""
    x, y, w, h = bbox
    return _per_image(series, lambda img, m: (img[y:y + h, x:x + w], m))


def convert_mode(img: np.ndarray, src: str, dst: str) -> np.ndarray:
    """An (H, W, C) image of mode ``src`` in mode ``dst`` as PIL converts
    it, among L, LA, RGB and RGBA."""
    if src == dst:
        return img
    if src not in _PIL_CONVERTIBLE or dst not in _PIL_CONVERTIBLE:
        raise ValueError(f"conversion from {src} to {dst} not supported")
    px = img[:, :, 0] if src == "L" else img
    return png.convert(png.PngImage(px, src), dst)


def to_mode(series: Series, mode: str) -> Series:
    """Each image in ``mode`` (image.py:163-183)."""
    return _per_image(series, lambda img, m: (convert_mode(img, m, mode), mode))


def to_fixed_shape(series: Series, mode: str, h: int, w: int) -> Series:
    """Convert and resize into a fixed-shape image column: one dense
    (n, h, w, c) buffer, zero under a null row, ready for the device as one
    plane (image.py:186-212, "the TPU preprocessing entry point")."""
    c = ImageMode.num_channels(mode)
    npdt = np.dtype(ImageMode.np_dtype(mode))
    rows = _rows(series)
    n = len(rows)
    dense = np.zeros((n, h, w, c), dtype=npdt)

    def one(i):
        row = rows[i]
        img = convert_mode(_pixels(row), row[1], mode)
        dense[i] = resize_image(img, w, h).astype(npdt, copy=False)
        return True
    live = [i for i, r in enumerate(rows) if r is not None]
    for r in _map(one, live):
        if isinstance(r, Exception):
            raise r
    valid = np.zeros(n, dtype=bool)
    valid[live] = True
    return Series.from_numpy(dense, series.name, DataType.fixed_shape_image(mode, h, w),
                             validity=valid)
