"""The multimodal wave of the scalar function registry (counterpart of
daft_tpu/functions/registry.py:874-1112 and breadth.py:318-374, 636-721):
the embedding distances and norm, minhash, tokenize with the "bytes"
tokenizer, the image functions and accessors, url download and upload, and
the lazy file functions.

Images decode and encode through the port's own PNG codec
(core/kernels/png.py); url and file functions read local paths and
``file://`` URLs. What the port does not have yet raises
``NotImplementedError`` naming the ROADMAP entry that brings it: other
image formats, a tokenizer model file, a remote URL.
"""

from __future__ import annotations

import os
import uuid as _uuid
from typing import List

import numpy as np

from ..core.series import Series
from ..datatype import DataType
from .registry import _rt_const, register

_F64 = DataType.float64()
_U32 = DataType.uint32()


def _binary(name: str, values: list) -> Series:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return Series(name, DataType.binary(), out,
                  np.array([v is not None for v in values], dtype=bool))


# ---- embedding / vector distance (registry.py:874-938) ----------------------------------


def _vec_2d(s: Series) -> np.ndarray:
    """(n, d) float64 rows of an embedding, a fixed-shape kind or a list
    column (variable lists must be rectangular)."""
    v = s.to_numpy()
    if v.dtype == object or v.ndim == 1:
        rows = s.to_pylist()
        d = next((len(r) for r in rows if r is not None), 0)
        out = np.zeros((len(rows), d), dtype=np.float64)
        for i, r in enumerate(rows):
            if r is not None:
                out[i] = np.asarray(r, dtype=np.float64)
        return out
    if v.ndim != 2:
        raise ValueError(f"a {s.dtype} column's rows are not vectors")
    return v.astype(np.float64)


def _vec_pair(args):
    a, b = args[0], args[1]
    av, bv = _vec_2d(a), _vec_2d(b)
    if len(b) == 1 and len(a) != 1:
        bv = np.broadcast_to(bv, (len(a), bv.shape[1]))
    valid = a.validity_numpy() & (b.validity_numpy() if len(b) == len(a)
                                  else np.ones(len(a), bool))
    return a, av, bv, valid


def _float_out(name: str, out: np.ndarray, valid: np.ndarray) -> Series:
    valid = np.asarray(valid, dtype=bool)
    out = np.where(valid, out, np.nan) if not valid.all() else out
    return Series(name, _F64, np.ascontiguousarray(out, dtype=np.float64), valid.copy())


def _mk_dist(fn):
    def host(args, kwargs):
        a, av, bv, valid = _vec_pair(args)
        with np.errstate(all="ignore"):
            out = fn(av, bv)
        return _float_out(a.name, out, valid)
    return host


def _cosine(av, bv):
    num = (av * bv).sum(axis=1)
    den = np.linalg.norm(av, axis=1) * np.linalg.norm(bv, axis=1)
    return 1.0 - num / den


register("cosine_distance", _rt_const(_F64), _mk_dist(_cosine))
register("dot", _rt_const(_F64), _mk_dist(lambda a, b: (a * b).sum(axis=1)))
register("euclidean_distance", _rt_const(_F64),
         _mk_dist(lambda a, b: np.linalg.norm(a - b, axis=1)))


def _embedding_norm(args, kwargs):
    s = args[0]
    av = _vec_2d(s)
    return _float_out(s.name, np.linalg.norm(av, axis=1), s.validity_numpy())


register("embedding_norm", _rt_const(_F64), _embedding_norm)


# ---- minhash (registry.py:940-958) -------------------------------------------------------


def _minhash(args, kwargs):
    from ..core.kernels.minhash import minhash_series

    return minhash_series(args[0], num_hashes=kwargs.get("num_hashes", 16),
                          ngram_size=kwargs.get("ngram_size", 1), seed=kwargs.get("seed", 1))


register("minhash",
         lambda f, k: DataType.fixed_size_list(DataType.uint64(), k.get("num_hashes", 16)),
         _minhash)


# ---- tokenize (registry.py:960-1017) -----------------------------------------------------


def _tokenize_encode(args, kwargs):
    from ..core.series import _lengths_to_offsets
    from .tokenizer_file import load_tokenizer

    tok = load_tokenizer(kwargs.get("tokenizer", "bytes"))
    s = args[0]
    valid = s.validity_numpy()
    texts = s.to_numpy().tolist()
    if tok is None:
        enc = [t.encode("utf-8") if ok else b"" for t, ok in zip(texts, valid.tolist())]
        lens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
        ids = np.frombuffer(b"".join(enc), dtype=np.uint8).astype(np.uint32)
    else:
        rows = [tok.encode_ids(t) if ok else np.zeros(0, np.int32)
                for t, ok in zip(texts, valid.tolist())]
        lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
        ids = (np.concatenate(rows) if rows else np.zeros(0, np.int32)).astype(np.uint32)
    child = Series("item", _U32, ids, np.ones(len(ids), dtype=bool))
    return Series.nested(s.name, DataType.list(_U32), _lengths_to_offsets(lens), [child],
                         valid.copy())


def _tokenize_decode(args, kwargs):
    from .tokenizer_file import load_tokenizer

    tok = load_tokenizer(kwargs.get("tokenizer", "bytes"))
    rows = args[0].to_pylist()
    if tok is None:
        out = [None if ids is None else bytes(ids).decode("utf-8", "replace") for ids in rows]
    else:
        out = [None if ids is None else tok.decode(ids) for ids in rows]
    return Series.from_pylist(out, args[0].name, DataType.string())


register("tokenize_encode", _rt_const(DataType.list(_U32)), _tokenize_encode)
register("tokenize_decode", _rt_const(DataType.string()), _tokenize_decode)


# ---- image (registry.py:1036-1060, breadth.py:318-374, 636-654) -------------------------


def _image_kernels():
    from ..core.kernels import image

    return image


register("image_decode", _rt_const(DataType.image()),
         lambda a, k: _image_kernels().decode(a[0], k.get("mode"), k.get("on_error", "raise")))
register("image_encode", _rt_const(DataType.binary()),
         lambda a, k: _image_kernels().encode(a[0], k.get("image_format", "PNG")))
register("image_resize", _rt_const(DataType.image()),
         lambda a, k: _image_kernels().resize(a[0], k["w"], k["h"]))
register("image_crop", _rt_const(DataType.image()),
         lambda a, k: _image_kernels().crop(a[0], k["bbox"]))
register("image_to_mode", _rt_const(DataType.image()),
         lambda a, k: _image_kernels().to_mode(a[0], k["mode"]))
register("image_to_fixed_shape",
         lambda f, k: DataType.fixed_shape_image(k["mode"], k["h"], k["w"]),
         lambda a, k: _image_kernels().to_fixed_shape(a[0], k["mode"], k["h"], k["w"]))


def _image_field(field: str):
    """An image column's height, width or channels as uint32 (null where
    the image or its data is, as ``unpack_images`` skips such rows)."""
    def host(args, kwargs):
        s = args[0]
        image = _image_kernels()
        kids = image.image_children(s)
        child = kids[image.IMAGE_FIELDS.index(field)]
        valid = s.validity_numpy() & kids[0].validity_numpy() & child.validity_numpy()
        return Series(s.name, _U32, np.where(valid, child.to_numpy(), 0).astype(np.uint32),
                      valid.copy())
    return host


register("image_height", _rt_const(_U32), _image_field("height"))
register("image_width", _rt_const(_U32), _image_field("width"))
register("image_channel", _rt_const(_U32), _image_field("channels"))


def _image_hash_host(args, kwargs):
    """Average hash (8 x 8 samples of the channel mean) as 16 hex digits."""
    out = []
    for im, _mode in _image_kernels().unpack_images(args[0]):
        if im is None:
            out.append(None)
            continue
        a = im.astype(np.float64)
        if a.ndim == 3:
            a = a.mean(axis=2)
        h, w = a.shape
        small = a[np.arange(8) * h // 8][:, np.arange(8) * w // 8]
        bits = (small > small.mean()).flatten()
        val = 0
        for b in bits:
            val = (val << 1) | int(b)
        out.append(f"{val:016x}")
    return Series.from_pylist(out, args[0].name, DataType.string())


register("image_hash", _rt_const(DataType.string()), _image_hash_host)


def _image_mode_host(args, kwargs):
    out = [None if im is None else mode for im, mode in _image_kernels().unpack_images(args[0])]
    return Series.from_pylist(out, args[0].name, DataType.string())


register("image_mode", _rt_const(DataType.string()), _image_mode_host)


# ---- url (registry.py:1063-1106) ---------------------------------------------------------


def _url_download(args, kwargs):
    """Each URL's bytes: a local path or a ``file://`` URL; a remote URL
    raises ``NotImplementedError`` (the object store is not ported). A
    failed read raises, or gives null under ``on_error="null"``."""
    from ..core.kernels.image import _map
    from ..filetype import local_path

    s = args[0]
    on_error = kwargs.get("on_error", "raise")
    paths = [None if v is None else local_path(v) for v in s.to_pylist()]

    def read(path):
        with open(path, "rb") as f:
            return f.read()
    # the files read on the image pool (a read drops the GIL), in row order
    out = _map(lambda p: None if p is None else read(p), paths)
    for i, r in enumerate(out):
        if isinstance(r, Exception):
            if on_error == "raise":
                raise r
            out[i] = None
    return _binary(s.name, out)


register("url_download", _rt_const(DataType.binary()), _url_download)


def _url_upload(args, kwargs):
    """Each value written to a new file named by a random UUID under
    ``location``; the column of their paths."""
    from ..filetype import local_path

    s = args[0]
    location = local_path(kwargs["location"])
    os.makedirs(location, exist_ok=True)
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        path = os.path.join(location, _uuid.uuid4().hex)
        with open(path, "wb") as f:
            f.write(v)
        out.append(path)
    return Series.from_pylist(out, s.name, DataType.string())


register("url_upload", _rt_const(DataType.string()), _url_upload)


# ---- the lazy file (breadth.py:658-721) --------------------------------------------------


def _file_host(args, kwargs):
    s = args[0]
    out = [None if v is None else {"path": v, "data": None} for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, DataType.file())


register("file", _rt_const(DataType.file()), _file_host)


def _file_path_host(args, kwargs):
    return args[0].struct_field("path").rename(args[0].name)


register("file_path", _rt_const(DataType.string()), _file_path_host)


def _file_size_host(args, kwargs):
    from ..filetype import File

    io_config = kwargs.get("io_config")
    out = []
    for v in args[0].to_pylist():
        if v is None:
            out.append(None)
        elif v.get("data") is not None:
            out.append(len(v["data"]))
        else:
            out.append(File(v["path"], io_config).size())
    return Series.from_pylist(out, args[0].name, dtype=DataType.int64())


register("file_size", _rt_const(DataType.int64()), _file_size_host)


def _file_read_host(args, kwargs):
    from ..filetype import File

    io_config = kwargs.get("io_config")
    offset = kwargs.get("offset", 0)
    length = kwargs.get("length")
    out: List = []
    for v in args[0].to_pylist():
        if v is None:
            out.append(None)
            continue
        if v.get("data") is not None:
            data = v["data"]
            out.append(data[offset:offset + length] if length is not None else data[offset:])
            continue
        with File(v["path"], io_config).open() as f:
            if offset:
                f.seek(offset)
            out.append(f.read(length if length is not None else -1))
    return _binary(args[0].name, out)


register("file_read", _rt_const(DataType.binary()), _file_read_host)
