"""Series: a named, typed column (counterpart of daft_tpu/core/series.py).

Host storage is numpy, not Arrow: a values array plus a bool validity mask.
Strings are object arrays, dates int32 days since 1970-01-01; a null slot
holds 0 (NaN for floats, None for strings), as the reference's
``Series.to_numpy()`` fills it. A list column (an embedding) is an object
array of Python lists whose numeric elements are rounded to the element
type, as Arrow stores them; a ``python`` column holds any objects. Both are
host only: built, sliced, taken, concatenated and read back, nothing more. Device storage is a (values, validity) pair
of torch tensors made by ``to_device`` / ``to_device_cached``.
"""

from __future__ import annotations

import datetime
import weakref
from typing import Any, List, Optional, Sequence

import numpy as np

from ..datatype import DataType, Field

_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_ORDINAL = _EPOCH.toordinal()

# content_fingerprint hashes a column in pieces of _FP_PIECE_ROWS rows, so a
# concatenation of whole pieces (morsels of a power-of-two size) takes its
# parts' digests; the pieces hash on a thread pool (hashlib drops the GIL
# in update)
_FP_PIECE_ROWS = 1 << 14
_FP_POOL = None


def _sha256(*buffers) -> bytes:
    import hashlib

    h = hashlib.sha256()
    for b in buffers:
        h.update(b)
    return h.digest()


def _fp_pool():
    global _FP_POOL
    if _FP_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _FP_POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                      thread_name_prefix="fingerprint")
    return _FP_POOL


def _infer_dtype(data: Sequence[Any]) -> DataType:
    kinds = set()
    for v in data:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            kinds.add("bool")
        elif isinstance(v, (int, np.integer)):
            kinds.add("int")
        elif isinstance(v, (float, np.floating)):
            kinds.add("float")
        elif isinstance(v, str):
            kinds.add("string")
        elif isinstance(v, datetime.datetime):
            raise TypeError("timestamps are not supported by the port yet")
        elif isinstance(v, datetime.date):
            kinds.add("date")
        else:
            raise TypeError(f"unsupported value {v!r} of type {type(v).__name__}")
    if not kinds:
        return DataType.null()
    if kinds == {"int", "float"}:
        return DataType.float64()
    if len(kinds) > 1:
        raise TypeError(f"mixed value kinds in one column: {sorted(kinds)}")
    kind = kinds.pop()
    return {"bool": DataType.bool(), "int": DataType.int64(),
            "float": DataType.float64(), "string": DataType.string(),
            "date": DataType.date()}[kind]


def _null_fill(dtype: DataType):
    if dtype.is_floating():
        return np.nan
    if dtype.to_numpy() == object:
        return None
    return 0


def _object_array(items: list) -> np.ndarray:
    """A 1-d object array of ``items`` (element by element: numpy would
    broadcast a list of equal-length lists into two dimensions)."""
    out = np.empty(len(items), dtype=object)
    for i, v in enumerate(items):
        out[i] = v
    return out


def _first_occurrence_codes(codes: np.ndarray, k: int):
    """Codes in [0, k) renumbered in order of first occurrence: (the new
    int32 codes, the old code of each new one)."""
    n = len(codes)
    if n == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int64)
    if k <= 64:
        present = np.flatnonzero(np.bincount(codes, minlength=k))
        firsts = np.array([np.argmax(codes == c) for c in present], dtype=np.int64)
    else:
        present, firsts = np.unique(codes, return_index=True)
    order = present[np.argsort(firsts, kind="stable")]
    remap = np.zeros(k, dtype=np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    return remap[codes], order


def _concat_codes(raws):
    """The raw codes of Series concatenated, from each one's (codes,
    values): one value list, each part's codes mapped into it."""
    index: dict = {}
    out = []
    for codes, values in raws:
        lut = np.array([index.setdefault(v, len(index)) for v in values], dtype=np.int32)
        out.append(lut[codes] if len(codes) else np.zeros(0, dtype=np.int32))
    return "raw", np.concatenate(out), list(index)


class Series:
    __slots__ = ("_name", "_dtype", "_values", "_validity", "_dict_codes",
                 "_distinct_est", "_content_fp", "_fp_pieces", "held", "__weakref__")

    def __init__(self, name: str, dtype: DataType, values: np.ndarray,
                 validity: np.ndarray):
        if len(values) != len(validity):
            raise ValueError(f"values ({len(values)}) and validity "
                             f"({len(validity)}) lengths differ")
        self._name = name
        self._dtype = dtype
        self._values = values
        self._validity = validity
        self._dict_codes = None
        self._distinct_est = None  # plan/stats.py estimate_distinct's cache
        self._content_fp = None    # content_fingerprint's cache
        # its pieces' digests (a list), or weak references to the parts of a
        # concatenation whose digests it takes (a tuple)
        self._fp_pieces = None
        # a column of a table the caller holds (from_pydict, a collected
        # DataFrame): its device planes stay keyed by this Series alone, and
        # are never fingerprinted (device/residency.py stable_slot_key)
        self.held = False

    # ---- constructors -------------------------------------------------------------
    @classmethod
    def from_pylist(cls, data: Sequence[Any], name: str = "series",
                    dtype: Optional[DataType] = None) -> "Series":
        data = list(data)
        dtype = dtype or _infer_dtype(data)
        validity = np.array([v is not None for v in data], dtype=bool)
        fill = _null_fill(dtype)
        if dtype.is_temporal():
            conv = [fill if v is None else
                    (v.toordinal() - _EPOCH_ORDINAL if isinstance(v, datetime.date) else int(v))
                    for v in data]
        elif dtype.is_list():
            inner = dtype.inner
            if inner.is_numeric() or inner.is_boolean():
                np_inner = inner.to_numpy()
                conv = [None if v is None else np.asarray(v, dtype=np_inner).tolist()
                        for v in data]
            else:
                conv = [None if v is None else list(v) for v in data]
            return cls(name, dtype, _object_array(conv), validity)
        elif dtype.kind == "python":
            return cls(name, dtype, _object_array(data), validity)
        else:
            conv = [fill if v is None else v for v in data]
        if dtype.is_string() or dtype.is_null():
            values = np.empty(len(conv), dtype=object)
            values[:] = conv
        else:
            values = np.asarray(conv, dtype=dtype.to_numpy()) if conv \
                else np.empty(0, dtype=dtype.to_numpy())
        return cls(name, dtype, values, validity)

    @classmethod
    def from_numpy(cls, arr, name: str = "series", dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None) -> "Series":
        """Wrap a numpy array (numeric, bool, datetime64[D] or object/str).
        ``validity`` marks nulls; null slots are refilled like ``to_numpy``."""
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise ValueError(f"expected a 1-d array, got shape {arr.shape}")
        if arr.dtype.kind in ("O", "U"):
            data = arr.tolist()
            if validity is not None:
                data = [v if ok else None for v, ok in zip(data, validity)]
            return cls.from_pylist(data, name, dtype)
        if arr.dtype.kind == "M":
            nat = np.isnat(arr)
            arr = arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
            validity = ~nat if validity is None else (np.asarray(validity, bool) & ~nat)
            dtype = dtype or DataType.date()
        dtype = dtype or DataType.from_numpy(arr.dtype)
        values = arr if arr.dtype == dtype.to_numpy() else arr.astype(dtype.to_numpy())
        if validity is None:
            validity = np.ones(len(values), dtype=bool)
        else:
            validity = np.asarray(validity, dtype=bool)
            if not validity.all():
                values = np.where(validity, values, values.dtype.type(_null_fill(dtype)))
        return cls(name, dtype, values, validity)

    @classmethod
    def empty(cls, name: str, dtype: DataType) -> "Series":
        return cls.from_pylist([], name, dtype)

    @classmethod
    def full_null(cls, name: str, dtype: DataType, length: int) -> "Series":
        return cls.from_pylist([None] * length, name, dtype)

    # ---- accessors ----------------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def dtype(self) -> DataType:
        return self._dtype

    def field(self) -> Field:
        return Field(self._name, self._dtype)

    def __len__(self) -> int:
        return len(self._values)

    def __repr__(self) -> str:
        vals = self.to_pylist()
        preview = ", ".join(repr(v) for v in vals[:8])
        if len(vals) > 8:
            preview += ", …"
        return f"Series[{self._name}: {self._dtype}; {len(self)}]([{preview}])"

    def rename(self, name: str) -> "Series":
        out = Series(name, self._dtype, self._values, self._validity)
        out._dict_codes = self._dict_codes
        out._content_fp = self._content_fp  # the name is not part of the content
        out._fp_pieces = self._fp_pieces
        return out

    # ---- conversion ---------------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Dense values; null slots hold 0 / NaN / None (see validity_numpy)."""
        return self._values

    def validity_numpy(self) -> np.ndarray:
        return self._validity

    def to_pylist(self) -> list:
        valid = self._validity
        if self._dtype.is_temporal():
            return [datetime.date.fromordinal(_EPOCH_ORDINAL + d) if ok else None
                    for d, ok in zip(self._values.tolist(), valid.tolist())]
        return [v if ok else None
                for v, ok in zip(self._values.tolist(), valid.tolist())]

    def to_device(self, pad_to: Optional[int] = None, f32: bool = False,
                  device=None):
        """(values, validity) as torch tensors on ``device``, padded to
        ``pad_to`` rows; padding rows are invalid. ``f32=True`` downcasts a
        float64 column to float32 (the device stages' compute dtype)."""
        import torch

        values = self._values
        target = self._dtype.to_torch()
        if f32 and target == torch.float64:
            target = torch.float32
        np_target = torch.empty(0, dtype=target).numpy().dtype
        if values.dtype != np_target:
            values = values.astype(np_target)
        validity = self._validity
        if pad_to is not None and pad_to > len(self):
            pad = pad_to - len(self)
            values = np.concatenate([values, np.zeros(pad, dtype=values.dtype)])
            validity = np.concatenate([validity, np.zeros(pad, dtype=bool)])
        return (torch.from_numpy(np.ascontiguousarray(values)).to(device),
                torch.from_numpy(np.ascontiguousarray(validity)).to(device))

    def to_device_cached(self, pad_to: Optional[int] = None, f32: bool = False,
                         device=None):
        """``to_device`` through the process-wide residency manager: repeated
        queries over a table keep its planes on the device."""
        from ..device.residency import manager

        return manager().get_or_build(
            self, ("col", pad_to, bool(f32), str(device)),
            lambda: self.to_device(pad_to, f32=f32, device=device))

    def content_fingerprint(self) -> int:
        """64-bit hash of this column's content: dtype, length, values and
        validity (not the name), so two Series of equal content, such as
        two reads of one file, have one fingerprint. Null slots hold the
        fill values (0 / NaN / None), so the values hash deterministically.
        SHA-256 of the dtype, the length and the digests of the pieces of
        ``_FP_PIECE_ROWS`` rows (``_piece_digests``). Cached on the Series;
        the time spent counts in ``fingerprint_ms``."""
        if self._content_fp is not None:
            return self._content_fp
        if self._dtype.is_list() or self._dtype.kind == "python":
            raise TypeError(f"a {self._dtype} column has no content fingerprint")
        import time

        from ..ops import counters

        t0 = time.perf_counter()
        digest = _sha256(repr(self._dtype).encode(), b"\0", len(self).to_bytes(8, "little"),
                         *self._piece_digests())
        self._content_fp = int.from_bytes(digest[:8], "little")
        counters.bump("fingerprint_ms", (time.perf_counter() - t0) * 1e3)
        return self._content_fp

    def _piece_digests(self) -> List[bytes]:
        """SHA-256 of each piece of ``_FP_PIECE_ROWS`` rows: its values'
        bytes and validity, or for strings the valid rows' UTF-8 byte
        lengths (uint32) and bytes (gathered from the dictionary where the
        Series carries dictionary codes: the same bytes either way), then
        its validity. A concatenation whose parts are still alive takes
        their digests, computing and caching the parts' own. Cached."""
        pieces = self._fp_pieces
        if isinstance(pieces, list):
            return pieces
        parts = [ref() for ref in pieces] if pieces is not None else [None]
        if all(p is not None for p in parts):
            out = [d for p in parts for d in p._piece_digests()]
        else:
            n = len(self)
            bounds = [(a, min(a + _FP_PIECE_ROWS, n)) for a in range(0, n, _FP_PIECE_ROWS)]
            valid = np.ascontiguousarray(self._validity).view(np.uint8)
            if self._dtype.is_string():
                piece = self._string_piece()

                def digest(ab):
                    a, b = ab
                    return _sha256(*piece(a, b), valid[a:b])
            else:
                width = 0 if self._dtype.is_null() else self._values.dtype.itemsize
                values = np.ascontiguousarray(self._values).view(np.uint8) if width \
                    else np.zeros(0, dtype=np.uint8)

                def digest(ab):
                    a, b = ab
                    return _sha256(values[a * width:b * width], valid[a:b])
            out = list(_fp_pool().map(digest, bounds)) if len(bounds) > 1 \
                else [digest(ab) for ab in bounds]
        self._fp_pieces = out
        return out

    def _string_piece(self):
        """piece(start, end): (the valid rows' UTF-8 byte lengths as uint32
        bytes, their UTF-8 bytes) of rows [start, end)."""
        raw = self._raw_codes()
        if raw is not None:
            codes, values = raw
            enc = [("" if v is None else v).encode("utf-8", "surrogatepass") for v in values]
            dict_lens = np.fromiter(map(len, enc), dtype=np.uint32, count=len(enc))
            width = max(int(dict_lens.max()) if len(enc) else 0, 1)
            table = np.zeros((max(len(enc), 1), width), dtype=np.uint8)
            for i, e in enumerate(enc):
                table[i, :len(e)] = np.frombuffer(e, dtype=np.uint8)
            cols = np.arange(width)
            all_valid = bool(self._validity.all())
            same_width = bool(len(enc)) and int(dict_lens.min()) == width

            def piece(start, end):
                c = codes[start:end] if all_valid else codes[start:end][self._validity[start:end]]
                if same_width:
                    lens = np.full(len(c), width, dtype=np.uint32)
                    data = np.take(table, c, axis=0)
                else:
                    lens = np.take(dict_lens, c)
                    data = np.take(table, c, axis=0)[cols < lens[:, None]]
                return lens.tobytes(), data.reshape(-1)
            return piece

        def piece(start, end):
            items = self._values[start:end][self._validity[start:end]].tolist()
            joined = "".join(items)
            data = joined.encode("utf-8", "surrogatepass")
            if len(data) == len(joined):
                lens = np.fromiter(map(len, items), dtype=np.uint32, count=len(items))
            else:
                lens = np.fromiter((len(x.encode("utf-8", "surrogatepass")) for x in items),
                                   dtype=np.uint32, count=len(items))
            return lens.tobytes(), data
        return piece

    def dict_codes(self):
        """Dictionary-encode this column: (codes int32 ndarray, values list, K).

        codes[i] in [0, K) indexes row i's value in ``values`` (first-occurrence
        order); null gets its own code. Cached on the Series, which is
        immutable, so repeated grouped queries factorize each key once. A
        Series sliced, taken or concatenated from Series whose codes are
        known (a Parquet string chunk read from dictionary pages) carries
        them raw, (codes, values) with the values in any order, and only
        renumbers them here, without factorizing its values again."""
        if self._dict_codes is not None and isinstance(self._dict_codes[0], str):
            raw, values = self._raw_codes()
            codes, order = _first_occurrence_codes(raw, len(values))
            self._dict_codes = (codes, [values[i] for i in order.tolist()], len(order))
        if self._dict_codes is not None:
            return self._dict_codes
        from .kernels.groupby import make_groups

        first_idx, group_ids, _ = make_groups([self])
        values = self.take(first_idx).to_pylist()
        self._dict_codes = (group_ids.astype(np.int32), values, len(values))
        return self._dict_codes

    def _raw_codes(self):
        """(codes, values) of this Series' known dictionary codes, or None;
        the codes of a ``take`` are gathered here, on first need."""
        dc = self._dict_codes
        if dc is None:
            return None
        if not isinstance(dc[0], str):
            return dc[0], dc[1]
        if len(dc) == 4:  # ("raw", the source's codes, values, the rows taken)
            dc = self._dict_codes = ("raw", dc[1][dc[3]], dc[2])
        return dc[1], dc[2]

    def hash(self, seed: Optional["Series"] = None) -> "Series":
        """Deterministic 64-bit hash per row, as a uint64 Series (nulls hash
        to a fixed value); bit-identical to the reference's (see
        core/kernels/hashing.py)."""
        from .kernels.hashing import hash_series

        return hash_series(self, seed)

    # ---- selection ----------------------------------------------------------------
    def slice(self, start: int, end: int) -> "Series":
        out = Series(self._name, self._dtype, self._values[start:end],
                     self._validity[start:end])
        raw = self._raw_codes()
        if raw is not None:
            out._dict_codes = ("raw", raw[0][start:end], raw[1])
        return out

    def head(self, n: int) -> "Series":
        return self.slice(0, min(n, len(self)))

    def take(self, indices) -> "Series":
        idx = np.asarray(indices, dtype=np.int64)
        out = Series(self._name, self._dtype, self._values[idx], self._validity[idx])
        raw = self._raw_codes()
        if raw is not None:
            out._dict_codes = ("raw", raw[0], raw[1], idx)
        return out

    def take_or_null(self, indices) -> "Series":
        """``take`` where an index of -1 gives a null row (the right
        columns of a left join's unmatched rows)."""
        idx = np.asarray(indices, dtype=np.int64)
        miss = idx < 0
        if not miss.any():
            return self.take(idx)
        if len(self) == 0:
            return Series.full_null(self._name, self._dtype, len(idx))
        safe = np.where(miss, 0, idx)
        values = self._values[safe]  # a fresh copy: fancy indexing
        values[miss] = _null_fill(self._dtype)
        return Series(self._name, self._dtype, values, self._validity[safe] & ~miss)

    def broadcast(self, n: int) -> "Series":
        """A length-1 Series repeated to ``n`` rows."""
        return Series(self._name, self._dtype, np.repeat(self._values, n),
                      np.repeat(self._validity, n))

    @classmethod
    def concat(cls, series_list: List["Series"]) -> "Series":
        if not series_list:
            raise ValueError("need at least one series to concat")
        first = series_list[0]
        if any(s._dtype != first._dtype for s in series_list):
            raise ValueError("cannot concat series of differing dtypes: "
                             f"{sorted({s._dtype.kind for s in series_list})}")
        out = cls(first._name, first._dtype,
                  np.concatenate([s._values for s in series_list]),
                  np.concatenate([s._validity for s in series_list]))
        raws = [s._raw_codes() for s in series_list]
        if all(r is not None for r in raws):
            out._dict_codes = _concat_codes(raws)
        if all(len(s) % _FP_PIECE_ROWS == 0 for s in series_list[:-1]):
            # whole pieces: its fingerprint pieces are its parts'
            out._fp_pieces = tuple(weakref.ref(s) for s in series_list)
        return out

    def cast(self, dtype: DataType) -> "Series":
        if dtype == self._dtype:
            return self
        if self._dtype.is_null():
            return Series.full_null(self._name, dtype, len(self))
        if dtype.to_numpy() == object or self._dtype.to_numpy() == object:
            raise ValueError(f"cast {self._dtype} -> {dtype} is not supported by the port")
        values = self._values.astype(dtype.to_numpy())
        if not self._validity.all():
            values = np.where(self._validity, values, values.dtype.type(_null_fill(dtype)))
        return Series(self._name, dtype, values, self._validity)
