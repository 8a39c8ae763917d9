"""Series: a named, typed column (counterpart of daft_tpu/core/series.py).

Host storage is numpy, not Arrow: a values array plus a bool validity mask.
Strings and binary are object arrays (of ``str`` and ``bytes``), dates int32
days since 1970-01-01, timestamps, durations and times int64 ticks of their
unit (core/temporal.py); a null slot holds 0 (NaN for floats, None for
strings and bytes), as the reference's ``Series.to_numpy()`` fills it.

A nested column holds Arrow's layout in numpy (``NestedLayout``): a list
int64 offsets (n + 1, from 0) and one child Series of its elements, a null
or empty row zero elements long; a fixed-size list a child of n x size
rows; a struct one child Series per field; a map a list of a struct of
``key`` and ``value``. Element values are stored in the element type, so
numbers are rounded to it as Arrow stores them. Slicing, taking and
concatenating move offsets and children, never Python lists; the
object-array-of-lists input (an encoder's output, ``from_numpy``) stays a
constructor. A ``python`` column holds any objects. A multimodal logical
column (an embedding, an image, a tensor, a file) holds the layout of its
storage type (``DataType.storage``). Nested, binary and ``python`` columns
are host only, but for the fixed-shape kinds (a fixed-size list, an
embedding, a fixed-shape tensor or image), whose ``to_numpy`` is the dense
(rows, *shape) array and whose device planes are too. Device storage is a
(values, validity) pair of torch tensors made by ``to_device`` /
``to_device_cached``.
"""

from __future__ import annotations

import datetime
import decimal as _pydecimal
import re
import weakref
from typing import Any, List, Optional, Sequence

import numpy as np

from ..datatype import DataType, Field
from . import temporal

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


def _arrow_zone_name(info) -> str:
    """The zone name pyarrow gives a column of datetimes with this tzinfo:
    a ZoneInfo's key, "UTC", or a fixed offset as "+hh:mm"."""
    key = getattr(info, "key", None)
    if key:
        return key
    if info is datetime.timezone.utc:
        return "UTC"
    off = info.utcoffset(None)
    if off is None:
        raise TypeError(f"cannot name the time zone {info!r}")
    secs = int(off.total_seconds())
    sign = "-" if secs < 0 else "+"
    h, m = divmod(abs(secs) // 60, 60)
    return f"{sign}{h:02d}:{m:02d}"


class NestedLayout:
    """The storage of a nested column (the ``values`` of its Series):
    ``offsets`` (int64, n + 1, from 0) for a list or a map, else None, and
    the child Series (one for a list, a fixed-size list or a map; one per
    field for a struct). ``len`` is the column's row count."""

    __slots__ = ("offsets", "children", "n")

    def __init__(self, offsets: Optional[np.ndarray], children: list, n: int):
        self.offsets = offsets
        self.children = list(children)
        self.n = n

    def __len__(self) -> int:
        return self.n


def _infer_dtype(data: Sequence[Any]) -> DataType:
    kinds = set()
    tz = None
    elems: list = []      # every list value's elements
    fields: dict = {}     # every dict value's values, by key in first-seen order
    for v in data:
        if v is None:
            continue
        if isinstance(v, (list, tuple, np.ndarray)):
            kinds.add("list")
            elems.extend(v)
            continue
        if isinstance(v, dict):
            kinds.add("struct")
            for k, x in v.items():
                fields.setdefault(k, []).append(x)
            continue
        if isinstance(v, (bytes, bytearray)):
            kinds.add("binary")
            continue
        if isinstance(v, _pydecimal.Decimal):
            kinds.add("decimal")
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
            if v.tzinfo is not None and tz is None:
                tz = _arrow_zone_name(v.tzinfo)
            kinds.add("timestamp")
        elif isinstance(v, datetime.date):
            kinds.add("date")
        elif isinstance(v, datetime.timedelta):
            kinds.add("duration")
        elif isinstance(v, datetime.time):
            kinds.add("time")
        else:
            raise TypeError(f"unsupported value {v!r} of type {type(v).__name__}")
    if not kinds:
        return DataType.null()
    if kinds == {"int", "float"}:
        return DataType.float64()
    if len(kinds) > 1:
        raise TypeError(f"mixed value kinds in one column: {sorted(kinds)}")
    kind = kinds.pop()
    if kind == "decimal":
        from .decimal import infer_type

        return infer_type([v for v in data if v is not None])
    if kind == "list":
        return DataType.list(_infer_dtype(elems))
    if kind == "struct":
        return DataType.struct({k: _infer_dtype(xs) for k, xs in fields.items()})
    return {"bool": DataType.bool(), "int": DataType.int64(), "binary": DataType.binary(),
            "float": DataType.float64(), "string": DataType.string(),
            "date": DataType.date(), "timestamp": DataType.timestamp("us", tz),
            "duration": DataType.duration("us"), "time": DataType.time("us")}[kind]


def _temporal_ticks(v, dtype: DataType) -> int:
    """A Python value as the storage int of a temporal column (Arrow's
    conversion: ints are storage already)."""
    if isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)):
        return int(v)
    kind = dtype.kind
    if kind == "date":
        if isinstance(v, datetime.datetime):
            v = v.date()
        return v.toordinal() - _EPOCH_ORDINAL
    if kind == "timestamp":
        if isinstance(v, np.datetime64):
            return int(v.astype(f"datetime64[{dtype.time_unit}]").astype(np.int64))
        return temporal.datetime_ticks(v, dtype.time_unit, dtype.timezone)
    if kind == "duration":
        if isinstance(v, np.timedelta64):
            return int(v.astype(f"timedelta64[{dtype.time_unit}]").astype(np.int64))
        return temporal.timedelta_ticks(v, dtype.time_unit)
    return temporal.time_ticks(v, dtype.time_unit)


def _null_fill(dtype: DataType):
    if dtype.is_floating():
        return np.nan
    if dtype.is_decimal():
        return 0
    if dtype.kind == "python" or dtype.to_numpy() == object:
        return None
    return 0


def _map_pairs(v) -> list:
    """A map row (a dict, or (key, value) pairs) as a list of pairs."""
    return list(v.items()) if isinstance(v, dict) else [tuple(p) for p in v]


def _lengths_to_offsets(lens: np.ndarray) -> np.ndarray:
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return off


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [starts[i], starts[i] + lens[i])."""
    lens = lens.astype(np.int64, copy=False)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    off = _lengths_to_offsets(lens)
    return np.arange(total, dtype=np.int64) + np.repeat(starts.astype(np.int64) - off[:-1],
                                                        lens)


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


def _utf8_len(v) -> int:
    """The UTF-8 bytes of a string (0 for None)."""
    if v is None:
        return 0
    return len(v) if v.isascii() else len(v.encode("utf-8", "surrogatepass"))


def _concat_codes(raws):
    """The raw codes of Series concatenated, from each one's (codes,
    values): one value list, each part's codes mapped into it. Parts that
    share one value list (taken from one Series) keep it and their codes as
    they are: mapping a high-cardinality list value by value per part
    would cost more than the codes save."""
    values = raws[0][1]
    if all(v is values for _c, v in raws):
        return "raw", np.concatenate([c for c, _v in raws]), values
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

    _STATE = ("_name", "_dtype", "_values", "_validity", "_dict_codes", "_distinct_est",
              "_content_fp", "_fp_pieces")

    def __getstate__(self):
        """A pickled copy (a distributed sub-plan's columns) keeps its content
        fingerprint and its pieces' digests, but not the weak references to
        the parts of a concatenation, and is not a held column: its device
        planes are keyed by content in the process that reads it."""
        state = {k: getattr(self, k) for k in self._STATE}
        if isinstance(state["_fp_pieces"], tuple):
            state["_fp_pieces"] = None
        return state

    def __setstate__(self, state) -> None:
        for k in self._STATE:
            setattr(self, k, state[k])
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
            conv = [fill if v is None else _temporal_ticks(v, dtype) for v in data]
        elif dtype.is_nested():
            return cls._nested_from_pylist(data, name, dtype, validity)
        elif dtype.kind == "python":
            return cls(name, dtype, _object_array(data), validity)
        elif dtype.is_decimal():
            from . import decimal as _decimal

            exact = [None if v is None else _pydecimal.Decimal(v) for v in data]
            return _decimal.from_exact(name, exact, dtype)
        elif dtype.is_binary():
            conv = [None if v is None else bytes(v) for v in data]
            if dtype.kind == "fixed_size_binary" and any(
                    v is not None and len(v) != dtype.size for v in conv):
                raise ValueError(f"a value of a {dtype} column is not {dtype.size} bytes")
        else:
            conv = [fill if v is None else v for v in data]
        if dtype.is_string() or dtype.is_null() or dtype.is_binary():
            values = np.empty(len(conv), dtype=object)
            values[:] = conv
        else:
            values = np.asarray(conv, dtype=dtype.to_numpy()) if conv \
                else np.empty(0, dtype=dtype.to_numpy())
        return cls(name, dtype, values, validity)

    @classmethod
    def _nested_from_pylist(cls, data: list, name: str, dtype: DataType,
                            validity: np.ndarray) -> "Series":
        sdt = dtype.storage
        kind = sdt.kind
        n = len(data)
        if kind == "struct":
            children = []
            for fname, fdt in sdt.struct_fields:
                col = [None if v is None else (v.get(fname) if isinstance(v, dict)
                                               else getattr(v, fname, None))
                       for v in data]
                children.append(cls.from_pylist(col, fname, fdt))
            return cls.nested(name, dtype, None, children, validity)
        if kind == "fixed_size_list":
            size = sdt.size
            if any(isinstance(v, np.ndarray) for v in data) and all(
                    v is None or isinstance(v, np.ndarray) for v in data):
                # rows of numpy arrays (to_pylist of a fixed-shape kind)
                dense = np.zeros((n, size), dtype=sdt.inner.to_numpy())
                for i, v in enumerate(data):
                    if v is not None:
                        if v.size != size:
                            raise ValueError(f"a row of {v.size} values in a {dtype} column")
                        dense[i] = v.reshape(-1)
                return cls._dense_fixed(name, dtype, dense, validity)
            flat: list = []
            for v in data:
                if v is None:
                    flat.extend([None] * size)
                    continue
                if len(v) != size:
                    raise ValueError(f"a row of {len(v)} values in a {dtype} column")
                flat.extend(v)
            return cls.nested(name, dtype, None, [cls.from_pylist(flat, "item", sdt.inner)],
                              validity)
        rows = [None if v is None else (_map_pairs(v) if kind == "map" else v) for v in data]
        lens = np.fromiter((0 if v is None else len(v) for v in rows), dtype=np.int64, count=n)
        flat = [x for v in rows if v is not None for x in v]
        if kind == "map":
            key_dt, val_dt = sdt.params
            child = cls.nested("entries", sdt.map_entry, None,
                               [cls.from_pylist([p[0] for p in flat], "key", key_dt),
                                cls.from_pylist([p[1] for p in flat], "value", val_dt)],
                               np.ones(len(flat), dtype=bool))
        else:
            child = cls.from_pylist(flat, "item", sdt.inner)
        return cls.nested(name, dtype, _lengths_to_offsets(lens), [child], validity)

    @classmethod
    def _dense_fixed(cls, name: str, dtype: DataType, dense: np.ndarray,
                     validity: np.ndarray) -> "Series":
        """A fixed-shape column of ``dtype`` from its dense (rows, size)
        values in the element type (null rows hold their values as given)."""
        sdt = dtype.storage
        flat = np.ascontiguousarray(dense).reshape(-1)
        child = cls("item", sdt.inner, flat if flat.dtype == sdt.inner.to_numpy()
                    else flat.astype(sdt.inner.to_numpy()), np.ones(len(flat), dtype=bool))
        return cls.nested(name, dtype, None, [child], validity)

    @classmethod
    def from_numpy(cls, arr, name: str = "series", dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None) -> "Series":
        """Wrap a numpy array (numeric, bool, datetime64, timedelta64 or
        object/str). ``validity`` marks nulls; null slots are refilled like
        ``to_numpy``. A datetime64[D] array is a date column, one of a finer
        unit a timestamp, a timedelta64 a duration (NaT is null); ``dtype``
        converts them to its unit."""
        arr = np.asarray(arr)
        if arr.ndim >= 2 and arr.dtype != object:
            # a fixed-size-list column (the reference's from_numpy, series.py:75-82),
            # or, given a fixed-shape dtype, an (n, *shape) array of its rows
            n = len(arr)
            flat2 = arr.reshape(n, -1)
            inner = DataType.from_numpy(arr.dtype)
            valid = np.ones(n, dtype=bool) if validity is None \
                else np.asarray(validity, dtype=bool)
            if dtype is not None and dtype.is_fixed_shape():
                if flat2.shape[1] != dtype.storage.size:
                    raise ValueError(f"rows of shape {arr.shape[1:]} for a {dtype} column")
                if inner == dtype.storage.inner:
                    return cls._dense_fixed(name, dtype, flat2, valid)
            out = cls._dense_fixed(name, DataType.fixed_size_list(inner, flat2.shape[1]),
                                   flat2, valid)
            return out.cast(dtype) if dtype is not None else out
        if arr.ndim != 1:
            raise ValueError(f"expected a 1-d array, got shape {arr.shape}")
        if arr.dtype.kind == "O" and (dtype is None or dtype.is_string()) and len(arr):
            # a column of str (and None): the values as they are, without a
            # per-value Python pass to infer and convert them
            kinds = set(map(type, arr))
            if kinds <= {str, type(None)} and str in kinds:
                valid = np.ones(len(arr), dtype=bool) if type(None) not in kinds else \
                    np.fromiter((v is not None for v in arr), dtype=bool, count=len(arr))
                if validity is not None:
                    valid &= np.asarray(validity, dtype=bool)
                values = arr.copy()
                if not valid.all():
                    values[~valid] = None
                return cls(name, DataType.string(), values, valid)
        if arr.dtype.kind in ("O", "U"):
            data = arr.tolist()
            if validity is not None:
                data = [v if ok else None for v, ok in zip(data, validity)]
            return cls.from_pylist(data, name, dtype)
        if arr.dtype.kind in ("M", "m"):
            nat = np.isnat(arr)
            dtype = dtype or DataType.from_numpy(arr.dtype)
            if dtype.kind == "date":
                arr = arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
            else:
                unit = dtype.storage_unit if dtype.is_temporal() else "us"
                arr = arr.astype(f"{arr.dtype.str[1:3]}[{unit}]").astype(np.int64)
            validity = ~nat if validity is None else (np.asarray(validity, bool) & ~nat)
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
        return len(self._validity)

    @property
    def is_nested(self) -> bool:
        return isinstance(self._values, NestedLayout)

    @property
    def layout(self) -> NestedLayout:
        """The offsets and children of a nested column."""
        if not isinstance(self._values, NestedLayout):
            raise ValueError(f"a {self._dtype} column has no nested layout")
        return self._values

    @classmethod
    def nested(cls, name: str, dtype: DataType, offsets: Optional[np.ndarray], children,
               validity: np.ndarray) -> "Series":
        """A nested column from its layout (offsets for a list or a map, the
        child Series); a null row of a list must be zero elements long."""
        validity = np.asarray(validity, dtype=bool)
        if offsets is not None:
            offsets = np.asarray(offsets, dtype=np.int64)
        return cls(name, dtype, NestedLayout(offsets, children, len(validity)), validity)

    def list_lengths(self) -> np.ndarray:
        """Each row's element count (0 for a null row) of a list or a map."""
        lay = self.layout
        sdt = self._dtype.storage
        if sdt.kind == "fixed_size_list":
            return np.where(self._validity, sdt.size, 0).astype(np.int64)
        return np.diff(lay.offsets)

    def list_offsets(self) -> np.ndarray:
        """Offsets of a list, a fixed-size list or a map (n + 1, from 0)."""
        lay = self.layout
        sdt = self._dtype.storage
        if sdt.kind == "fixed_size_list":
            return np.arange(len(self) + 1, dtype=np.int64) * sdt.size
        return lay.offsets

    def list_child(self) -> "Series":
        """The element column of a list, a fixed-size list or a map."""
        return self.layout.children[0]

    def struct_field(self, name: str) -> "Series":
        """One field of a struct column, null where the struct row is."""
        for (fname, _fdt), child in zip(self._dtype.storage.struct_fields,
                                        self.layout.children):
            if fname == name:
                if self._validity.all():
                    return child.rename(name)
                return child.with_validity(child.validity_numpy() & self._validity).rename(name)
        raise ValueError(f"struct has no field {name!r}")

    def with_validity(self, valid: np.ndarray) -> "Series":
        """This column with ``valid`` as its validity (a row newly null
        keeps a null fill; a list row its elements dropped)."""
        valid = np.asarray(valid, dtype=bool)
        if self.is_nested:
            return self._nested_take(np.where(valid, np.arange(len(self)), -1))
        values = self._values
        if not valid.all():
            values = np.where(valid, values, values.dtype.type(_null_fill(self._dtype))
                              if values.dtype != object else None)
        return Series(self._name, self._dtype, values, valid)

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
        """Dense values; null slots hold 0 / NaN / None (see validity_numpy).
        A fixed-size list, an embedding, a fixed-shape tensor or image gives
        the dense (rows, *shape) array of its element type, 0 under a null
        row or element (series.py:153-185); any other nested column an
        object array of its rows as Python values (``to_pylist``)."""
        if isinstance(self._values, NestedLayout):
            if self._has_dense():
                return self._dense()
            return _object_array(self.to_pylist())
        return self._values

    def _has_dense(self) -> bool:
        """A fixed-shape column of flat elements (not a fixed-size list of
        lists)."""
        return self._dtype.is_fixed_shape() and not self._values.children[0].is_nested

    def _is_dense_plane(self) -> bool:
        """A fixed-shape column of numbers: one dense plane on the device,
        fingerprinted by its bytes."""
        return self._has_dense() and self._dtype.storage.inner.is_device_compatible()

    def _dense(self) -> np.ndarray:
        """The (rows, *shape) values of a fixed-shape column."""
        dt = self._dtype
        child = self._values.children[0]
        flat = child._values
        if flat.dtype != object:  # zero under a null element, or a null row's floats
            if not child._validity.all():
                flat = np.where(child._validity, flat, flat.dtype.type(0))
            elif dt.storage.inner.is_floating() and not self._validity.all():
                flat = np.where(np.repeat(self._validity, dt.storage.size), flat,
                                flat.dtype.type(0))
        flat = flat.astype(dt.element_numpy, copy=False)
        return flat.reshape((len(self),) + tuple(dt.dense_shape))

    def validity_numpy(self) -> np.ndarray:
        return self._validity

    def size_bytes(self) -> int:
        """The bytes Arrow's ``nbytes`` gives for this column as the
        reference holds it: the values (booleans bit-packed; a string or
        list row as an int64 offset plus its UTF-8 bytes or elements), and a
        validity bitmap where the column has a null; a null column 0, a
        ``python`` column 64 bytes a row. The host memory budget's spill
        decisions read it."""
        n = len(self._values)
        kind = self._dtype.kind
        if kind == "python":
            return 64 * n
        if kind == "null" or n == 0:
            return 0
        bitmap = (n + 7) // 8
        nulls = bitmap if not self._validity.all() else 0
        if kind == "bool":
            return bitmap + nulls
        if kind == "string":
            return 8 * n + self._utf8_bytes() + nulls
        if kind == "binary":
            return 8 * n + sum(map(len, self._values[self._validity].tolist())) + nulls
        if kind == "fixed_size_binary":
            return self._dtype.size * n + nulls
        kind = self._dtype.storage.kind
        if kind in ("list", "map"):
            return 8 * n + self.list_child().size_bytes() + nulls
        if kind in ("fixed_size_list", "struct"):
            return sum(c.size_bytes() for c in self.layout.children) + nulls
        return self._values.dtype.itemsize * n + nulls

    def _utf8_bytes(self) -> int:
        """The UTF-8 bytes of the valid rows. Where dictionary codes are
        known (a Parquet or spill read, and its slices, takes and
        concatenations) and the dictionary has no more entries than the
        column has rows, each entry is measured once and the codes gather
        its length; otherwise the values are joined and measured."""
        raw = self._raw_codes()
        if raw is not None and len(raw[1]) <= len(self._values):
            codes, values = raw
            lens = np.fromiter((_utf8_len(v) for v in values), dtype=np.int64,
                               count=len(values))
            return int(lens[codes[self._validity]].sum())
        return _utf8_len("".join(self._values[self._validity].tolist()))

    def to_pylist(self) -> list:
        valid = self._validity
        kind = self._dtype.kind
        if kind in ("embedding", "fixed_shape_tensor", "fixed_shape_image"):
            # one numpy array per row (series.py:147-150)
            dense = self._dense()
            return [dense[i] if ok else None for i, ok in enumerate(valid.tolist())]
        if isinstance(self._values, NestedLayout):
            return self._nested_pylist()
        if kind == "date":
            return [datetime.date.fromordinal(_EPOCH_ORDINAL + d) if ok else None
                    for d, ok in zip(self._values.tolist(), valid.tolist())]
        if kind == "timestamp":
            return temporal.ticks_to_datetimes(self._values, valid, self._dtype.time_unit,
                                               self._dtype.timezone)
        if kind == "duration":
            return temporal.ticks_to_timedeltas(self._values, valid, self._dtype.time_unit)
        if kind == "time":
            return temporal.ticks_to_times(self._values, valid, self._dtype.time_unit)
        if kind == "decimal128":
            from .decimal import to_pylist

            return to_pylist(self._values, valid, self._dtype.params[1])
        return [v if ok else None
                for v, ok in zip(self._values.tolist(), valid.tolist())]

    def _nested_pylist(self) -> list:
        kind = self._dtype.storage.kind
        valid = self._validity.tolist()
        lay = self._values
        if kind == "struct":
            names = [n for n, _t in self._dtype.storage.struct_fields]
            cols = [c.to_pylist() for c in lay.children]
            rows = zip(*cols) if cols else ([()] * len(valid))
            return [dict(zip(names, r)) if ok else None for r, ok in zip(rows, valid)]
        if kind == "map":
            entries = lay.children[0].layout.children
            flat = list(zip(entries[0].to_pylist(), entries[1].to_pylist()))
        else:
            flat = lay.children[0].to_pylist()
        o = self.list_offsets().tolist()
        return [flat[o[i]:o[i + 1]] if ok else None for i, ok in enumerate(valid)]

    def to_device(self, pad_to: Optional[int] = None, f32: bool = False,
                  device=None):
        """(values, validity) as torch tensors on ``device``, padded to
        ``pad_to`` rows; padding rows are invalid. ``f32=True`` downcasts a
        float64 column to float32 (the device stages' compute dtype). The
        bytes count in the registry's ``hbm_h2d_bytes``."""
        import torch

        if self.is_nested and not self._is_dense_plane():
            raise ValueError(f"a {self._dtype} column has no device plane")
        values = self._dense() if self.is_nested else self._values
        target = (self._dtype.storage.inner if self._dtype.kind == "fixed_size_list"
                  else self._dtype).to_torch()
        if f32 and target == torch.float64:
            target = torch.float32
        np_target = torch.empty(0, dtype=target).numpy().dtype
        if values.dtype != np_target:
            values = values.astype(np_target)
        validity = self._validity
        if pad_to is not None and pad_to > len(self):
            pad = pad_to - len(self)
            values = np.concatenate([values, np.zeros((pad,) + values.shape[1:],
                                                      dtype=values.dtype)])
            validity = np.concatenate([validity, np.zeros(pad, dtype=bool)])
        from ..observability.metrics import registry

        # upload attribution: a warm run over resident planes adds nothing
        registry().inc("hbm_h2d_bytes", int(values.nbytes) + int(validity.nbytes))
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

    def is_device_resident(self, pad_to: Optional[int] = None, f32: bool = False,
                           device=None) -> bool:
        """True when ``to_device_cached`` would upload nothing for this
        layout (the cost model prices resident planes at zero transfer)."""
        from ..device.residency import manager

        return manager().is_resident(self, ("col", pad_to, bool(f32), str(device)))

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
        if (self.is_nested and not self._is_dense_plane()) or self._dtype.is_binary() \
                or self._dtype.kind == "python":
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
                if self.is_nested:  # a fixed-shape kind: its dense rows' bytes
                    dense = np.ascontiguousarray(self._dense()).reshape(n, -1)
                    width = dense.shape[1] * dense.itemsize
                    values = dense.view(np.uint8).reshape(-1)
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
        if isinstance(self._values, NestedLayout):
            return self._nested_slice(*slice(start, end).indices(len(self))[:2])
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
        if isinstance(self._values, NestedLayout):
            return self._nested_take(np.where(idx < 0, idx + len(self), idx))
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
        if isinstance(self._values, NestedLayout):
            return self._nested_take(idx)
        if len(self) == 0:
            return Series.full_null(self._name, self._dtype, len(idx))
        safe = np.where(miss, 0, idx)
        values = self._values[safe]  # a fresh copy: fancy indexing
        values[miss] = _null_fill(self._dtype)
        return Series(self._name, self._dtype, values, self._validity[safe] & ~miss)

    def broadcast(self, n: int) -> "Series":
        """A length-1 Series repeated to ``n`` rows."""
        if isinstance(self._values, NestedLayout):
            return self._nested_take(np.zeros(n, dtype=np.int64))
        return Series(self._name, self._dtype, np.repeat(self._values, n),
                      np.repeat(self._validity, n))

    def _nested_take(self, idx: np.ndarray) -> "Series":
        """Rows ``idx`` of a nested column, -1 giving a null row."""
        miss = idx < 0
        safe = np.where(miss, 0, idx) if len(self) else np.zeros(len(idx), dtype=np.int64)
        valid = (self._validity[safe] & ~miss) if len(self) else np.zeros(len(idx), bool)
        sdt = self._dtype.storage
        kind = sdt.kind
        lay = self._values
        if kind == "struct":
            kids = [c._nested_take(idx) if c.is_nested else c.take_or_null(idx)
                    for c in lay.children]
            return Series.nested(self._name, self._dtype, None, kids, valid)
        if kind == "fixed_size_list" and not lay.children[0].is_nested and len(self):
            # gather whole rows of the (n, size) child: a null row's elements
            # null, holding the element type's null fill
            size = sdt.size
            child = lay.children[0]
            vals = child._values.reshape(len(self), size)[safe]
            cval = child._validity.reshape(len(self), size)[safe] & valid[:, None]
            if not valid.all():
                fill = _null_fill(sdt.inner)
                vals[~valid] = None if vals.dtype == object else vals.dtype.type(fill)
            kid = Series(child.name, child.dtype, vals.reshape(-1), cval.reshape(-1))
            return Series.nested(self._name, self._dtype, None, [kid], valid)
        if kind == "fixed_size_list":
            size = sdt.size
            rows = np.where(valid, safe, -1)
            cidx = (rows[:, None] * size + np.arange(size)).reshape(-1) if size else \
                np.zeros(0, dtype=np.int64)
            cidx = np.where(np.repeat(rows, size) < 0, -1, cidx)
            child = lay.children[0]
            kid = child.take_or_null(cidx) if len(child) else \
                Series.full_null(child.name, child.dtype, len(cidx))
            return Series.nested(self._name, self._dtype, None, [kid], valid)
        off = lay.offsets
        if len(self):
            starts = off[safe]
            lens = np.where(valid, off[safe + 1] - starts, 0)
        else:
            starts = lens = np.zeros(len(idx), dtype=np.int64)
        child = lay.children[0]
        return Series.nested(self._name, self._dtype, _lengths_to_offsets(lens),
                             [child.take(_ranges(starts, lens))], valid)

    def _nested_slice(self, start: int, end: int) -> "Series":
        end = max(start, end)
        sdt = self._dtype.storage
        kind = sdt.kind
        lay = self._values
        valid = self._validity[start:end]
        if kind == "struct":
            kids = [c.slice(start, end) for c in lay.children]
            return Series.nested(self._name, self._dtype, None, kids, valid)
        if kind == "fixed_size_list":
            size = sdt.size
            return Series.nested(self._name, self._dtype, None,
                                 [lay.children[0].slice(start * size, end * size)], valid)
        o = lay.offsets[start:end + 1]
        return Series.nested(self._name, self._dtype, o - o[0],
                             [lay.children[0].slice(int(o[0]), int(o[-1]))], valid)

    @classmethod
    def _nested_concat(cls, parts: List["Series"]) -> "Series":
        first = parts[0]
        sdt = first._dtype.storage
        kind = sdt.kind
        valid = np.concatenate([p._validity for p in parts])
        if kind == "struct":
            kids = [cls.concat([p._values.children[k] for p in parts])
                    for k in range(len(sdt.struct_fields))]
            return cls.nested(first._name, first._dtype, None, kids, valid)
        child = cls.concat([p._values.children[0] for p in parts])
        if kind == "fixed_size_list":
            return cls.nested(first._name, first._dtype, None, [child], valid)
        lens = np.concatenate([np.diff(p._values.offsets) for p in parts])
        return cls.nested(first._name, first._dtype, _lengths_to_offsets(lens), [child], valid)

    @classmethod
    def concat(cls, series_list: List["Series"]) -> "Series":
        if not series_list:
            raise ValueError("need at least one series to concat")
        first = series_list[0]
        if any(s._dtype != first._dtype for s in series_list):
            raise ValueError("cannot concat series of differing dtypes: "
                             f"{sorted({s._dtype.kind for s in series_list})}")
        if isinstance(first._values, NestedLayout):
            return cls._nested_concat(series_list)
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
        if dtype.kind == "python":
            return Series(self._name, dtype, _object_array(self.to_pylist()), self._validity)
        if self.is_nested or dtype.is_nested():
            return self._nested_cast(dtype)
        if dtype.is_decimal():
            from .decimal import cast_to_decimal

            return cast_to_decimal(self, dtype)
        if self._dtype.is_decimal():
            from .decimal import cast_from_decimal

            return cast_from_decimal(self, dtype)
        if self._dtype.is_binary() or dtype.is_binary():
            return self._binary_cast(dtype)
        if self._dtype.kind in ("timestamp", "duration", "time") \
                or dtype.kind in ("timestamp", "duration", "time") \
                or (self._dtype.kind == "date" and dtype.is_string()) \
                or (dtype.kind == "date" and self._dtype.is_string()):
            values = temporal_cast(self, dtype)
            if not self._validity.all():
                values = np.where(self._validity, values, values.dtype.type(_null_fill(dtype))
                                  if values.dtype != object else None)
            return Series(self._name, dtype, values, self._validity)
        if dtype.is_string() and (self._dtype.is_numeric() or self._dtype.is_boolean()):
            out = np.empty(len(self), dtype=object)
            out[:] = [_to_text(v) if ok else None
                      for v, ok in zip(self._values.tolist(), self._validity.tolist())]
            return Series(self._name, dtype, out, self._validity)
        if dtype.to_numpy() == object or self._dtype.to_numpy() == object:
            raise ValueError(f"cast {self._dtype} -> {dtype} is not supported by the port")
        values = self._values.astype(dtype.to_numpy())
        if not self._validity.all():
            values = np.where(self._validity, values, values.dtype.type(_null_fill(dtype)))
        return Series(self._name, dtype, values, self._validity)


    def as_storage(self) -> "Series":
        """A logical column as its storage type (the same layout); any other
        column as it is."""
        if not self._dtype.is_logical():
            return self
        return Series(self._name, self._dtype.storage, self._values, self._validity)

    def _nested_cast(self, dtype: DataType) -> "Series":
        """Arrow's casts between nested types: a list's elements to another
        element type, a list to a fixed-size list of its length and back, a
        struct field by field, a map's keys and values. A logical type casts
        as its storage type does (the reference's Arrow cast of its
        storage), then takes the logical type."""
        if self._dtype.is_logical() or dtype.is_logical():
            if not (self.is_nested and dtype.is_nested()):
                raise ValueError(f"Unsupported cast from {self._dtype} to {dtype}")
            st = self.as_storage()
            st = st if st.dtype == dtype.storage else st._nested_cast(dtype.storage)
            return Series(self._name, dtype, st._values, st._validity)
        src, kind = self._dtype, dtype.kind
        if not (self.is_nested and dtype.is_nested()):
            raise ValueError(f"Unsupported cast from {src} to {dtype}")
        lay = self._values
        if src.kind == "struct" and kind == "struct":
            if len(src.struct_fields) != len(dtype.struct_fields):
                raise ValueError(f"Unsupported cast from {src} to {dtype}")
            kids = [c.cast(t).rename(n) for c, (n, t) in zip(lay.children, dtype.struct_fields)]
            return Series.nested(self._name, dtype, None, kids, self._validity)
        if src.kind == "map" and kind == "map":
            entries = lay.children[0].cast(dtype.map_entry)
            return Series.nested(self._name, dtype, lay.offsets, [entries], self._validity)
        if src.is_list() and dtype.is_list():
            child = self.list_child()
            if kind == "fixed_size_list" and src.kind == "list":
                size = dtype.size
                if (self.list_lengths()[self._validity] != size).any():
                    raise ValueError(f"Unsupported cast from {src} to {dtype}: a list "
                                     f"is not {size} long")
                idx = (lay.offsets[:-1][:, None] + np.arange(size)).reshape(-1)
                child = child.take_or_null(np.where(np.repeat(self._validity, size), idx, -1))
                return Series.nested(self._name, dtype, None, [child.cast(dtype.inner)],
                                     self._validity)
            if kind == "fixed_size_list":
                if src.size != dtype.size:
                    raise ValueError(f"Unsupported cast from {src} to {dtype}")
                return Series.nested(self._name, dtype, None, [child.cast(dtype.inner)],
                                     self._validity)
            if src.kind == "fixed_size_list":
                keep = np.repeat(self._validity, src.size)
                child = child.take(np.flatnonzero(keep)) if not keep.all() else child
            return Series.nested(self._name, dtype, _lengths_to_offsets(self.list_lengths()),
                                 [child.cast(dtype.inner)], self._validity)
        raise ValueError(f"Unsupported cast from {src} to {dtype}")

    def _binary_cast(self, dtype: DataType) -> "Series":
        """Arrow's casts of binary: a string to its UTF-8 bytes, binary to a
        string (valid UTF-8 only), a binary to a fixed-size binary of its
        width."""
        src = self._dtype
        vals = self._values
        valid = self._validity
        out = np.empty(len(self), dtype=object)
        if src.is_string() and dtype.is_binary():
            out[:] = [v.encode("utf-8") if ok else None for v, ok in zip(vals.tolist(),
                                                                          valid.tolist())]
        elif src.is_binary() and dtype.is_string():
            try:
                out[:] = [v.decode("utf-8") if ok else None
                          for v, ok in zip(vals.tolist(), valid.tolist())]
            except UnicodeDecodeError:
                raise ValueError("Invalid UTF8 payload in a cast from binary to string")
        elif src.is_binary() and dtype.is_binary():
            out[:] = vals
        else:
            raise ValueError(f"Unsupported cast from {src} to {dtype}")
        if dtype.kind == "fixed_size_binary" and any(
                ok and len(v) != dtype.size for v, ok in zip(out.tolist(), valid.tolist())):
            raise ValueError(f"Unsupported cast from {src} to {dtype}: a value is not "
                             f"{dtype.size} bytes")
        return Series(self._name, dtype, out, valid)


    # ---- the reference's whole-column aggregations, null handling, sorting
    # and elementwise predicates: each a thin call into the engine's own host
    # kernels (core/kernels/groupby.py's aggregation over one group, the
    # expression evaluator, the sort kernel), so a Series answers as the
    # engine answers over a one-column table

    def sum(self):  # noqa: A003 - the reference's method name
        return _column_agg(self, "sum")

    def product(self):
        return _column_agg(self, "product")

    def mean(self):
        return _column_agg(self, "mean")

    def min(self):  # noqa: A003
        return _column_agg(self, "min")

    def max(self):  # noqa: A003
        return _column_agg(self, "max")

    def count(self, mode: str = "valid"):
        return _column_agg(self, "count", mode=mode)

    def count_distinct(self):
        return _column_agg(self, "count_distinct")

    def any_value(self, ignore_nulls: bool = False):
        return _column_agg(self, "any_value", ignore_nulls=ignore_nulls)

    def stddev(self, ddof: int = 0):
        return _column_agg(self, "stddev", ddof=ddof)

    def var(self, ddof: int = 0):
        return _column_agg(self, "var", ddof=ddof)

    def skew(self):
        return _column_agg(self, "skew")

    def bool_and(self):
        return _column_agg(self, "bool_and")

    def bool_or(self):
        return _column_agg(self, "bool_or")

    def agg_list(self):
        return _column_agg(self, "list")

    def agg_set(self):
        return _column_agg(self, "set")

    def agg_concat(self):
        return _column_agg(self, "concat")

    def string_agg(self, delimiter: str = ""):
        return _column_agg(self, "string_agg", delimiter=delimiter)

    def approx_count_distinct(self):
        return _column_agg(self, "approx_count_distinct")

    def approx_percentile(self, percentiles, alpha: float = 0.01):
        return _column_agg(self, "approx_percentile", percentiles=percentiles, alpha=alpha)

    def abs(self):  # noqa: A003
        from ..expressions.expressions import col

        return _column_eval(self.name, col("_0").abs(), self)

    def is_null(self) -> "Series":
        return Series(self.name, DataType.bool(), ~self.validity_numpy(),
                      np.ones(len(self), dtype=bool))

    def not_null(self) -> "Series":
        return Series(self.name, DataType.bool(), self.validity_numpy().copy(),
                      np.ones(len(self), dtype=bool))

    def null_count(self) -> int:
        return int(len(self) - int(self.validity_numpy().sum()))

    def fill_null(self, value):
        from ..expressions.expressions import col

        return _column_eval(self.name, col("_0").fill_null(col("_1")), self, value)

    def drop_nulls(self) -> "Series":
        return self.take(np.flatnonzero(self.validity_numpy()))

    def filter(self, mask) -> "Series":  # noqa: A003
        """The rows where ``mask`` (a bool Series or array) is true; a null in
        the mask drops its row."""
        if isinstance(mask, Series):
            keep = mask.to_numpy().astype(bool) & mask.validity_numpy()
        else:
            keep = np.asarray(mask, dtype=bool)
        return self.take(np.flatnonzero(keep))

    def argsort(self, descending: bool = False, nulls_first: Optional[bool] = None):
        """The row order (uint64 indices); nulls last ascending and first
        descending unless ``nulls_first`` says otherwise."""
        from .kernels.sort import multi_argsort

        if nulls_first is None:
            nulls_first = descending
        idx = np.asarray(multi_argsort([self], [descending], [nulls_first]), dtype=np.uint64)
        return Series.from_numpy(idx, self.name, dtype=DataType.uint64())

    def sort(self, descending: bool = False, nulls_first: Optional[bool] = None):
        return self.take(self.argsort(descending, nulls_first).to_numpy().astype(np.int64))

    def is_in(self, values):
        from ..expressions.expressions import IsIn, col, lit

        items = [lit(v) for v in values.to_pylist()]
        return _column_eval(self.name, IsIn(col("_0"), items), self)

    def between(self, lower, upper):
        from ..expressions.expressions import col

        return _column_eval(self.name, (col("_0") >= col("_1")) & (col("_0") <= col("_2")),
                            self, lower, upper)

    def eq_null_safe(self, other):
        from ..expressions.expressions import col

        return _column_eval(self.name, col("_0").eq_null_safe(col("_1")), self, other)

    @staticmethod
    def if_else(predicate, if_true, if_false):
        """Row-wise ``if_true`` where ``predicate`` holds, else ``if_false``
        (null where the predicate is null); named as ``if_true``."""
        from ..expressions.expressions import col

        return _column_eval(if_true.name, col("_0").if_else(col("_1"), col("_2")),
                            predicate, if_true, if_false)


def _column_batch(*series):
    """A RecordBatch of ``series`` as columns _0, _1, ... (broadcasting
    one-row operands to the longest)."""
    from ..schema import Schema
    from .recordbatch import RecordBatch

    n = max(len(s) for s in series)
    cols = [(s.broadcast(n) if len(s) == 1 and n != 1 else s).rename(f"_{i}")
            for i, s in enumerate(series)]
    return RecordBatch(Schema([c.field() for c in cols]), cols, n)


def _column_agg(s: "Series", op: str, **params) -> "Series":
    """``op`` over the whole column, one row, named as the column."""
    from ..expressions.expressions import AggExpr, col
    from .kernels.groupby import ungrouped_agg

    out = ungrouped_agg(_column_batch(s), [AggExpr(op, col("_0"), params).alias("_0")])
    return out.get_column("_0").rename(s.name)


def _column_eval(name: str, expr, *series) -> "Series":
    from ..expressions.eval import eval_expression

    return eval_expression(_column_batch(*series), expr).rename(name)


def _to_text(v) -> str:
    """A number or bool as Arrow's cast to string writes it: "true" /
    "false", an int in decimal, a float in its shortest digits, fixed from
    1e-6 below 1e10 and with an exponent ("1e+20", "1e-7") outside."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if v != v:
        return "nan"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    r = repr(v)
    mant, _, exp = r.partition("e")
    e = int(exp) if exp else 0
    digits = mant.lstrip("-").replace(".", "").lstrip("0") or "0"
    point = (mant.lstrip("-").find(".") if "." in mant else len(mant.lstrip("-"))) + e
    if mant.lstrip("-").startswith("0."):
        point = e - (len(mant.lstrip("-")[2:]) - len(mant.lstrip("-")[2:].lstrip("0")))
    digits = digits.rstrip("0") or "0"
    sign = "-" if r.startswith("-") else ""
    exp10 = point - 1  # the exponent of the leading digit
    if v != 0 and (exp10 < -6 or exp10 >= 10):
        m = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
        return f"{sign}{m}e{'+' if exp10 >= 0 else '-'}{abs(exp10)}"
    if v == 0:
        return sign + "0"
    if point <= 0:
        return f"{sign}0.{'0' * -point}{digits}"
    if point >= len(digits):
        return sign + digits + "0" * (point - len(digits))
    return f"{sign}{digits[:point]}.{digits[point:]}"


# ---- temporal casts (Arrow's cast rules) -----------------------------------------------

_ISO = re.compile(r"^(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2})(?::(\d{2})(?::(\d{2})"
                  r"(?:\.(\d{1,9}))?)?)?)?(Z|[+-]\d{2}(?::?\d{2})?)?$")


def _parse_iso(v: str, unit: str, zoned: bool):
    """An ISO-8601 string as ticks of ``unit`` (Arrow's string to timestamp
    cast): a date, optionally a time (T or space) with up to 9 fraction
    digits, and, only for a zoned target, ``Z`` or an offset."""
    m = _ISO.match(v)
    if m is None or (m.group(8) is not None) != zoned:
        what = "expected a zone offset" if zoned and m is not None else "invalid"
        raise ValueError(f"Failed to parse string: {v!r} as a scalar of type timestamp"
                         f"[{unit}]: {what}")
    y, mo, d, hh, mi, ss, frac, zone = m.groups()
    if not (1 <= int(mo) <= 12 and 1 <= int(d) <= 31):
        raise ValueError(f"Failed to parse string: {v!r} as a scalar of type timestamp[{unit}]")
    days = int(temporal.days_from_civil_np(int(y), int(mo), int(d)))
    secs = days * 86_400 + int(hh or 0) * 3600 + int(mi or 0) * 60 + int(ss or 0)
    per = temporal.PER_SECOND[unit]
    ticks = secs * per
    if frac:
        ns = int(frac.ljust(9, "0"))
        if ns % (1_000_000_000 // per):
            raise ValueError(f"Failed to parse string: {v!r} as a scalar of type "
                             f"timestamp[{unit}]")
        ticks += ns // (1_000_000_000 // per)
    if zone and zone != "Z":
        sign = -1 if zone[0] == "-" else 1
        digits = zone[1:].replace(":", "")
        off = int(digits[:2]) * 3600 + (int(digits[2:4]) * 60 if len(digits) > 2 else 0)
        ticks -= sign * off * per
    return ticks


def _frac(sub: np.ndarray, unit: str) -> list:
    width = {"s": 0, "ms": 3, "us": 6, "ns": 9}[unit]
    return [""] * len(sub) if not width else [f".{x:0{width}d}" for x in sub.tolist()]


def format_timestamps(values: np.ndarray, valid: np.ndarray, unit: str,
                      tz: Optional[str]) -> np.ndarray:
    """Arrow's timestamp to string cast: "YYYY-MM-DD HH:MM:SS" with the
    unit's fraction digits, and for a zoned column its local time followed
    by "Z" (UTC) or "+hhmm"."""
    per = temporal.PER_SECOND[unit]
    local = temporal.to_local(values, unit, tz)
    secs, sub = np.divmod(local, per)
    days, sod = np.divmod(secs, 86_400)
    y, m, d = temporal.civil_from_days(days)
    hh, rest = np.divmod(sod, 3600)
    mi, ss = np.divmod(rest, 60)
    fr = _frac(sub, unit)
    if tz is None:
        suffix = [""] * len(values)
    elif tz == "UTC":
        suffix = ["Z"] * len(values)
    else:
        offs = (local - np.asarray(values, dtype=np.int64)) // per
        suffix = [("-" if o < 0 else "+") + f"{abs(o) // 3600:02d}{abs(o) % 3600 // 60:02d}"
                  for o in offs.tolist()]
    out = np.empty(len(values), dtype=object)
    out[:] = [f"{a:04d}-{b:02d}-{c:02d} {e:02d}:{f:02d}:{g:02d}{h}{z}" if ok else None
              for a, b, c, e, f, g, h, z, ok in zip(y.tolist(), m.tolist(), d.tolist(),
                                                    hh.tolist(), mi.tolist(), ss.tolist(),
                                                    fr, suffix, valid.tolist())]
    return out


def temporal_cast(s: "Series", dtype: DataType) -> np.ndarray:
    """The storage values of ``s`` cast to ``dtype``, where either side is
    temporal, as Arrow casts them (a timestamp read in its zone's local
    time where the target is a date, a time of day or a string); raises
    ValueError for a cast Arrow refuses or one that would lose ticks."""
    src = s.dtype
    v = s.to_numpy()
    valid = s.validity_numpy()
    sk, tk = src.kind, dtype.kind

    def refuse():
        return ValueError(f"Unsupported cast from {src} to {dtype}")

    vals = np.where(valid, v, 0) if v.dtype != object else v
    if sk == "timestamp":
        unit, tz = src.time_unit, src.timezone
        if tk == "timestamp":
            return temporal.convert_unit(vals, unit, dtype.time_unit)
        if tk == "date":
            local = temporal.to_local(vals, unit, tz)
            return np.floor_divide(local, 86_400 * temporal.PER_SECOND[unit]).astype(np.int32)
        if tk == "time":
            local = temporal.to_local(vals, unit, tz)
            tod = np.mod(local, 86_400 * temporal.PER_SECOND[unit])
            return temporal.convert_unit(tod, unit, dtype.storage_unit)
        if tk == "int64":
            return vals.astype(np.int64)
        if tk == "string":
            return format_timestamps(vals, valid, unit, tz)
        raise refuse()
    if sk == "date" and tk == "timestamp":
        return vals.astype(np.int64) * np.int64(86_400 * temporal.PER_SECOND[dtype.time_unit])
    if sk == "date" and tk == "string":
        y, m, d = temporal.civil_from_days(vals)
        out = np.empty(len(v), dtype=object)
        out[:] = [f"{a:04d}-{b:02d}-{c:02d}" if ok else None
                  for a, b, c, ok in zip(y.tolist(), m.tolist(), d.tolist(), valid.tolist())]
        return out
    if sk == "duration":
        if tk == "duration":
            return temporal.convert_unit(vals, src.time_unit, dtype.time_unit)
        if tk == "int64":
            return vals.astype(np.int64)
        if tk == "string":
            out = np.empty(len(v), dtype=object)
            out[:] = [str(x) if ok else None for x, ok in zip(vals.tolist(), valid.tolist())]
            return out
        raise refuse()
    if sk == "time":
        if tk == "time":
            return temporal.convert_unit(vals, src.storage_unit, dtype.storage_unit)
        if tk == "int64":
            return vals.astype(np.int64)
        if tk == "string":
            unit = src.storage_unit
            per = temporal.PER_SECOND[unit]
            secs, sub = np.divmod(vals, per)
            hh, rest = np.divmod(secs, 3600)
            mi, ss = np.divmod(rest, 60)
            out = np.empty(len(v), dtype=object)
            out[:] = [f"{a:02d}:{b:02d}:{c:02d}{f}" if ok else None
                      for a, b, c, f, ok in zip(hh.tolist(), mi.tolist(), ss.tolist(),
                                                _frac(sub, unit), valid.tolist())]
            return out
        raise refuse()
    if src.is_integer() and tk in ("timestamp", "duration", "time"):
        return vals.astype(np.int64)
    if sk == "string" and tk == "timestamp":
        zoned = dtype.timezone is not None
        return np.asarray([_parse_iso(x, dtype.time_unit, zoned) if ok else 0
                           for x, ok in zip(v.tolist(), valid.tolist())], dtype=np.int64)
    if sk == "string" and tk == "date":
        out = []
        for x, ok in zip(v.tolist(), valid.tolist()):
            if not ok:
                out.append(0)
                continue
            try:
                out.append(datetime.date.fromisoformat(x).toordinal() - _EPOCH_ORDINAL)
            except ValueError:
                raise ValueError(f"Failed to parse string: {x!r} as a scalar of type date32")
        return np.asarray(out, dtype=np.int32)
    raise refuse()

