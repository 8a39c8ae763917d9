"""Series: a named, typed column (counterpart of daft_tpu/core/series.py).

Host storage is numpy, not Arrow: a values array plus a bool validity mask.
Strings are object arrays, dates int32 days since 1970-01-01; a null slot
holds 0 (NaN for floats, None for strings), as the reference's
``Series.to_numpy()`` fills it. Device storage is a (values, validity) pair
of torch tensors made by ``to_device`` / ``to_device_cached``.
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional, Sequence

import numpy as np

from ..datatype import DataType, Field

_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_ORDINAL = _EPOCH.toordinal()


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
    if dtype.is_string() or dtype.is_null():
        return None
    return 0


class Series:
    __slots__ = ("_name", "_dtype", "_values", "_validity", "_dict_codes",
                 "__weakref__")

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

    def dict_codes(self):
        """Dictionary-encode this column: (codes int32 ndarray, values list, K).

        codes[i] in [0, K) indexes row i's value in ``values`` (first-occurrence
        order); null gets its own code. Cached on the Series, which is
        immutable, so repeated grouped queries factorize each key once."""
        if self._dict_codes is not None:
            return self._dict_codes
        from .kernels.groupby import make_groups

        first_idx, group_ids, _ = make_groups([self])
        values = self.take(first_idx).to_pylist()
        self._dict_codes = (group_ids.astype(np.int32), values, len(values))
        return self._dict_codes

    def hash(self, seed: Optional["Series"] = None) -> "Series":
        """Deterministic 64-bit hash per row, as a uint64 Series (nulls hash
        to a fixed value); bit-identical to the reference's (see
        core/kernels/hashing.py)."""
        from .kernels.hashing import hash_series

        return hash_series(self, seed)

    # ---- selection ----------------------------------------------------------------
    def slice(self, start: int, end: int) -> "Series":
        return Series(self._name, self._dtype, self._values[start:end],
                      self._validity[start:end])

    def head(self, n: int) -> "Series":
        return self.slice(0, min(n, len(self)))

    def take(self, indices) -> "Series":
        idx = np.asarray(indices, dtype=np.int64)
        return Series(self._name, self._dtype, self._values[idx], self._validity[idx])

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
        return cls(first._name, first._dtype,
                   np.concatenate([s._values for s in series_list]),
                   np.concatenate([s._validity for s in series_list]))

    def cast(self, dtype: DataType) -> "Series":
        if dtype == self._dtype:
            return self
        if self._dtype.is_null():
            return Series.full_null(self._name, dtype, len(self))
        if dtype.is_string() or self._dtype.is_string():
            raise ValueError(f"cast {self._dtype} -> {dtype} is not supported by the port")
        values = self._values.astype(dtype.to_numpy())
        if not self._validity.all():
            values = np.where(self._validity, values, values.dtype.type(_null_fill(dtype)))
        return Series(self._name, dtype, values, self._validity)
