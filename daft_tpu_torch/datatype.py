"""Logical data types (counterpart of daft_tpu/datatype.py, the integer, float,
bool, string, binary and temporal kinds, the nested kinds (lists, fixed-size
lists, structs, maps; datatype.py:153-199, 334-381), and ``python`` for
arbitrary objects).

The port keeps host columns in numpy, not Arrow: ``to_numpy`` is the host
storage dtype (dates are int32 days since the epoch; timestamps, durations
and times int64 ticks of their unit, core/temporal.py; strings and binary
are object arrays; a nested column keeps Arrow's layout of offsets and
child columns, core/series.py) and ``to_torch`` the device dtype (the
counterpart of ``to_jax``, datatype.py:394-409). No binary or nested type
is device-compatible.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np


class TimeUnit:
    SECONDS = "s"
    MILLISECONDS = "ms"
    MICROSECONDS = "us"
    NANOSECONDS = "ns"

    _ALL = ("s", "ms", "us", "ns")

    @staticmethod
    def check(unit: str) -> str:
        if unit not in TimeUnit._ALL:
            raise ValueError(f"invalid time unit {unit!r}; expected one of {TimeUnit._ALL}")
        return unit


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: "DataType"

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype})"


_INTEGER_KINDS = frozenset({"int8", "int16", "int32", "int64", "uint8", "uint16",
                            "uint32", "uint64"})
_FLOAT_KINDS = frozenset({"float32", "float64"})
_TEMPORAL_KINDS = frozenset({"date", "time", "timestamp", "duration"})

_NUMPY_MAP = {
    "bool": "bool",
    "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
    "uint8": "uint8", "uint16": "uint16", "uint32": "uint32", "uint64": "uint64",
    "float32": "float32", "float64": "float64",
    "date": "int32", "timestamp": "int64", "duration": "int64", "time": "int64",
    "string": "object", "null": "object", "binary": "object", "fixed_size_binary": "object",
    "list": "object", "fixed_size_list": "object", "struct": "object", "map": "object",
    "python": "object",
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """An immutable logical data type; ``kind`` is a string tag."""

    kind: str
    params: Tuple[Any, ...] = ()

    # ---- constructors -------------------------------------------------------------
    @classmethod
    def null(cls) -> "DataType":
        return cls("null")

    @classmethod
    def bool(cls) -> "DataType":
        return cls("bool")

    @classmethod
    def int8(cls) -> "DataType":
        return cls("int8")

    @classmethod
    def int16(cls) -> "DataType":
        return cls("int16")

    @classmethod
    def int32(cls) -> "DataType":
        return cls("int32")

    @classmethod
    def int64(cls) -> "DataType":
        return cls("int64")

    @classmethod
    def uint8(cls) -> "DataType":
        return cls("uint8")

    @classmethod
    def uint16(cls) -> "DataType":
        return cls("uint16")

    @classmethod
    def uint32(cls) -> "DataType":
        return cls("uint32")

    @classmethod
    def uint64(cls) -> "DataType":
        return cls("uint64")

    @classmethod
    def float32(cls) -> "DataType":
        return cls("float32")

    @classmethod
    def float64(cls) -> "DataType":
        return cls("float64")

    @classmethod
    def string(cls) -> "DataType":
        return cls("string")

    @classmethod
    def date(cls) -> "DataType":
        return cls("date")

    @classmethod
    def time(cls, unit: str = TimeUnit.MICROSECONDS) -> "DataType":
        return cls("time", (TimeUnit.check(unit),))

    @classmethod
    def timestamp(cls, unit: str = TimeUnit.MICROSECONDS,
                  timezone: Optional[str] = None) -> "DataType":
        return cls("timestamp", (TimeUnit.check(unit), timezone))

    @classmethod
    def duration(cls, unit: str = TimeUnit.MICROSECONDS) -> "DataType":
        return cls("duration", (TimeUnit.check(unit),))

    @classmethod
    def binary(cls) -> "DataType":
        return cls("binary")

    @classmethod
    def fixed_size_binary(cls, size: int) -> "DataType":
        return cls("fixed_size_binary", (size,))

    @classmethod
    def list(cls, inner: "DataType") -> "DataType":
        """Variable-length lists of ``inner`` (host storage: int64 offsets
        and one child column, as Arrow's ListArray)."""
        return cls("list", (inner,))

    @classmethod
    def fixed_size_list(cls, inner: "DataType", size: int) -> "DataType":
        return cls("fixed_size_list", (inner, size))

    @classmethod
    def struct(cls, fields) -> "DataType":
        """Named fields, in order (a dict, or (name, dtype) pairs)."""
        return cls("struct", tuple(fields.items()) if isinstance(fields, dict)
                   else tuple(fields))

    @classmethod
    def map(cls, key: "DataType", value: "DataType") -> "DataType":
        """Key-value lists (host storage: a list of a struct of ``key`` and
        ``value``, as Arrow's MapArray)."""
        return cls("map", (key, value))

    @classmethod
    def python(cls) -> "DataType":
        """Arbitrary Python objects (host only)."""
        return cls("python")

    # ---- predicates ---------------------------------------------------------------
    def is_null(self) -> bool:
        return self.kind == "null"

    def is_boolean(self) -> bool:
        return self.kind == "bool"

    def is_integer(self) -> bool:
        return self.kind in _INTEGER_KINDS

    def is_signed_integer(self) -> bool:
        return self.kind in ("int8", "int16", "int32", "int64")

    def is_unsigned_integer(self) -> bool:
        return self.kind in ("uint8", "uint16", "uint32", "uint64")

    def is_floating(self) -> bool:
        return self.kind in _FLOAT_KINDS

    def is_numeric(self) -> bool:
        return self.is_integer() or self.is_floating()

    def is_temporal(self) -> bool:
        return self.kind in _TEMPORAL_KINDS

    def is_string(self) -> bool:
        return self.kind == "string"

    def is_binary(self) -> bool:
        return self.kind in ("binary", "fixed_size_binary")

    def is_list(self) -> bool:
        return self.kind in ("list", "fixed_size_list")

    def is_struct(self) -> bool:
        return self.kind == "struct"

    def is_map(self) -> bool:
        return self.kind == "map"

    def is_nested(self) -> bool:
        return self.is_list() or self.is_struct() or self.is_map()

    def is_python(self) -> bool:
        return self.kind == "python"

    def is_comparable(self) -> bool:
        """Types with an order (datatype.py:283-287): binary is, a
        fixed-size binary and the nested types are not."""
        return (self.is_numeric() or self.is_boolean() or self.is_string()
                or self.is_temporal() or self.kind == "binary" or self.is_null())

    def is_device_compatible(self) -> bool:
        """Whether a column of this type can live on the device as one
        fixed-width plane (datatype.py:303-307, without the multimodal
        kinds): no binary or nested type is."""
        return self.is_numeric() or self.is_boolean() or self.is_temporal()

    @property
    def inner(self) -> "DataType":
        """The element type of a list or a fixed-size list."""
        if not self.is_list():
            raise ValueError(f"{self} has no inner dtype")
        return self.params[0]

    @property
    def size(self) -> int:
        """The length of a fixed-size list, the width of a fixed-size binary."""
        if self.kind == "fixed_size_list":
            return self.params[1]
        if self.kind == "fixed_size_binary":
            return self.params[0]
        raise ValueError(f"{self} has no fixed size")

    @property
    def struct_fields(self) -> Tuple[Tuple[str, "DataType"], ...]:
        if self.kind != "struct":
            raise ValueError(f"{self} is not a struct")
        return self.params

    @property
    def map_entry(self) -> "DataType":
        """A map's storage element: the struct of ``key`` and ``value``."""
        if self.kind != "map":
            raise ValueError(f"{self} is not a map")
        return DataType.struct((("key", self.params[0]), ("value", self.params[1])))

    @property
    def time_unit(self) -> str:
        if self.kind in ("time", "timestamp", "duration"):
            return self.params[0]
        raise ValueError(f"{self} has no time unit")

    @property
    def timezone(self) -> Optional[str]:
        if self.kind == "timestamp":
            return self.params[1]
        raise ValueError(f"{self} is not a timestamp")

    @property
    def storage_unit(self) -> str:
        """The unit of the stored ticks: the time unit, except that a time of
        day in s or ms is stored in us, as the reference's time64[us]."""
        if self.kind == "time":
            return "ns" if self.params[0] == "ns" else "us"
        return self.time_unit

    # ---- conversion ---------------------------------------------------------------
    @classmethod
    def from_numpy(cls, np_dtype) -> "DataType":
        dt = np.dtype(np_dtype)
        if dt.kind in ("M", "m"):
            unit = np.datetime_data(dt)[0]
            if dt.kind == "M" and unit == "D":
                return cls.date()
            if unit not in TimeUnit._ALL:
                raise ValueError(f"no port data type for numpy dtype {dt}")
            return cls.timestamp(unit) if dt.kind == "M" else cls.duration(unit)
        if dt.kind in ("U", "O"):
            return cls.string()
        if dt.name in _NUMPY_MAP and dt.name not in ("object",):
            return cls(dt.name)
        raise ValueError(f"no port data type for numpy dtype {dt}")

    def to_numpy(self) -> np.dtype:
        m = _NUMPY_MAP.get(self.kind)
        if m is None:
            raise ValueError(f"{self} has no numpy representation")
        return np.dtype(m)

    def to_torch(self):
        """The torch dtype of this column's values on the device. Unsigned
        16/32-bit integers widen to the next signed type (torch's unsigned
        types lack most kernels); uint64 has no device representation."""
        import torch

        if self.is_boolean():
            return torch.bool
        if self.kind in ("int8", "int16", "int32", "int64", "uint8", "float32",
                         "float64"):
            return getattr(torch, self.kind)
        if self.kind == "uint16":
            return torch.int32
        if self.kind == "uint32":
            return torch.int64
        if self.kind == "date":
            return torch.int32
        if self.kind in ("timestamp", "duration", "time"):
            return torch.int64
        raise ValueError(f"{self} is not device-compatible")

    def __repr__(self) -> str:
        if self.kind == "list":
            return f"List[{self.params[0]!r}]"
        if self.kind == "fixed_size_list":
            return f"FixedSizeList[{self.params[0]}; {self.params[1]}]"
        if self.kind == "struct":
            inner = ", ".join(f"{n}: {t}" for n, t in self.params)
            return f"Struct[{inner}]"
        if self.kind == "map":
            return f"Map[{self.params[0]}: {self.params[1]}]"
        if self.kind == "fixed_size_binary":
            return f"FixedSizeBinary({self.params[0]})"
        if self.kind == "timestamp":
            unit, tz = self.params
            return f"Timestamp({unit}, {tz})" if tz else f"Timestamp({unit})"
        if self.kind in ("time", "duration"):
            return f"{self.kind.capitalize()}({self.params[0]})"
        return self.kind.capitalize() if self.kind != "null" else "Null"
