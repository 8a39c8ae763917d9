"""Logical data types (counterpart of daft_tpu/datatype.py, the integer, float,
bool, string and date kinds, lists, and ``python`` for arbitrary objects).

The port keeps host columns in numpy, not Arrow: ``to_numpy`` is the host
storage dtype (dates are int32 days since the epoch, strings are object
arrays) and ``to_torch`` the device dtype (the counterpart of ``to_jax``,
datatype.py:394-409).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: "DataType"

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype})"


_INTEGER_KINDS = frozenset({"int8", "int16", "int32", "int64", "uint8", "uint16",
                            "uint32", "uint64"})
_FLOAT_KINDS = frozenset({"float32", "float64"})

_NUMPY_MAP = {
    "bool": "bool",
    "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
    "uint8": "uint8", "uint16": "uint16", "uint32": "uint32", "uint64": "uint64",
    "float32": "float32", "float64": "float64",
    "date": "int32", "string": "object", "null": "object",
    "list": "object", "python": "object",
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
    def list(cls, inner: "DataType") -> "DataType":
        """Variable-length lists of ``inner`` (host storage: an object array
        of Python lists)."""
        return cls("list", (inner,))

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
        return self.kind == "date"

    def is_string(self) -> bool:
        return self.kind == "string"

    def is_list(self) -> bool:
        return self.kind == "list"

    @property
    def inner(self) -> "DataType":
        """The element type of a list."""
        if not self.is_list():
            raise ValueError(f"{self} has no element type")
        return self.params[0]

    # ---- conversion ---------------------------------------------------------------
    @classmethod
    def from_numpy(cls, np_dtype) -> "DataType":
        dt = np.dtype(np_dtype)
        if dt.kind == "M":
            if np.datetime_data(dt)[0] != "D":
                raise ValueError(f"only datetime64[D] maps to date, got {dt}")
            return cls.date()
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
        raise ValueError(f"{self} is not device-compatible")

    def __repr__(self) -> str:
        if self.is_list():
            return f"List[{self.params[0]!r}]"
        return self.kind.capitalize() if self.kind != "null" else "Null"
