"""Logical data types (counterpart of daft_tpu/datatype.py, the integer, float,
bool, string, binary and temporal kinds, the nested kinds (lists, fixed-size
lists, structs, maps; datatype.py:153-199, 334-381), the multimodal logical
kinds (embedding, image, fixed-shape image, tensor, fixed-shape tensor,
sparse tensor, file; datatype.py:197-236, with ``ImageMode``, :37-70), and
``python`` for arbitrary objects).

The port keeps host columns in numpy, not Arrow: ``to_numpy`` is the host
storage dtype (dates are int32 days since the epoch; timestamps, durations
and times int64 ticks of their unit, core/temporal.py; strings and binary
are object arrays; a nested column keeps Arrow's layout of offsets and
child columns, core/series.py) and ``to_torch`` the device dtype (the
counterpart of ``to_jax``, datatype.py:394-409). A logical kind is stored
as its Arrow storage type (datatype.py:498-530; ``storage``): an image a
struct of its bytes, mode, height, width and channels, a fixed-shape image,
an embedding and a fixed-shape tensor a fixed-size list, a tensor and a
sparse tensor their structs, a file a struct of its path and bytes. Of the
binary and nested types only the embedding, the fixed-shape tensor and the
fixed-shape image are device-compatible (a fixed-size list of numbers, too,
goes to the device as one dense (rows, *shape) plane).
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


class ImageMode:
    """Image modes (counterpart of daft_tpu/datatype.py:37-70): channels and
    the numpy element type of each."""

    L = "L"
    LA = "LA"
    RGB = "RGB"
    RGBA = "RGBA"
    L16 = "L16"
    LA16 = "LA16"
    RGB16 = "RGB16"
    RGBA16 = "RGBA16"
    RGB32F = "RGB32F"
    RGBA32F = "RGBA32F"

    _CHANNELS = {
        "L": 1, "LA": 2, "RGB": 3, "RGBA": 4,
        "L16": 1, "LA16": 2, "RGB16": 3, "RGBA16": 4,
        "RGB32F": 3, "RGBA32F": 4,
    }
    _NP_DTYPE = {
        "L": np.uint8, "LA": np.uint8, "RGB": np.uint8, "RGBA": np.uint8,
        "L16": np.uint16, "LA16": np.uint16, "RGB16": np.uint16, "RGBA16": np.uint16,
        "RGB32F": np.float32, "RGBA32F": np.float32,
    }

    @staticmethod
    def num_channels(mode: str) -> int:
        return ImageMode._CHANNELS[mode]

    @staticmethod
    def np_dtype(mode: str):
        return ImageMode._NP_DTYPE[mode]


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
    "embedding": "object", "image": "object", "fixed_shape_image": "object",
    "tensor": "object", "fixed_shape_tensor": "object", "sparse_tensor": "object",
    "file": "object", "decimal128": "object",
}

_LOGICAL_KINDS = frozenset({"embedding", "image", "fixed_shape_image", "tensor",
                            "fixed_shape_tensor", "sparse_tensor", "file"})
# the kinds whose host values are a dense (rows, *shape) array (series.py:153-185)
_FIXED_SHAPE_KINDS = frozenset({"fixed_size_list", "embedding", "fixed_shape_tensor",
                                "fixed_shape_image"})


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
    def decimal128(cls, precision: int, scale: int) -> "DataType":
        """DECIMAL(precision, scale), host only (core/decimal.py)."""
        from .core.decimal import check_type

        check_type(int(precision), int(scale))
        return cls("decimal128", (int(precision), int(scale)))

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

    # ---- multimodal logical types (datatype.py:197-236) --------------------------
    @classmethod
    def embedding(cls, inner: "DataType", size: int) -> "DataType":
        if not inner.is_numeric():
            raise ValueError(f"embedding inner dtype must be numeric, got {inner}")
        return cls("embedding", (inner, size))

    @classmethod
    def image(cls, mode: Optional[str] = None) -> "DataType":
        if mode is not None and mode not in ImageMode._CHANNELS:
            raise ValueError(f"invalid image mode {mode!r}")
        return cls("image", (mode,))

    @classmethod
    def fixed_shape_image(cls, mode: str, height: int, width: int) -> "DataType":
        if mode not in ImageMode._CHANNELS:
            raise ValueError(f"invalid image mode {mode!r}")
        return cls("fixed_shape_image", (mode, height, width))

    @classmethod
    def tensor(cls, inner: "DataType", shape: Optional[Tuple[int, ...]] = None) -> "DataType":
        if shape is not None:
            return cls("fixed_shape_tensor", (inner, tuple(shape)))
        return cls("tensor", (inner,))

    @classmethod
    def fixed_shape_tensor(cls, inner: "DataType", shape: Tuple[int, ...]) -> "DataType":
        return cls("fixed_shape_tensor", (inner, tuple(shape)))

    @classmethod
    def sparse_tensor(cls, inner: "DataType") -> "DataType":
        return cls("sparse_tensor", (inner,))

    @classmethod
    def file(cls) -> "DataType":
        return cls("file")

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

    def is_decimal(self) -> bool:
        """A decimal is a number to the type rules but not ``is_numeric``:
        it has no numpy or device representation (core/decimal.py)."""
        return self.kind == "decimal128"

    def is_binary(self) -> bool:
        return self.kind in ("binary", "fixed_size_binary")

    def is_list(self) -> bool:
        return self.kind in ("list", "fixed_size_list")

    def is_struct(self) -> bool:
        return self.kind == "struct"

    def is_map(self) -> bool:
        return self.kind == "map"

    def is_nested(self) -> bool:
        """Stored as a ``NestedLayout`` (core/series.py): a list, struct or
        map, or a logical kind, whose storage is one of them."""
        return self.is_list() or self.is_struct() or self.is_map() \
            or self.kind in _LOGICAL_KINDS

    def is_logical(self) -> bool:
        return self.kind in _LOGICAL_KINDS

    def is_fixed_shape(self) -> bool:
        """A fixed-size list, embedding, fixed-shape tensor or fixed-shape
        image: host values a dense (rows, *shape) array, device values one
        plane of that shape."""
        return self.kind in _FIXED_SHAPE_KINDS

    def is_python(self) -> bool:
        return self.kind == "python"

    def is_comparable(self) -> bool:
        """Types with an order (datatype.py:283-287): binary is, a
        fixed-size binary and the nested types are not."""
        return (self.is_numeric() or self.is_boolean() or self.is_string()
                or self.is_temporal() or self.kind == "binary" or self.is_null()
                or self.is_decimal())

    def is_device_compatible(self) -> bool:
        """Whether a column of this type can live on the device as one
        plane (datatype.py:303-307): the numbers, booleans and temporal
        kinds, and the embedding, fixed-shape tensor and fixed-shape image
        as dense (rows, *shape) planes."""
        return self.is_numeric() or self.is_boolean() or self.is_temporal() \
            or self.kind in ("embedding", "fixed_shape_tensor", "fixed_shape_image")

    @property
    def inner(self) -> "DataType":
        """The element type of a list, a fixed-size list, an embedding or a
        tensor (datatype.py:309-314)."""
        if self.kind not in ("list", "fixed_size_list", "embedding", "tensor",
                             "fixed_shape_tensor", "sparse_tensor"):
            raise ValueError(f"{self} has no inner dtype")
        return self.params[0]

    @property
    def size(self) -> int:
        """The length of a fixed-size list or an embedding, the width of a
        fixed-size binary."""
        if self.kind in ("fixed_size_list", "embedding"):
            return self.params[1]
        if self.kind == "fixed_size_binary":
            return self.params[0]
        raise ValueError(f"{self} has no fixed size")

    @property
    def shape(self) -> Tuple[int, ...]:
        """A fixed-shape tensor's shape; a fixed-shape image's (height,
        width, channels) (datatype.py:325-332)."""
        if self.kind == "fixed_shape_tensor":
            return self.params[1]
        if self.kind == "fixed_shape_image":
            mode, h, w = self.params
            return (h, w, ImageMode.num_channels(mode))
        raise ValueError(f"{self} has no fixed shape")

    @property
    def image_mode(self) -> Optional[str]:
        if self.kind in ("image", "fixed_shape_image"):
            return self.params[0]
        raise ValueError(f"{self} is not an image dtype")

    @property
    def dense_shape(self) -> Tuple[int, ...]:
        """A fixed-shape kind's row shape: (size,) for a fixed-size list or
        an embedding, else ``shape``."""
        if self.kind in ("fixed_size_list", "embedding"):
            return (self.params[1],)
        return self.shape

    @property
    def element_numpy(self) -> np.dtype:
        """The numpy element type of a fixed-shape kind's dense values (an
        image's that of its mode)."""
        if self.kind == "fixed_shape_image":
            return np.dtype(ImageMode.np_dtype(self.params[0]))
        return self.params[0].to_numpy()

    @property
    def storage(self) -> "DataType":
        """The Arrow storage type of a logical kind (datatype.py:498-530);
        any other type is its own storage."""
        k = self.kind
        if k == "embedding":
            return DataType.fixed_size_list(self.params[0], self.params[1])
        if k == "fixed_shape_image":
            mode, h, w = self.params
            return DataType.fixed_size_list(
                DataType(np.dtype(ImageMode.np_dtype(mode)).name),
                h * w * ImageMode.num_channels(mode))
        if k == "fixed_shape_tensor":
            inner, shape = self.params
            return DataType.fixed_size_list(inner, int(np.prod(shape)) if shape else 1)
        if k == "image":
            return DataType.struct((("data", DataType.binary()), ("mode", DataType.uint8()),
                                    ("height", DataType.uint32()),
                                    ("width", DataType.uint32()),
                                    ("channels", DataType.uint8())))
        if k == "tensor":
            return DataType.struct((("data", DataType.list(self.params[0])),
                                    ("shape", DataType.list(DataType.uint64()))))
        if k == "sparse_tensor":
            return DataType.struct((("values", DataType.list(self.params[0])),
                                    ("indices", DataType.list(DataType.uint64())),
                                    ("shape", DataType.list(DataType.uint64()))))
        if k == "file":
            return DataType.struct((("path", DataType.string()), ("data", DataType.binary())))
        return self

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
        if self.kind in ("embedding", "fixed_shape_tensor", "fixed_shape_image"):
            return DataType(self.element_numpy.name).to_torch()
        raise ValueError(f"{self} is not device-compatible")

    def __repr__(self) -> str:
        if self.kind == "list":
            return f"List[{self.params[0]!r}]"
        if self.kind == "fixed_size_list":
            return f"FixedSizeList[{self.params[0]}; {self.params[1]}]"
        if self.kind == "embedding":
            return f"Embedding[{self.params[0]}; {self.params[1]}]"
        if self.kind == "fixed_shape_tensor":
            return f"Tensor[{self.params[0]}; {'x'.join(map(str, self.params[1]))}]"
        if self.kind == "tensor":
            return f"Tensor[{self.params[0]}]"
        if self.kind == "sparse_tensor":
            return f"SparseTensor[{self.params[0]}]"
        if self.kind == "image":
            return f"Image[{self.params[0] or 'MIXED'}]"
        if self.kind == "fixed_shape_image":
            return f"Image[{self.params[0]}; {self.params[1]}x{self.params[2]}]"
        if self.kind == "struct":
            inner = ", ".join(f"{n}: {t}" for n, t in self.params)
            return f"Struct[{inner}]"
        if self.kind == "map":
            return f"Map[{self.params[0]}: {self.params[1]}]"
        if self.kind == "decimal128":
            return f"Decimal128({self.params[0]}, {self.params[1]})"
        if self.kind == "fixed_size_binary":
            return f"FixedSizeBinary({self.params[0]})"
        if self.kind == "timestamp":
            unit, tz = self.params
            return f"Timestamp({unit}, {tz})" if tz else f"Timestamp({unit})"
        if self.kind in ("time", "duration"):
            return f"{self.kind.capitalize()}({self.params[0]})"
        return self.kind.capitalize() if self.kind != "null" else "Null"
