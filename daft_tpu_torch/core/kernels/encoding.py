"""Join-key canonicalization (counterpart of daft_tpu/core/kernels/encoding.py
``canonical_key_values`` and ``_common_key_dtype``, for the port's integer,
float, bool, temporal and string keys).

Both sides of an equi-join compare in one common key type, and the values
are canonicalized so that equal keys get equal representations: integers,
bools, dates and the int64 ticks of timestamps, durations and times as
int64 (two temporal keys of one kind but different units compare in the
finer unit, ``core/temporal.common_temporal_type``), floats as the bit
pattern of ``v + 0.0`` (so -0.0 equals 0.0), strings as Python objects.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...datatype import DataType


def _common_key_dtype(a: DataType, b: DataType) -> DataType:
    """The type both sides of a key pair are cast to before they compare."""
    if a == b:
        return a
    if a.is_null():
        return b
    if b.is_null():
        return a
    if a.is_numeric() and b.is_numeric():
        return DataType.from_numpy(np.promote_types(a.to_numpy(), b.to_numpy()))
    if a.kind == b.kind and a.is_temporal() \
            and (a.kind != "timestamp" or a.timezone == b.timezone):
        from ..temporal import common_temporal_type

        return common_temporal_type(a, b)
    raise ValueError(f"cannot join/compare keys of dtypes {a} and {b}")


def canonical_key_values(s) -> Tuple[str, np.ndarray, np.ndarray]:
    """(kind, values, valid) of a key column: kind "num" with int64 values
    for numeric, bool and temporal keys, "obj" with an object array for
    strings and binary, "null" for an all-null column. A nested key
    compares by its 64-bit row hash (the reference's "hash" kind,
    encoding.py:278-297), given as "num" values."""
    dt = s.dtype
    valid = s.validity_numpy()
    if dt.is_null():
        return "null", np.zeros(len(s), dtype=np.int64), valid
    if dt.is_nested() or dt.kind == "fixed_size_binary":
        return "num", s.hash().to_numpy().view(np.int64), valid
    vals = s.to_numpy()
    if dt.is_numeric() or dt.is_boolean() or dt.is_temporal():
        if vals.dtype.kind == "f":
            vals = (vals + 0.0).view(np.int64 if vals.dtype.itemsize == 8
                                     else np.int32)
        return "num", vals.astype(np.int64, copy=False), valid
    return "obj", vals, valid
