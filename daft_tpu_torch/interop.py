"""Carry columns across from the reference engine.

``from_numpy_columns`` builds a port DataFrame from numpy planes, in the form
the reference's ``Series.to_numpy()`` and ``Series.validity_numpy()`` give
them (dates as datetime64[D] or int32 days, timestamps and durations as
int64 ticks or datetime64 / timedelta64, their unit and zone from the
schema, strings as object arrays, null slots holding 0, NaN, NaT or None),
so one table can be fed to both engines column for column. ``encoder_params`` turns the reference's encoder
weights (``JaxEncoderWeights.params``, nested numpy) into the port's
parameter dict, so both packages can run one encoder. Both take plain
numpy: nothing of the reference is imported.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np

from .datatype import DataType
from .schema import Schema


def from_numpy_columns(columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
                       schema: Union[Schema, Mapping[str, DataType]]):
    """A DataFrame of one partition from {name: (values, validity)}; the
    schema gives each column's type and the column order."""
    from . import from_pydict
    from .core.series import Series

    if not isinstance(schema, Schema):
        schema = Schema.from_pydict(dict(schema))
    if set(columns) != set(schema.column_names()):
        raise ValueError(f"columns {sorted(columns)} do not match the schema's "
                         f"{schema.column_names()}")
    data = {}
    for f in schema:
        values, validity = columns[f.name]
        data[f.name] = Series.from_numpy(np.asarray(values), f.name, dtype=f.dtype,
                                         validity=np.asarray(validity, dtype=bool))
    return from_pydict(data)


def encoder_params(params) -> Dict[str, np.ndarray]:
    """The port's encoder parameter dict (ai/torch_provider.py ``Encoder``'s
    names) from the reference's nested weights ({"tok", "pos", "ln0_g",
    "ln0_b", "layers": [{"q", "qb", ...}, ...]}), the arrays as they are."""
    from .ai.torch_provider import flat_params

    return flat_params(params)
