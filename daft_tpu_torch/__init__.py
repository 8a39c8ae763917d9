"""daft_tpu_torch: the PyTorch/CUDA port of the daft_tpu engine.

The JAX package ``daft_tpu`` is the reference this port is held against; the
port imports nothing of it, nor JAX, nor pyarrow. Host columns are numpy
arrays with a validity mask; device work is torch on the configured device
(``ExecutionConfig.device``, "cuda" by default), with the grouped
aggregation's segment reductions in hand-written CUDA kernels
(ops/csrc/segment_reduce.cu).

    import daft_tpu_torch as dt
    df = dt.from_pydict({"k": [1, 2, 1], "v": [10, 20, 30]})
    df.groupby("k").agg(dt.col("v").sum()).sort("k").to_pydict()
    dt.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k", t=df).to_pydict()

Files (io/, no pyarrow): ``df.write_parquet(dir)``, ``dt.read_parquet(dir)``,
``df.write_csv(dir)``, ``dt.read_csv(dir)``; SQL resolves unbound table
names through ``dt.current_session()``.

UDFs (udf/): ``@dt.func``, ``@dt.cls`` with ``@dt.method``, the legacy
``@dt.udf``; ``on_device=True`` puts one on the device-UDF tier
(ops/udf_stage.py). Text embedding and classification on the card:

    from daft_tpu_torch.functions.ai import classify_text, embed_text
    df.select(embed_text(dt.col("text"), provider="torch").alias("e"))
"""

from .config import ExecutionConfig, execution_config, execution_config_ctx, \
    set_execution_config
from .core.micropartition import MicroPartition
from .core.recordbatch import RecordBatch
from .core.series import Series
from .dataframe.dataframe import DataFrame, GroupedDataFrame, read_csv, read_parquet
from .datatype import DataType, Field
from .expressions.expressions import Expression, col, lit
from .interop import from_numpy_columns
from .plan import logical as _lp
from .schema import Schema
from .session import Session, current_session
from . import udf  # noqa: E402  (the callable UDF package: dt.udf(return_dtype=...))
from .udf import Func, cls, func, method
from . import sql  # noqa: E402  (the callable SQL module: dt.sql("SELECT ...", t=df))
from .sql import sql_expr
from .utils import torch_setup as _torch_setup  # noqa: F401  (fixes TF32 off)


def from_pydict(data) -> DataFrame:
    """A DataFrame over one in-memory partition; values are Python lists,
    numpy arrays or Series."""
    part = MicroPartition.from_pydict(data)
    part.hold()
    return DataFrame(_lp.InMemorySource(part.schema, [part]))


__all__ = [
    "DataFrame", "DataType", "ExecutionConfig", "Expression", "Field", "Func",
    "GroupedDataFrame", "MicroPartition", "RecordBatch", "Schema", "Series", "Session",
    "cls", "col", "current_session", "execution_config", "execution_config_ctx",
    "from_numpy_columns", "from_pydict", "func", "lit", "method", "read_csv",
    "read_parquet", "set_execution_config", "sql", "sql_expr", "udf",
]
