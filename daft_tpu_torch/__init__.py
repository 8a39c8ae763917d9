"""daft_tpu_torch: the PyTorch/CUDA port of the daft_tpu engine.

The JAX package ``daft_tpu`` is the reference this port is held against; the
port imports nothing of it, nor JAX, nor pyarrow. Host columns are numpy
arrays with a validity mask; device work is torch on the configured device
(``ExecutionConfig.device``, "cuda" by default), with the grouped
aggregation's segment reductions in hand-written CUDA kernels
(ops/csrc/segment_reduce.cu). Host grouping, aggregation and joins run on
the host kernel library (native.py over csrc/kernels.cpp, built with the
host compiler at first use).

    import daft_tpu_torch as dt
    df = dt.from_pydict({"k": [1, 2, 1], "v": [10, 20, 30]})
    df.groupby("k").agg(dt.col("v").sum()).sort("k").to_pydict()
    dt.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k", t=df).to_pydict()

Windows: ``df.select(dt.col("v").sum().over(dt.Window().partition_by("k")))``,
the ranking functions in ``daft_tpu_torch.functions``, and SQL ``OVER``.
Out of core: under ``execution_config_ctx(memory_limit_bytes=N)`` the host
sort, aggregations, join build and windows spill past N bytes (memory/).

Files (io/, no pyarrow): ``df.write_parquet(dir)``, ``dt.read_parquet(dir)``,
``df.write_csv(dir)``, ``dt.read_csv(dir)``, ``df.write_json(dir)``,
``dt.read_json(dir)``, ``dt.read_text(path)``, ``dt.read_warc(path)``; SQL
resolves unbound table names through ``dt.current_session()``.

Images and files (core/kernels/image.py, png.py, functions/multimodal.py,
filetype.py): ``dt.from_files("dir/*.png")`` or ``dt.from_glob_path`` then
``col("path").url.download()``, ``.image.decode()``,
``.image.to_fixed_shape("RGB", 224, 224)`` (a dense column a device UDF
takes as one (rows, 224, 224, 3) uint8 tensor), ``.embedding
.cosine_distance(...)``; ``minhash``, ``tokenize_encode``, audio metadata
(functions/media.py) and the sketches ``approx_count_distinct`` /
``approx_percentile``.

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
from .dataframe.dataframe import DataFrame, GroupedDataFrame, read_csv, read_json, \
    read_parquet, read_text, read_warc
from .datatype import DataType, Field, ImageMode, TimeUnit
from .expressions.expressions import Expression, col, lit
from .ext import Extension, ExtensionFunction, call_function, load_extension
from .interop import from_numpy_columns
from .plan import logical as _lp
from .schema import Schema
from .session import Session, current_session
from .window import Window
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


def from_glob_path(path) -> DataFrame:
    """A DataFrame of the files a glob, a directory or a list names: path,
    size, num_rows (api.py:187-190)."""
    from .dataframe.dataframe import from_scan
    from .io.glob_files import GlobPathScanOperator

    return from_scan(GlobPathScanOperator(path))


def file(path_expr, io_config=None) -> Expression:
    """A lazy File column from path or URL strings (api.py:224-231)."""
    from .dataframe.dataframe import _to_expr

    return _to_expr(path_expr)._fn("file", io_config=io_config)


def from_files(path, io_config=None) -> DataFrame:
    """``from_glob_path`` with a lazy ``file`` column of each path
    (api.py:234-243): path, size, num_rows, file."""
    return from_glob_path(path).with_columns({"file": file(col("path"), io_config=io_config)})


def from_pylist(rows) -> DataFrame:
    """A DataFrame from a list of dicts (the columns of the first row's keys,
    in order; a missing key is null)."""
    names = list(rows[0]) if rows else []
    return from_pydict({n: [r.get(n) for r in rows] for n in names})


# ---- observability and serving conveniences (api.py:37-72) -------------------------


def launch_dashboard(host: str = "127.0.0.1", port: int = 0):
    """Start the embedded dashboard (query history, /api/* JSON, Prometheus
    /metrics); returns the Dashboard (``.url``, ``.shutdown()``)."""
    from .observability.dashboard import launch

    return launch(host, port)


def enable_event_log(path: str):
    """Append one JSON line per query lifecycle event to ``path``
    (observability/event_log.py); returns the subscriber."""
    from .observability.event_log import enable_event_log as _enable

    return _enable(path)


def serving_session(max_concurrent=None, runner=None, prepared_cap: int = 64):
    """A ServingSession (serving/): N concurrent queries behind fair
    per-tenant admission, the HBM admission controller and the
    prepared-query cache. A context manager::

        with dt.serving_session(max_concurrent=4) as sess:
            rows = sess.submit(df.groupby("k").agg(...), tenant="acme").to_pydict()
    """
    from .serving import ServingSession

    return ServingSession(max_concurrent=max_concurrent, runner=runner,
                          prepared_cap=prepared_cap)


__all__ = [
    "DataFrame", "DataType", "ExecutionConfig", "Expression", "Extension",
    "ExtensionFunction", "Field", "Func", "call_function", "load_extension",
    "GroupedDataFrame", "ImageMode", "MicroPartition", "RecordBatch", "Schema", "Series",
    "Session", "cls", "col", "current_session", "execution_config", "execution_config_ctx",
    "file", "from_files", "from_glob_path", "from_numpy_columns", "from_pydict",
    "from_pylist", "func", "enable_event_log", "launch_dashboard", "lit", "method",
    "read_csv", "read_json", "read_parquet", "read_text", "read_warc", "set_execution_config",
    "serving_session", "sql", "sql_expr", "TimeUnit", "udf", "Window",
]
