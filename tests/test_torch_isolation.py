"""The port stands alone and never hides a device failure:

- a port query (also under ``device_mode="auto"`` with the calibrate tool
  loaded, gated to the host on the CPU and priced with the gate open),
  the grouped one, the TPC-H q12 and q14 star joins, a fused
  region over a semi join, the mesh repartition, TPC-H q12 in SQL
  (``daft_tpu_torch.sql``), a query that writes and reads Parquet and
  CSV files, and embed, classify and a fused device UDF on the device-UDF
  tier alike, imports neither
  JAX, nor pyarrow, nor pandas, nor anything of
  daft_tpu (checked in a fresh interpreter: tests/conftest.py imports JAX
  into this one);
- with no card, a query left at the default device ("cuda") raises, an
  embed query too;
- a kernel wrapper that raises makes the query raise: no host result (the
  grouped stage's K1, the repartition's K6);
- ``from_numpy_columns`` reproduces the reference's columns;
- under ``pipeline_mode="force"`` (stage threads, the IO-parallel scan
  window, the build-once host join) a file-fed join query imports none of
  them either, a failing kernel wrapper still raises from ``collect()``,
  and a device query without a card still raises;
- a window query under a host memory budget, spilling its Grace
  partitions and sorted runs, imports none of them either;
- with the observability package (dashboard and OTLP exporter included),
  the runners and the query trace loaded, a subscriber, the dashboard and
  ``explain_analyze(profile=...)`` observing a device query import none of
  them either;
- a query of the expression surface (registry functions, ``abs``, ``%``,
  ``is_in``, the new aggregates, ``concat``, and SQL's ABS, % and UNION
  ALL) imports none of them either;
- host queries on the host kernel library (a grouped aggregate over a
  filter, a join) load the port's own build of csrc/kernels.cpp from
  daft_tpu_torch/ops/_kbuild/, never the reference's library, and import
  none of them either;
- a temporal query (timestamps on the device stage, in SQL, the zone
  functions, a Parquet and a CSV round trip) imports none of them either;
- a multimodal query (PNG files decoded, made fixed-shape and fed to a
  device UDF, cosine distances grouped on the device stage) and a minhash
  query import none of them, nor PIL, cv2, tokenizers, soundfile or av;
- an ingest query (a JPEG encoded and decoded, a BPE tokenizer file's
  encode, a JSON manifest and a WARC file scanned into the device stage,
  a JSON write) imports none of them, nor PIL, tokenizers or regex;
- the serving tier (serving, gateway, checkpoint, cli, io/arrow_ipc): a
  query served over a loopback gateway (cold, from the result cache, from
  a stage checkpoint), a ServingSession query, an LZ4 IPC stream written
  and read back, and the CLI import none of them;
- the distributed tier: a grouped query through a DistributedRunner with
  two leased worker processes, a socket-transport shuffle and a served
  query imports none of them in the coordinator, and each worker process, asked
  after the queries, holds none of them in its ``sys.modules``.
"""

import datetime
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col, lit
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import segment_kernels as sk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_QUERY = """
import datetime, sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col, lit
df = dt.from_pydict({{"k": np.arange(100) % 7, "v": np.arange(100, dtype=np.int32),
                      "d": np.arange(100).astype("datetime64[D]")}})
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = (df.where(col("d") <= lit(datetime.date(1970, 3, 1))).groupby("k")
           .agg(col("v").sum().alias("s"), col("d").min().alias("d0")).sort("k")
           .to_pydict())
assert out["k"] == list(range(7)), out
# device_mode="auto" with the calibrate tool loaded: on a CPU device the
# stage stays on the host; with the CPU gate open and the link terms pinned
# it is priced, and explain_placement reports it
import os
import daft_tpu_torch.tools.calibrate
from daft_tpu_torch.execution import executor
def query():
    return (df.where(col("d") <= lit(datetime.date(1970, 3, 1))).groupby("k")
            .agg(col("v").sum().alias("s"), col("d").min().alias("d0")).sort("k"))
with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
    assert query().to_pydict() == out
    os.environ.update(DAFT_TPU_COST_RTT="5e-5", DAFT_TPU_COST_H2D="1e10",
                      DAFT_TPU_COST_D2H="1e10")
    executor._auto_gate = lambda cfg: None
    report = query().explain_placement()
    assert "#1 grouped agg (100 rows) -> " in report and "margin:" in report, report
    assert query().to_pydict() == out
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


_JOIN_QUERY = """
import datetime, sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col, lit
rng = np.random.default_rng(0)
modes = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"], dtype=object)
prios = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"], dtype=object)
orders = dt.from_pydict({{"o_orderkey": np.arange(1, 301),
                          "o_orderpriority": prios[rng.integers(0, 5, 300)]}})
ship = rng.integers(8766, 9131, 2000)
lineitem = dt.from_pydict({{
    "l_orderkey": rng.integers(1, 301, 2000),
    "l_shipmode": modes[rng.integers(0, 7, 2000)],
    "l_shipdate": ship.astype("datetime64[D]"),
    "l_commitdate": (ship + rng.integers(-20, 40, 2000)).astype("datetime64[D]"),
    "l_receiptdate": (ship + rng.integers(1, 31, 2000)).astype("datetime64[D]")}})
high = col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = (lineitem.where(col("l_shipmode").is_in(["MAIL", "SHIP"])
                          & (col("l_commitdate") < col("l_receiptdate"))
                          & (col("l_shipdate") < col("l_commitdate"))
                          & (col("l_receiptdate") >= lit(datetime.date(1994, 1, 1)))
                          & (col("l_receiptdate") < lit(datetime.date(1995, 1, 1))))
           .join(orders, left_on="l_orderkey", right_on="o_orderkey")
           .with_column("high_line", high.if_else(lit(1), lit(0)))
           .with_column("low_line", (~high).if_else(lit(1), lit(0)))
           .groupby("l_shipmode")
           .agg(col("high_line").sum().alias("high"), col("low_line").sum().alias("low"))
           .sort("l_shipmode").to_pydict())
from daft_tpu_torch.ops import counters
assert out["l_shipmode"] == ["MAIL", "SHIP"], out
assert counters.device_join_batches == 1, counters.snapshot()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


_Q14_QUERY = """
import datetime, sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col, lit
rng = np.random.default_rng(0)
types = np.array(["PROMO BRUSHED TIN", "STANDARD PLATED COPPER", "PROMO POLISHED NICKEL",
                  "SMALL ANODIZED STEEL"], dtype=object)
part = dt.from_pydict({{"p_partkey": np.arange(1, 201), "p_type": types[rng.integers(0, 4, 200)]}})
ship = rng.integers(9300, 9400, 3000)
lineitem = dt.from_pydict({{
    "l_partkey": rng.integers(1, 201, 3000), "l_extendedprice": rng.uniform(900, 2000, 3000),
    "l_discount": np.round(rng.uniform(0, 0.1, 3000), 2),
    "l_shipdate": ship.astype("datetime64[D]")}})
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = (lineitem.where((col("l_shipdate") >= lit(datetime.date(1995, 9, 1)))
                          & (col("l_shipdate") < lit(datetime.date(1995, 10, 1))))
           .join(part, left_on="l_partkey", right_on="p_partkey")
           .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
           .with_column("promo", col("p_type").str.startswith("PROMO")
                        .if_else(col("revenue"), lit(0.0)))
           .agg(col("promo").sum().alias("promo_sum"), col("revenue").sum().alias("total_sum"))
           .select((lit(100.0) * col("promo_sum") / col("total_sum")).alias("promo_revenue"))
           .to_pydict())
from daft_tpu_torch.ops import counters
assert 0 < out["promo_revenue"][0] < 100, out
assert counters.device_join_batches == 1 and counters.device_stage_batches == 1, \
    counters.snapshot()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


_REPARTITION_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(0)
df = dt.from_pydict({{"k": rng.integers(0, 97, 5000), "v": rng.random(5000),
                      "b": rng.random(5000) < 0.5}})
with dt.execution_config_ctx(device="cpu", mesh_devices=8, device_min_rows=1):
    parts = df.repartition(8, col("k")).collect()._result
assert len(parts) == 8 and sum(len(p) for p in parts) == 5000
assert counters.mesh_fused_permute_dispatches == 1, counters.snapshot()
assert counters.plain_ring_permute_words == 1, counters.snapshot()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


_REGION_SEMI_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(0)
df = dt.from_pydict({{"k": rng.integers(0, 9, 3000), "v": rng.integers(-50, 50, 3000),
                      "w": rng.random(3000)}})
keys = dt.from_pydict({{"k": np.array([1, 3, 5])}})
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    fused = (df.with_column("x", col("v") * 2 + col("w")).where(col("x") > 0)
             .join(keys, on="k", how="semi")
             .with_column("y", col("x") * 3).where(col("v") < 40)
             .groupby("k").agg(col("y").sum().alias("s"), col("v").count().alias("c"))
             .sort("k").to_pydict())
assert fused["k"] == [1, 3, 5], fused
assert counters.device_region_dispatches == 1, counters.snapshot()
# the optimizer pushes v < 40 below the semi join: the region is project + agg
assert counters.device_region_ops_fused == 2, counters.snapshot()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


_SQL_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import chip_smoke
import daft_tpu_torch as dt
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(0)
modes = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"], dtype=object)
prios = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"], dtype=object)
orders = dt.from_pydict({{"o_orderkey": np.arange(1, 301),
                          "o_orderpriority": prios[rng.integers(0, 5, 300)]}})
ship = rng.integers(8766, 9131, 2000)
lineitem = dt.from_pydict({{
    "l_orderkey": rng.integers(1, 301, 2000),
    "l_shipmode": modes[rng.integers(0, 7, 2000)],
    "l_shipdate": ship.astype("datetime64[D]"),
    "l_commitdate": (ship + rng.integers(-20, 40, 2000)).astype("datetime64[D]"),
    "l_receiptdate": (ship + rng.integers(1, 31, 2000)).astype("datetime64[D]")}})
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = dt.sql(chip_smoke.TPCH_SQL[12], orders=orders, lineitem=lineitem).to_pydict()
assert out["l_shipmode"] == ["MAIL", "SHIP"], out
assert counters.device_join_batches == 1, counters.snapshot()
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def _small_query(df):
    return (df.where(col("d") <= lit(datetime.date(1970, 3, 1))).groupby("k")
            .agg(col("v").sum().alias("s"), col("v").max().alias("m")).sort("k"))


def _small_df():
    return daft_tpu_torch.from_pydict({"k": np.arange(64) % 5,
                                       "v": np.arange(64, dtype=np.int64),
                                       "d": np.arange(64).astype("datetime64[D]")})


def test_port_query_imports_no_jax_pyarrow_or_reference():
    proc = subprocess.run([sys.executable, "-c", _QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_port_join_query_imports_no_jax_pyarrow_or_reference():
    proc = subprocess.run([sys.executable, "-c", _JOIN_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_port_q14_imports_no_jax_pyarrow_or_reference():
    """TPC-H q14 (the ungrouped star join, startswith hoisted to the part
    dim) in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _Q14_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_port_repartition_imports_no_jax_pyarrow_or_reference():
    proc = subprocess.run([sys.executable, "-c", _REPARTITION_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_port_region_and_semi_join_import_no_jax_pyarrow_or_reference():
    """A fused region (project, filter, agg) over a host semi join, itself
    over a host project and filter, in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _REGION_SEMI_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert daft_tpu_torch.execution_config().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _small_query(_small_df()).to_pydict()
    # asking for the CPU runs; so does the host path, which needs no device
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        assert _small_query(_small_df()).to_pydict()["k"] == [0, 1, 2, 3, 4]
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        assert _small_query(_small_df()).to_pydict()["k"] == [0, 1, 2, 3, 4]


def test_failing_kernel_raises_instead_of_falling_back(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("segment_sum_planes: CUDA launch failed with error 98")

    monkeypatch.setattr(sk, "segment_sum_planes", broken)
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        df = _small_query(_small_df())
        with pytest.raises(RuntimeError, match="launch failed"):
            df.to_pydict()
    assert df._result is None
    assert counters.snapshot()["device_fallbacks"] == 0


def test_failing_exchange_kernel_raises_instead_of_falling_back(monkeypatch):
    from daft_tpu_torch.ops import permute_kernels

    def broken(*args, **kwargs):
        raise RuntimeError("ring_permute_words: CUDA launch failed with error 98")

    monkeypatch.setattr(permute_kernels, "ring_permute_words", broken)
    counters.reset()
    df = daft_tpu_torch.from_pydict({"k": np.arange(64) % 5,
                                     "v": np.arange(64.0)}).repartition(8, col("k"))
    with daft_tpu_torch.execution_config_ctx(device="cpu", mesh_devices=8,
                                             device_min_rows=1):
        with pytest.raises(RuntimeError, match="launch failed"):
            df.collect()
    assert df._result is None
    assert not counters.rejections
    assert counters.snapshot()["mesh_fused_permute_dispatches"] == 0


def test_from_numpy_columns_reproduces_reference_columns():
    rng = np.random.default_rng(11)
    n = 200
    tbl = pa.table({
        "i": pa.array(rng.integers(-5, 5, n), pa.int64(), mask=rng.random(n) < 0.2),
        "i32": pa.array(rng.integers(-5, 5, n).astype(np.int32), pa.int32()),
        "f": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "s": pa.array(rng.choice(["x", "yy", ""], n), mask=rng.random(n) < 0.2),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32), pa.date32(),
                      mask=rng.random(n) < 0.2),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
    })
    ref_df = daft_tpu.from_arrow(tbl)
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    port_df = from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port_batch = port_df.collect()._result[0].concat_or_empty()
        assert port_df.to_pydict() == ref_df.to_pydict()
    for s in batch.columns:
        p = port_batch.get_column(s.name)
        np.testing.assert_array_equal(p.validity_numpy(), s.validity_numpy())
        valid = s.validity_numpy()
        np.testing.assert_array_equal(p.to_numpy()[valid], s.to_numpy()[valid])


def test_port_sql_query_imports_no_jax_pyarrow_or_reference():
    """TPC-H q12 in SQL (parsed, planned, optimized and run on the device
    join's plain kernels) in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _SQL_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_FILE_QUERY = """
import os, sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(0)
df = dt.from_pydict({{"k": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, 500)],
                      "v": rng.random(500), "d": np.arange(500).astype("datetime64[D]")}})
root = tempfile.mkdtemp()
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    pq = df.write_parquet(os.path.join(root, "pq")).to_pydict()["path"]
    df.write_csv(os.path.join(root, "csv"))
    out = (dt.read_parquet(os.path.join(root, "pq")).where(col("v") > 0.5).groupby("k")
           .agg(col("v").count().alias("n")).sort("k").to_pydict())
    back = dt.read_csv(os.path.join(root, "csv")).to_pydict()
    dt.current_session().create_temp_table("t", dt.read_parquet(pq))
    n = dt.sql("SELECT COUNT(*) AS n FROM t").to_pydict()
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    want = df.to_pydict()
assert out["k"] == ["a", "b", "c"], out
assert sum(out["n"]) == sum(v > 0.5 for v in want["v"]), out
assert back == want and n == {{"n": [500]}}, n
assert counters.device_grouped_batches >= 1 and counters.scan_tasks >= 1
import shutil
shutil.rmtree(root)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_port_file_query_imports_no_jax_pyarrow_or_reference():
    """write_parquet, write_csv, read_parquet into a device grouped stage,
    read_csv, and SQL over a session table in a fresh interpreter: the
    Parquet format, the snappy codec and the CSV parser are the port's
    own."""
    proc = subprocess.run([sys.executable, "-c", _FILE_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_EMBED_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.functions.ai import classify_text, embed_text
df = dt.from_pydict({{"id": list(range(40)), "t": [f"w{{i % 7}} x{{i % 3}}" for i in range(40)]}})
score = dt.func(lambda params, x: x * params["w"].sum(), on_device=True,
                return_dtype=dt.DataType.float32(), device_params=lambda: {{"w": np.array([1.0, 2.0], np.float32)}},
                device_key="isolation_score")
with dt.execution_config_ctx(device="cpu", device_mode="on", device_min_rows=1):
    e = df.select(col("id"), embed_text(col("t"), provider="torch").alias("e")).to_pydict()
    n = (df.select(col("id"), classify_text(col("t"), ["a", "b"], provider="torch").alias("l"))
         .groupby("l").agg(col("id").count().alias("n")).to_pydict())
    s = df.select(score(col("id").cast(dt.DataType.float32())).alias("s")).agg(
        col("s").sum().alias("ss")).to_pydict()
assert len(e["e"]) == 40 and sum(n["n"]) == 40 and s["ss"] == [2340.0], (n, s)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "transformers")
             or m.startswith(("jax.", "pyarrow.", "daft_tpu.", "transformers."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_port_embed_query_imports_no_jax_pyarrow_or_reference():
    """embed, classify -> groupby and a fused device UDF -> sum through the
    device-UDF tier import no JAX, pyarrow, reference (nor transformers: no
    checkpoint is on disk), in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _EMBED_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_device_udf_query_without_card_raises(monkeypatch):
    """An embed query left at the default device raises with no card; under
    device_mode="off" it runs on the CPU."""
    from daft_tpu_torch.functions.ai import embed_text

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = daft_tpu_torch.from_pydict({"t": ["a b", "c"]})
    q = df.select(embed_text(col("t"), provider="torch").alias("e"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.to_pydict()
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        assert len(df.select(embed_text(col("t"), provider="torch").alias("e"))
                   .to_pydict()["e"]) == 2


_PIPELINE_FILE_JOIN_QUERY = """
import os, sys, tempfile, threading
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(0)
fact = dt.from_pydict({{"k": rng.integers(0, 50, 6000), "v": rng.random(6000),
                        "q": rng.integers(0, 9, 6000)}})
dim = dt.from_pydict({{"dk": np.arange(50), "g": np.arange(50) % 4,
                       "name": np.array(["a", "b", "c", "d", "e"], dtype=object)[np.arange(50) % 5]}})
root = tempfile.mkdtemp()
with dt.execution_config_ctx(device="cpu", device_mode="on", pipeline_mode="force",
                             scan_split_bytes=4096, morsel_size_rows=1024):
    for i in range(3):
        fact.write_parquet(os.path.join(root, "fact"))
    dim.write_csv(os.path.join(root, "dim"))
    f = dt.read_parquet(os.path.join(root, "fact"))
    d = dt.read_csv(os.path.join(root, "dim"))
    joined = (f.where(col("q") > 2).join(d, left_on="k", right_on="dk")
              .groupby("name").agg(col("v").sum().alias("s"), col("k").count().alias("n"))
              .sort("name").to_pydict())
    on_device = (f.join(dim, left_on="k", right_on="dk").groupby("g")
                 .agg(col("v").sum().alias("s")).sort("g").to_pydict())
    kept = 3 * sum(1 for q in fact.to_pydict()["q"] if q > 2)
assert joined["name"] == ["a", "b", "c", "d", "e"], joined
assert sum(joined["n"]) == kept, joined
assert on_device["g"] == [0, 1, 2, 3], on_device
assert counters.scan_window_tasks >= 2 and counters.device_grouped_batches >= 1, \\
    counters.snapshot()
assert not [t for t in threading.enumerate() if t.name.startswith("daft-stage")]
assert manager().pinned_count() == 0
import shutil
shutil.rmtree(root)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_pipelined_file_join_imports_no_jax_pyarrow_or_reference():
    """Under pipeline_mode="force": Parquet and CSV scans read in the
    IO-parallel window, a host join (the build-once probe with the filter
    fused) into a grouped aggregate, and a device join into the grouped
    stage, in a fresh interpreter; no stage thread or pin is left."""
    proc = subprocess.run([sys.executable, "-c",
                           _PIPELINE_FILE_JOIN_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


def test_pipelined_failing_kernel_raises_from_collect(monkeypatch):
    """The kernel's error is raised on a stage thread and reaches collect():
    no host result, no fallback."""
    import threading

    def broken(*args, **kwargs):
        raise RuntimeError("segment_sum_planes: CUDA launch failed with error 98")

    monkeypatch.setattr(sk, "segment_sum_planes", broken)
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on",
                                             pipeline_mode="force"):
        df = _small_query(_small_df())
        with pytest.raises(RuntimeError, match="launch failed"):
            df.collect()
    assert df._result is None
    assert counters.snapshot()["device_fallbacks"] == 0
    assert not [t for t in threading.enumerate() if t.name.startswith("daft-stage")]


def test_pipelined_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with daft_tpu_torch.execution_config_ctx(pipeline_mode="force"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _small_query(_small_df()).to_pydict()
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            assert _small_query(_small_df()).to_pydict()["k"] == [0, 1, 2, 3, 4]


_SPILLING_WINDOW_QUERY = """
import os, sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import Window, col
from daft_tpu_torch.functions import row_number
from daft_tpu_torch.memory import manager
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(5)
n = 40_000
df = dt.from_pydict({{"k": rng.integers(0, 300, n), "v": rng.integers(0, 1000, n),
                      "x": rng.standard_normal(n)}})
spill_dir = tempfile.mkdtemp()
w = Window().partition_by("k").order_by("v", "x")
def q():
    return (df.select(col("k"), col("v"), row_number().over(w).alias("rn"),
                      col("v").sum().over(w).alias("rs"))
            .sort(["k", "rn"]).to_pydict())
with dt.execution_config_ctx(device="cpu", pipeline_mode="force"):
    want = q()
    with dt.execution_config_ctx(memory_limit_bytes=100_000, spill_dir=spill_dir):
        got = q()
assert got == want
assert counters.spill_files >= 16 and counters.spill_bytes > 0, counters.snapshot()
assert manager().tracked_bytes() == 0
assert os.listdir(spill_dir) == [], os.listdir(spill_dir)
os.rmdir(spill_dir)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_budgeted_spilling_window_imports_no_jax_pyarrow_or_reference():
    """A window query under a host memory budget that Grace-partitions it
    into spill files (the window, then the external sort), in a fresh
    interpreter: the same rows as unbudgeted, the ledger back at 0, the
    spill directory empty, and no JAX, pyarrow or daft_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", _SPILLING_WINDOW_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_OBSERVED_QUERY = """
import json, os, sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
import daft_tpu_torch.observability as obs
import daft_tpu_torch.observability.dashboard
import daft_tpu_torch.observability.event_log
import daft_tpu_torch.observability.flight
import daft_tpu_torch.observability.otlp
import daft_tpu_torch.observability.progress
import daft_tpu_torch.runners
from daft_tpu_torch.distributed.trace import QueryTrace
from daft_tpu_torch import col
seen = []
class Rec(obs.Subscriber):
    def on_query_start(self, e): seen.append("start")
    def on_query_optimized(self, e): seen.append("optimized")
    def on_operator_stats(self, q, s): seen.append("op")
    def on_query_end(self, e): seen.append(("end", e.metrics.get("device_grouped_batches")))
rng = np.random.default_rng(0)
df = dt.from_pydict({{"k": rng.integers(0, 8, 5000), "v": rng.uniform(0, 1, 5000)}})
dash = daft_tpu_torch.observability.dashboard.launch()
sub = Rec()
obs.attach_subscriber(sub)
path = os.path.join(tempfile.mkdtemp(), "trace.json")
try:
    with dt.execution_config_ctx(device="cpu", device_mode="on", pipeline_mode="force"):
        out = df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
        report = df.groupby("k").agg(col("v").sum().alias("s")).explain_analyze(profile=path)
finally:
    obs.detach_subscriber(sub)
    dash.shutdown()
assert out["k"] == list(range(8)), out
assert seen[:2] == ["start", "optimized"] and seen[-1] == ("end", 1), seen
names = {{e["name"] for e in json.load(open(path))["traceEvents"] if e["ph"] == "X"}}
assert {{"device.h2d", "device.dispatch", "device.d2h"}} <= names, names
assert "== Engine Counters ==" in report
os.remove(path)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_observed_query_imports_no_jax_pyarrow_or_reference():
    """The observability package (the dashboard and the OTLP exporter
    included), the runners and the query trace loaded, a subscriber, the
    dashboard and explain_analyze(profile=...) observing a device_mode="on"
    query on the CPU, in a fresh interpreter: no JAX, pyarrow or daft_tpu
    imported."""
    proc = subprocess.run([sys.executable, "-c", _OBSERVED_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_SURFACE_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
rng = np.random.default_rng(0)
df = dt.from_pydict({{"k": rng.integers(0, 6, 4000), "x": rng.normal(0, 5, 4000),
                      "s": np.array(["ab", "Cd", "éf"], dtype=object)[rng.integers(0, 3, 4000)]}})
def q(frame):
    return (frame.where(col("k").is_in([1, 2, 4]) & ((col("x") - 1).abs() < 6))
            .groupby("k").agg(col("x").abs().sqrt().sum().alias("r"),
                              col("x").stddev().alias("sd"))
            .concat(frame.where(col("k") == 5).groupby("k")
                    .agg(col("x").round(1).sum().alias("r"), col("x").var().alias("sd")))
            .sort("k"))
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = q(df).to_pydict()
    up = df.select(col("s").str.upper().alias("u"), col("s").str.length().alias("n"))
    assert set(up.to_pydict()["u"]) == {{"AB", "CD", "ÉF"}}
    sql = dt.sql("SELECT k, ABS(x) % 2 AS m FROM t WHERE k IN (1, 3) UNION ALL "
                 "SELECT k, x FROM t WHERE k = 0 ORDER BY k, m LIMIT 5", t=df).to_pydict()
with dt.execution_config_ctx(device="cpu", device_mode="off"):
    host = q(df).to_pydict()
assert out["k"] == host["k"] == [1, 2, 4, 5], out
assert np.allclose(out["r"], host["r"], rtol=1e-5) and np.allclose(out["sd"], host["sd"])
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_expression_surface_query_imports_no_jax_pyarrow_or_reference():
    """A query with registry functions (sqrt, round, upper, length),
    ``abs``, ``%``, ``is_in``, the new aggregates and ``concat`` (and in
    SQL, ABS, % and UNION ALL), on the device stage and on the host, in a
    fresh interpreter: equal, and no JAX, pyarrow or daft_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", _SURFACE_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_NATIVE_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col, native
from daft_tpu_torch.ops import _build
rng = np.random.default_rng(5)
fact = dt.from_pydict({{"k": rng.integers(0, 50, 5000), "v": rng.standard_normal(5000)}})
dim = dt.from_pydict({{"k": np.arange(50) * 1_000_003, "w": np.arange(50)}})
with dt.execution_config_ctx(device="cpu", device_mode="off"):
    g = fact.where(col("v") > 0).groupby("k").agg(col("v").sum().alias("s")).sort("k")
    j = fact.with_column("k", col("k") * 1_000_003).join(dim, on="k").groupby("w").agg(
        col("v").max().alias("m")).sort("w")
    assert len(g.to_pydict()["k"]) == 50 and len(j.to_pydict()["w"]) == 50
used = native.calls()
for name in ("factorize_i64", "grouped_sum_f64", "grouped_minmax_f64", "i64_pairmap_build",
             "probe_unique_pair"):
    assert used.get(name), (name, used)
maps = [line.split()[-1] for line in open("/proc/self/maps") if line.rstrip().endswith(".so")]
mine = [m for m in maps if "libkernels_host_" in m]
assert mine and all(m.startswith(_build.BUILD_DIR + "/") for m in mine), mine
assert _build.BUILD_DIR.endswith("daft_tpu_torch/ops/_kbuild"), _build.BUILD_DIR
assert not [m for m in maps if "libdaft_native" in m], maps
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_host_kernel_library_is_the_ports_own_build():
    """Host queries through the host kernel library, in a fresh interpreter:
    the library mapped is the port's build under daft_tpu_torch/ops/_kbuild/
    (never the reference's ``libdaft_native.so``), its exports are called,
    and no JAX, pyarrow or daft_tpu is imported."""
    proc = subprocess.run([sys.executable, "-c", _NATIVE_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_TEMPORAL_QUERY = """
import datetime, os, sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col, lit
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(22)
n = 3000
day = 86_400_000_000
ship = rng.integers(9000, 9800, n) * day + rng.integers(0, day, n)
df = dt.from_pydict({{
    "f": np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)],
    "p": rng.uniform(1, 100, n),
    "ship": ship.astype("datetime64[us]"),
    "rec": (ship + rng.integers(1, 30, n) * day).astype("datetime64[us]")}})
transit = col("rec") - col("ship")
def t1(frame):
    return (frame.where((col("ship") >= lit(datetime.datetime(1995, 1, 1, 6, 30)))
                        & (transit > lit(datetime.timedelta(days=5))))
            .groupby("f").agg(col("p").count().alias("n"), col("ship").min().alias("a"),
                              transit.max().alias("t")).sort("f"))
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    out = t1(df).to_pydict()
    assert counters.device_grouped_batches == 1, counters.snapshot()
    sql = dt.sql("SELECT f, COUNT(*) AS n, MIN(ship) AS a, MAX(rec - ship) AS t FROM t "
                 "WHERE ship >= TIMESTAMP '1995-01-01 06:30:00' AND rec - ship > "
                 "INTERVAL '5' DAY GROUP BY f ORDER BY f", t=df).to_pydict()
    assert sql == out, (sql, out)
with dt.execution_config_ctx(device="cpu", device_mode="off"):
    zoned = df.select(col("ship")._fn("replace_time_zone", tz="UTC")._fn(
        "convert_time_zone", tz="America/New_York").dt.hour().alias("h"),
        col("ship").dt.truncate("1 day").alias("d"), transit.total_hours().alias("th"))
    assert len(zoned.to_pydict()["h"]) == n
    d = tempfile.mkdtemp()
    df.write_parquet(d)
    assert t1(dt.read_parquet(d)).to_pydict() == out
    df.write_csv(d + "_csv")
    assert len(dt.read_csv(d + "_csv").to_pydict()["ship"]) == n
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_temporal_query_imports_no_jax_pyarrow_or_reference():
    """Timestamps end to end in a fresh interpreter: T1 on the device stage
    (as a DataFrame and in SQL), the zone functions, truncation and
    duration totals on the host, and a Parquet and a CSV round trip of
    timestamp columns: no JAX, pyarrow, pandas or daft_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", _TEMPORAL_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_NESTED_QUERY = """
import sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(23)
n = 3000
df = dt.from_pydict({{"o": np.sort(rng.integers(0, 500, n)), "s": rng.integers(0, 20, n),
                      "p": rng.uniform(1, 100, n),
                      "m": np.array(["AIR", "RAIL", "SHIP"], dtype=object)[rng.integers(0, 3, n)]}})
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    lists = df.groupby("o").agg(col("s").agg_list(), col("p").agg_list(),
                                col("m").agg_set().alias("ms")).collect()
    out = lists.explode("s", "p").groupby("s").agg(col("p").sum().alias("r"),
                                                   col("o").count().alias("c")).sort("s")
    got = out.to_pydict()
    assert counters.device_grouped_batches >= 1, counters.snapshot()
    j = lists.select(col("ms")._fn("to_json").alias("j")).to_pydict()["j"]
    assert all(x.startswith("[") for x in j)
    d = tempfile.mkdtemp()
    lists.write_parquet(d)
    back = dt.read_parquet(d).sort("o").to_pydict()
    assert back == lists.sort("o").to_pydict()
    assert sum(got["c"]) == n
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_nested_query_imports_no_jax_pyarrow_or_reference():
    """agg_list and agg_set, explode into a device grouped stage, to_json and
    a nested Parquet round trip in a fresh interpreter: no JAX, pyarrow,
    pandas or daft_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", _NESTED_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_MULTIMODAL_QUERY = """
import os, sys, tempfile
import numpy as np
sys.path.insert(0, {repo!r})
import torch
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.core.kernels import png
from daft_tpu_torch.ops import counters
rng = np.random.default_rng(24)
d = tempfile.mkdtemp()
for i in range(24):
    h, w, c = int(rng.integers(20, 60)), int(rng.integers(20, 60)), (3, 1, 4)[i % 3]
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    with open(os.path.join(d, f"{{i:02d}}.png"), "wb") as f:
        f.write(png.encode_png(img) if i != 5 else b"no image")
w = rng.standard_normal((3, 4)).astype(np.float32)
emb = dt.func(lambda p, x: x.to(torch.float32).mean(dim=(1, 2)) @ p["w"], on_device=True,
              return_dtype=dt.DataType.embedding(dt.DataType.float32(), 4),
              device_params=lambda: {{"w": w}}, device_key="isolation_mm:v1")
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    df = dt.from_glob_path(os.path.join(d, "*.png"))
    df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
    df = df.with_column("e", emb(col("img").image.to_fixed_shape("RGB", 16, 16)))
    df = df.with_column("dist", col("e").embedding.cosine_distance(dt.lit(np.ones(4))))
    out = df.groupby(col("img").image_channel().alias("c")).agg(
        col("dist").sum().alias("s"), col("dist").count().alias("n")).sort("c").to_pydict()
    assert counters.device_grouped_batches >= 1 and counters.device_udf_dispatches >= 1
    assert sum(out["n"]) == 23, out
    docs = dt.from_pydict({{"t": ["a b c d", "a b c e", None]}})
    sig = docs.select(col("t").minhash(num_hashes=8, ngram_size=2).alias("m")).to_pydict()
    assert sig["m"][2] is None and len(sig["m"][0]) == 8
    n = docs.agg(col("t").approx_count_distinct().alias("n")).to_pydict()
    assert n["n"] == [2], n
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas", "PIL", "cv2", "tokenizers", "soundfile", "av")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu.", "PIL.", "cv2.",
                              "tokenizers.", "soundfile.", "av."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_multimodal_query_imports_no_jax_pyarrow_or_reference():
    """A small M1 chain (files, decode, fixed shape, a device UDF, distances,
    a grouped device stage) and a minhash query in a fresh interpreter: no
    JAX, pyarrow, pandas, daft_tpu, PIL, cv2, tokenizers, soundfile or av
    imported."""
    proc = subprocess.run([sys.executable, "-c", _MULTIMODAL_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_INGEST_QUERY = """
import gzip, json, os, sys, tempfile
sys.path.insert(0, {repo!r})
import numpy as np
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.core.kernels import jpeg
from daft_tpu_torch.ops import counters
d = tempfile.mkdtemp()
rng = np.random.default_rng(3)
rows = []
for i in range(12):
    px = rng.integers(0, 256, (9 + i, 14, 3), dtype=np.uint8)
    data = jpeg.encode_jpeg(px)
    assert jpeg.decode_jpeg(data).pixels.shape == (9 + i, 14, 3)
    p = os.path.join(d, f"{{i}}.jpg")
    open(p, "wb").write(data)
    rows.append({{"path": p, "label": i % 3}})
os.makedirs(os.path.join(d, "m"))
with open(os.path.join(d, "m", "a.jsonl"), "w") as f:
    f.writelines(json.dumps(r) + "\\n" for r in rows)
tok = os.path.join({repo!r}, "tests", "data", "w1_tokenizer.json")
with open(os.path.join(d, "a.warc.gz"), "wb") as f:
    for i in range(6):
        body = ("t\u00e9xt %d \u4e2d " % i).encode() * 5
        f.write(gzip.compress(b"WARC/1.0\\r\\nWARC-Type: response\\r\\nWARC-Target-URI: http://h%d/\\r\\n"
                              b"Content-Length: %d\\r\\n\\r\\n" % (i % 2, len(body)) + body + b"\\r\\n\\r\\n"))
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    df = dt.read_json(os.path.join(d, "m"))
    df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
    df = df.with_column("w", col("img").image_width().cast(dt.DataType.int64()))
    out = df.groupby("label").agg(col("w").sum().alias("s")).sort("label").to_pydict()
    assert out["s"] == [56, 56, 56], out
    assert counters.device_grouped_batches >= 1
    w = dt.read_warc(os.path.join(d, "a.warc.gz")).with_column(
        "n", col("content").tokenize_encode(tok).list.length().cast(dt.DataType.int64()))
    out = w.groupby("warc_target_uri").agg(col("n").sum()).to_pydict()
    assert sum(out["n"]) > 0, out
    dt.read_json(os.path.join(d, "m")).write_json(os.path.join(d, "o"))
    assert dt.read_text(os.path.join(d, "m", "a.jsonl")).count_rows() == 12
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas", "PIL", "cv2", "tokenizers", "regex")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu.", "PIL.", "cv2.",
                              "tokenizers.", "regex."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_ingest_query_imports_no_jax_pyarrow_pil_tokenizers_or_reference():
    """JPEG encode and decode, a BPE file's encode, JSON, text and WARC
    scans into the device stage and a JSON write in a fresh interpreter: no
    JAX, pyarrow, pandas, daft_tpu, PIL, cv2, tokenizers or regex
    imported."""
    proc = subprocess.run([sys.executable, "-c", _INGEST_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_SERVE_QUERY = """
import os, sys, tempfile
sys.path.insert(0, {repo!r})
import numpy as np
import daft_tpu_torch as dt
from daft_tpu_torch import cli, col
from daft_tpu_torch.checkpoint import MemoryCheckpointStore
from daft_tpu_torch.checkpoint.stages import StageCheckpointer
from daft_tpu_torch.gateway import GatewayClient, GatewayServer
from daft_tpu_torch.io import arrow_ipc
from daft_tpu_torch.serving import ServingSession
os.environ["DAFT_TPU_CHECKPOINT_DIR"] = tempfile.mkdtemp()
df = dt.from_pydict({{"k": np.arange(5000) % 7, "v": np.arange(5000) * 0.5,
                      "s": np.array(["x%d" % (i % 3) for i in range(5000)], dtype=object)}})
sql = "SELECT s, k, SUM(v) AS t FROM t GROUP BY s, k ORDER BY s, k"
with dt.execution_config_ctx(device="cpu", device_mode="on", device_min_rows=1):
    want = dt.sql(sql, t=df).to_pydict()
    with GatewayServer(tables={{"t": df}}) as srv, \\
            GatewayClient(srv.host, srv.port, tenant="iso", timeout=60) as c:
        assert c.query(sql) == want and c.last_source == "executed"
        assert c.query(sql) == want and c.last_source == "result_cache"
    with GatewayServer(tables={{"t": df}}) as srv, \\
            GatewayClient(srv.host, srv.port, tenant="iso", timeout=60) as c:
        assert c.query(sql) == want and c.last_source == "checkpoint"
    with ServingSession(max_concurrent=2) as sess:
        assert sess.submit(dt.sql(sql, t=df)).to_pydict(timeout=60) == want
    part = dt.sql(sql, t=df).collect()._result[0]
    data = arrow_ipc.encode_stream(part.batches, part.schema, "lz4")
    assert arrow_ipc.decode_stream(data)[0].to_pydict() == want
    assert cli.main(["info", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow", "pandas")
             or m.startswith(("jax.", "pyarrow.", "pandas.", "daft_tpu."))
             or m == "daft_tpu")
print("FORBIDDEN", bad)
"""


def test_serving_tier_imports_no_jax_pyarrow_or_reference():
    """A query served over a loopback gateway (executed, from the result
    cache, from a stage checkpoint), a ServingSession query, an LZ4 IPC
    stream and the CLI in a fresh interpreter: no JAX, pyarrow, pandas or
    daft_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", _SERVE_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_DIST_QUERY = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
import daft_tpu_torch.runners as runners
from daft_tpu_torch import col
from daft_tpu_torch.core.micropartition import MicroPartition
from daft_tpu_torch.distributed import DistributedRunner, SubPlanTask, WorkerAffinity
from daft_tpu_torch.plan import physical as pp

FORBIDDEN = ("jax", "pyarrow", "pandas", "daft_tpu")


def forbidden():
    return sorted(m for m in sys.modules
                  if m in FORBIDDEN or m.startswith(tuple(f + "." for f in FORBIDDEN)))


class ModulesTask:
    filters_applied = True
    size_bytes = None
    source_label = "modules"

    def read(self):
        import os
        yield MicroPartition.from_pydict({{"pid": [os.getpid()],
                                           "bad": [",".join(forbidden())]}})


df = dt.from_pydict({{"k": np.arange(20_000) % 9, "v": np.arange(20_000, dtype=np.float64)}})
q = lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")
with dt.execution_config_ctx(device="cpu", device_mode="on"):
    want = q().to_pydict()
    r = DistributedRunner(num_workers=2, n_partitions=2, device_workers=2,
                          shuffle_transport="socket")
    try:
        runners.set_runner(r)
        assert q().to_pydict() == want
        runners.set_runner(None)
        with dt.serving_session(max_concurrent=2, runner=r) as sess:
            assert sess.submit(q(), tenant="a").to_pydict() == want
        schema = MicroPartition.from_pydict({{"pid": [0], "bad": [""]}}).schema
        plan = pp.StreamingScan([ModulesTask()], schema, None, None)
        tasks = [SubPlanTask.from_plan(f"mods-{{w}}", plan, strategy=WorkerAffinity(w, hard=True))
                 for w in sorted(r._pool.workers)]
        res = r._pool.run_tasks(tasks)
        rows = [p.to_pydict() for t in res.values() for p in t.partitions]
        assert len({{row["pid"][0] for row in rows}}) == 2, rows
        print("WORKERS", [row["bad"][0] for row in rows])
    finally:
        r.shutdown()
print("FORBIDDEN", forbidden())
"""


def test_distributed_workers_import_no_jax_pyarrow_or_reference():
    """A DistributedRunner's coordinator and both of its leased worker processes,
    after a grouped query, a socket shuffle and a served query: no JAX,
    pyarrow, pandas or daft_tpu in either."""
    proc = subprocess.run([sys.executable, "-c", _DIST_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "WORKERS ['', '']" in proc.stdout, proc.stdout
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
