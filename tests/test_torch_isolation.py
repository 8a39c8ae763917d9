"""The port stands alone and never hides a device failure:

- a port query, the grouped one, the TPC-H q12 and q14 star joins, a fused
  region over a semi join, the mesh repartition, TPC-H q12 in SQL
  (``daft_tpu_torch.sql``), a query that writes and reads Parquet and
  CSV files, and embed, classify and a fused device UDF on the device-UDF
  tier alike, imports neither
  JAX, nor pyarrow, nor anything of
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
  and a device query without a card still raises.
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
bad = sorted(m for m in sys.modules
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
             if m in ("jax", "pyarrow") or m.startswith(("jax.", "pyarrow.", "daft_tpu."))
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
