"""The port's Parquet reader and writer (daft_tpu_torch/io/_parquet_format.py,
io/parquet.py, io/writers.py) against the reference's (daft_tpu/io/, which
reads and writes through pyarrow).

Files come from the reference's ``write_parquet`` and from pyarrow with
each codec the port supports and data page v1 and v2: nulls, every mapped
type, several row groups, several pages a chunk, and a string column whose
dictionary passes 1 MiB, so its chunks fall back from RLE_DICTIONARY to
PLAIN. The port's read must give the reference's values and validity bit
for bit, and the reference must read the port's files back to the source.
Zone-map pruning and the row-group split must give the reference's tasks.
Unsupported codecs, types and encodings raise NotImplementedError.
"""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.io.parquet import ParquetScanOperator as RefScan
from daft_tpu.io.scan import Pushdowns as RefPushdowns
from daft_tpu_torch.io import _parquet_format as pf
from daft_tpu_torch.io.parquet import ParquetScanOperator as PortScan
from daft_tpu_torch.io.scan import Pushdowns as PortPushdowns

N = 100_000
ROW_GROUP = 40_000


def _arrow_table(n: int = N, seed: int = 0) -> pa.Table:
    """Every type the port maps, with nulls; ``comment`` is 40-odd bytes of
    distinct text a row, so a 40,000-row chunk's dictionary passes 1 MiB."""
    rng = np.random.default_rng(seed)
    holes = rng.random(n) < 0.1

    def nullable(values, typ):
        return pa.array(values, typ, mask=holes if len(values) == n else None)

    start = datetime.date(1992, 1, 1)
    return pa.table({
        "b": nullable(rng.random(n) < 0.5, pa.bool_()),
        "i8": nullable(rng.integers(-128, 128, n).astype(np.int8), pa.int8()),
        "i16": pa.array(rng.integers(-30000, 30000, n).astype(np.int16), pa.int16()),
        "i32": nullable(rng.integers(-2**31, 2**31, n).astype(np.int32), pa.int32()),
        "i64": nullable(rng.integers(-2**62, 2**62, n), pa.int64()),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8), pa.uint8()),
        "u32": nullable(rng.integers(0, 2**32, n).astype(np.uint32), pa.uint32()),
        "f32": nullable(rng.standard_normal(n).astype(np.float32), pa.float32()),
        "f64": nullable(np.where(rng.random(n) < 0.01, np.nan, rng.standard_normal(n)),
                        pa.float64()),
        "d": nullable([start + datetime.timedelta(days=int(x))
                       for x in rng.integers(0, 2500, n)], pa.date32()),
        "mode": nullable(np.array(["AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "é-FOB"],
                                  dtype=object)[rng.integers(0, 6, n)].tolist(), pa.string()),
        "comment": nullable([f"comment {i:08d} {'xyz' * (i % 7)} ünïcode"
                             for i in range(n)], pa.string()),
        "one": pa.array(["same"] * n, pa.string()),
        "allnull": pa.array([None] * n, pa.int64()),
    })


WRITERS = {
    "reference": None,
    "snappy_v1": dict(compression="snappy"),
    "gzip_v1": dict(compression="gzip"),
    "none_v2": dict(compression="none", data_page_version="2.0"),
    "snappy_v2": dict(compression="snappy", data_page_version="2.0"),
    "plain_v1": dict(compression="snappy", use_dictionary=False),
    "small_pages": dict(compression="gzip", data_page_size=4096, data_page_version="2.0"),
}


@pytest.fixture(scope="module")
def table():
    return _arrow_table()


@pytest.fixture(scope="module")
def written(table, tmp_path_factory):
    """{writer: directory of its file(s)}."""
    root = tmp_path_factory.mktemp("parquet")
    out = {}
    for name, kw in WRITERS.items():
        d = root / name
        d.mkdir()
        if kw is None:
            with ref_ctx(device_mode="off"):
                daft_tpu.from_arrow(table).write_parquet(str(d))
        else:
            pq.write_table(table, str(d / "part.parquet"), row_group_size=ROW_GROUP, **kw)
        out[name] = str(d)
    return out


def _ref_planes(df):
    """{column: (dtype kind, values, validity)} of a reference read."""
    batches = [b for p in df.collect()._result for b in p.batches]
    cols = {}
    for name in df.column_names:
        parts = [b.get_column(name) for b in batches]
        cols[name] = (parts[0].dtype.kind if parts else None,
                      np.concatenate([s.to_numpy() for s in parts]),
                      np.concatenate([s.validity_numpy() for s in parts]))
    return cols


def _port_planes(df):
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        parts = df.collect()._result
    batches = [b for p in parts for b in p.batches]
    out = {}
    for name in df.column_names:
        ss = [b.get_column(name) for b in batches]
        out[name] = (ss[0].dtype.kind, np.concatenate([s.to_numpy() for s in ss]),
                     np.concatenate([s.validity_numpy() for s in ss]))
    return out


def _bits(values: np.ndarray):
    if values.dtype == object:
        return values.tolist()
    return values.view(f"u{values.itemsize}").tolist() if values.dtype.kind == "f" \
        else values.tolist()


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_port_read_equals_reference_read_bit_for_bit(written, writer):
    want = _ref_planes(daft_tpu.read_parquet(written[writer]))
    got = _port_planes(daft_tpu_torch.read_parquet(written[writer]))
    assert list(got) == list(want)
    for name in want:
        (wk, wv, wm), (gk, gv, gm) = want[name], got[name]
        assert gk == wk, name
        assert np.array_equal(gm, wm), name
        assert _bits(gv) == _bits(wv), name


def test_files_cover_what_they_claim(written):
    """The fixture's files hold several row groups and pages, nulls, a
    dictionary that falls back to PLAIN, and data page v2 where asked."""
    md = pq.ParquetFile(os.path.join(written["snappy_v1"], "part.parquet")).metadata
    assert md.num_row_groups == 3
    comment = md.row_group(0).column(list(md.schema.names).index("comment"))
    assert {"PLAIN", "RLE_DICTIONARY"} <= set(comment.encodings)
    footer = pf.read_footer(os.path.join(written["snappy_v2"], "part.parquet"))
    with open(os.path.join(written["snappy_v2"], "part.parquet"), "rb") as f:
        md0 = footer.chunk(footer.row_groups[0], "f64")
        f.seek(md0.get("dictionary_page_offset") or md0["data_page_offset"])
        from daft_tpu_torch.io import _thrift as th

        raw = f.read(md0["total_compressed_size"])
        kinds = set()
        pos = 0
        while pos < len(raw):
            h, pos = th.read_struct(raw, pos)
            ph = th.decode(th.PAGE_HEADER, h)
            kinds.add(ph["type"])
            pos += ph["compressed_page_size"]
    assert pf.DATA_PAGE_V2 in kinds


def test_reference_reads_the_ports_files(table, tmp_path):
    src = _port_planes(daft_tpu_torch.read_parquet(_write_ref_file(table, tmp_path)))
    df = daft_tpu_torch.DataFrame(_in_memory(src))
    for compression in ("snappy", "gzip", "none"):
        out = tmp_path / f"port_{compression}"
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            paths = df.write_parquet(str(out), compression=compression).to_pydict()["path"]
        assert len(paths) == 1 and paths[0].endswith(".parquet")
        back = _ref_planes(daft_tpu.read_parquet(str(out)))
        for name, (kind, values, valid) in src.items():
            assert back[name][0] == kind, name
            assert np.array_equal(back[name][2], valid), name
            assert _bits(back[name][1]) == _bits(values), name
        # the writer's files: 1 Mi-row groups, statistics on every chunk
        md = pq.ParquetFile(paths[0]).metadata
        assert md.num_row_groups == 1 and md.num_rows == N
        stats = md.row_group(0).column(list(md.schema.names).index("i64")).statistics
        assert stats.has_min_max and stats.null_count == int((~src["i64"][2]).sum())


def _write_ref_file(table, tmp_path) -> str:
    path = tmp_path / "src.parquet"
    pq.write_table(table, str(path), row_group_size=ROW_GROUP)
    return str(path)


def _in_memory(planes):
    from daft_tpu_torch.interop import from_numpy_columns
    from daft_tpu_torch.plan import logical as lp

    schema = daft_tpu_torch.Schema.from_pydict(
        {n: daft_tpu_torch.DataType(k) for n, (k, _v, _m) in planes.items()})
    df = from_numpy_columns({n: (v, m) for n, (_k, v, m) in planes.items()}, schema)
    return lp.InMemorySource(df.schema, df._plan.partitions)


def test_port_files_round_trip_through_the_port(tmp_path):
    """Strings dictionary-encoded (and PLAIN past a 1 MiB dictionary), all
    kinds with nulls, several row groups: the port reads its own files
    back to the source."""
    table = _arrow_table(n=5000, seed=3)
    src = _port_planes(daft_tpu_torch.read_parquet(_write_ref_file(table, tmp_path)))
    df = daft_tpu_torch.DataFrame(_in_memory(src))
    out = tmp_path / "rt"
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        df.write_parquet(str(out))
    back = _port_planes(daft_tpu_torch.read_parquet(str(out)))
    for name, (kind, values, valid) in src.items():
        assert back[name][0] == kind and np.array_equal(back[name][2], valid), name
        assert _bits(back[name][1]) == _bits(values), name


def test_dictionary_limit_falls_back_to_plain(tmp_path, monkeypatch):
    monkeypatch.setattr(pf, "ROW_GROUP_ROWS", 1000)
    words = [f"w{i:06d}" * 3 for i in range(3000)]
    df = daft_tpu_torch.from_pydict({"w": words, "few": [w[:2] for w in words]})
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        path = df.write_parquet(str(tmp_path / "d")).to_pydict()["path"][0]
    monkeypatch.setattr(pf, "DICTIONARY_LIMIT_BYTES", 1000)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        path2 = df.write_parquet(str(tmp_path / "p")).to_pydict()["path"][0]
    for p, dict_w in ((path, True), (path2, False)):
        md = pq.ParquetFile(p).metadata
        assert md.num_row_groups == 3
        enc = set(md.row_group(0).column(0).encodings)
        assert ("RLE_DICTIONARY" in enc) == dict_w, enc
        assert pq.read_table(p).column("w").to_pylist() == words


# ---- zone maps and the split ---------------------------------------------------------


@pytest.fixture(scope="module")
def sorted_files(tmp_path_factory):
    """Three files of a date-sorted table, 8 row groups each; the third
    file's dates lie past every other's."""
    root = tmp_path_factory.mktemp("zones")
    rng = np.random.default_rng(5)
    n = 8000
    for i in range(3):
        days = np.sort(rng.integers(0, 3000, n)) + (5000 if i == 2 else 0)
        t = pa.table({"d": pa.array(days.astype(np.int32)).cast(pa.date32()),
                      "k": pa.array(np.arange(n) + i * n),
                      "x": pa.array(np.where(rng.random(n) < 0.5, np.nan, rng.random(n))),
                      "s": pa.array([f"s{j // 1000}" for j in range(n)])})
        pq.write_table(t, str(root / f"part-{i}.parquet"), row_group_size=1000)
    return str(root)


def _predicates(dt):
    col, lit = dt.col, dt.lit
    base = datetime.date(1970, 1, 1)
    return {
        "date_range": (col("d") >= lit(base + datetime.timedelta(days=700)))
        & (col("d") < lit(base + datetime.timedelta(days=1200))),
        "late": col("d") > lit(base + datetime.timedelta(days=6000)),
        "flipped": lit(base + datetime.timedelta(days=100)) > col("d"),
        "between": col("k").between(2500, 3100),
        "eq_string": col("s") == "s3",
        "float_nan": col("x") > 2.0,
        "or": (col("k") < 10) | (col("k") > 23990),
        "non_arrow": col("s").str.startswith("s1"),
    }


def _task_view(tasks):
    return [(t.source_label.split(os.sep)[-1], t.size_bytes, t.num_rows, t.filters_applied,
             t.limit_applied) for t in tasks]


@pytest.mark.parametrize("case", sorted(_predicates(daft_tpu)))
@pytest.mark.parametrize("split", ["whole", "bytes", "row_groups"])
def test_zone_maps_and_split_give_the_reference_tasks(sorted_files, case, split):
    from daft_tpu_torch.ops import counters

    kw = {"row_groups_per_task": 3} if split == "row_groups" else {}
    cfg = {"scan_split_bytes": 20_000} if split == "bytes" else {}
    views = []
    for dt, scan, push, ctx in ((daft_tpu, RefScan, RefPushdowns, ref_ctx),
                                (daft_tpu_torch, PortScan, PortPushdowns,
                                 daft_tpu_torch.execution_config_ctx)):
        with ctx(**cfg):
            op = scan(sorted_files, **kw)
            views.append(_task_view(op.to_scan_tasks(push(filters=_predicates(dt)[case]))))
    assert views[1] == views[0]
    # every task reads the rows it claims, and the predicate keeps the
    # reference's rows
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", **cfg):
        got = daft_tpu_torch.read_parquet(sorted_files, **kw).where(
            _predicates(daft_tpu_torch)[case]).select("k").to_pydict()
    with ref_ctx(device_mode="off", **cfg):
        want = daft_tpu.read_parquet(sorted_files, **kw).where(
            _predicates(daft_tpu)[case]).select("k").to_pydict()
    assert got == want


def test_zone_maps_prune_files_and_row_groups(sorted_files):
    from daft_tpu_torch.ops import counters

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.read_parquet(sorted_files).where(
            _predicates(daft_tpu_torch)["date_range"]).select("k").to_pydict()
    # the late file pruned whole; in the others only the row groups whose
    # date range meets [700, 1200) are read
    assert counters.scan_files_pruned == 1
    assert counters.scan_row_groups_pruned >= 10
    assert len(got["k"]) > 0


def test_limit_pushdown_reads_few_rows(sorted_files):
    from daft_tpu_torch.ops import counters

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", morsel_size_rows=500):
        got = daft_tpu_torch.read_parquet(sorted_files).limit(1200).select(
            "d", "k", "s").to_pydict()
    with ref_ctx(device_mode="off", morsel_size_rows=500):
        want = daft_tpu.read_parquet(sorted_files).limit(1200).select(
            "d", "k", "s").to_pydict()
    assert got == want
    assert counters.scan_rows == 1200 and counters.scan_batches == 3


# ---- refusals ------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["zstd", "lz4", "brotli"])
def test_unsupported_codec_raises_naming_it(tmp_path, codec):
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"a": list(range(100))}), path, compression=codec)
    with pytest.raises(NotImplementedError, match={"lz4": "LZ4"}.get(codec, codec.upper())):
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            daft_tpu_torch.read_parquet(path).to_pydict()


UNSUPPORTED = {
    "decimal": (pa.table({"a": pa.array([1, 2], pa.decimal128(10, 2))}), {}, "DECIMAL"),
    # timestamps and times read since the temporal slice (tests/test_torch_temporal.py)
    # binary, fixed-size binary, lists and structs read since the nested
    # slice (tests/test_torch_parquet_nested.py)
    "float16": (pa.table({"a": pa.array(np.array([1, 2], dtype=np.float16))}), {},
                "FLOAT16"),
    "decimal_in_list": (pa.table({"a": pa.array([[1], [2, 3]], pa.list_(pa.decimal128(10, 2)))}),
                        {}, "DECIMAL"),
    "delta_length": (pa.table({"a": pa.array(["x", "yy"])}),
                     dict(use_dictionary=False,
                          column_encoding={"a": "DELTA_LENGTH_BYTE_ARRAY"}),
                     "DELTA_LENGTH_BYTE_ARRAY"),
    "delta_byte_array": (pa.table({"a": pa.array(["x", "xy"])}),
                         dict(use_dictionary=False, column_encoding={"a": "DELTA_BYTE_ARRAY"}),
                         "DELTA_BYTE_ARRAY"),
    "delta": (pa.table({"a": pa.array([1, 2, 3])}),
              dict(use_dictionary=False, column_encoding={"a": "DELTA_BINARY_PACKED"}),
              "DELTA_BINARY_PACKED"),
    "byte_stream_split": (pa.table({"a": pa.array([1.0, 2.0])}),
                          dict(use_dictionary=False,
                               column_encoding={"a": "BYTE_STREAM_SPLIT"}),
                          "BYTE_STREAM_SPLIT"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_type_or_encoding_raises_naming_it(tmp_path, case):
    table, kw, word = UNSUPPORTED[case]
    path = str(tmp_path / "u.parquet")
    pq.write_table(table, path, **kw)
    with pytest.raises(NotImplementedError, match=word):
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            daft_tpu_torch.read_parquet(path).to_pydict()


def test_writer_refuses_a_null_column(tmp_path):
    df = daft_tpu_torch.from_pydict({"a": [None, None]})
    with pytest.raises(NotImplementedError, match="Null"):
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            df.write_parquet(str(tmp_path / "n"))


# ---- the RLE / bit-packed hybrid -----------------------------------------------------


def test_hybrid_bit_width_zero_and_padded_runs():
    # bit width 0: every value 0, whatever the runs say
    assert pf.decode_hybrid(b"\x0a", 0, 1, 0, 5).tolist() == [0] * 5
    # one bit-packed group of 8 at width 3 (values 0..7), of which 5 are asked
    packed = pf.encode_hybrid(np.arange(8), 3)
    assert pf.decode_hybrid(packed, 0, len(packed), 3, 5).tolist() == [0, 1, 2, 3, 4]
    # 11 values pad to 16: no value past the 11th comes back
    vals = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1])
    enc = pf.encode_hybrid(vals, 1)
    assert pf.decode_hybrid(enc, 0, len(enc), 1, 11).tolist() == vals.tolist()
    # an RLE run then a bit-packed run
    run = b"\x0c\x05" + pf.encode_hybrid(np.array([1, 2, 3, 4, 5, 6, 7, 0]), 3)
    assert pf.decode_hybrid(run, 0, len(run), 3, 14).tolist() == \
        [5] * 6 + [1, 2, 3, 4, 5, 6, 7, 0]
    with pytest.raises(ValueError):
        pf.decode_hybrid(b"\x0c\x05", 0, 2, 3, 7)


def test_unknown_thrift_fields_are_skipped_by_type():
    from daft_tpu_torch.io import _thrift as th

    spec = [(1, "a", "i32", None), (3, "c", "string", None)]
    extra = [(1, "a", "i32", None), (2, "b", "list", ("struct", spec)),
             (3, "c", "string", None), (20, "d", "double", None), (21, "e", "bool", None)]
    raw = th.encode(extra, {"a": -7, "b": [{"a": 1, "c": "x"}] * 20, "c": "hé", "d": 2.5,
                            "e": False})
    got, end = th.read_struct(raw, 0)
    assert end == len(raw)
    assert th.decode(spec, got) == {"a": -7, "c": "hé"}


@pytest.mark.parametrize("morsel", [700, 1000, 2500])
def test_split_task_morsels_match_reference(sorted_files, morsel):
    """A split task yields morsels of ``morsel_size_rows`` across its row
    groups (row groups of 1,000 rows), as the reference's
    ``iter_batches`` does, and a whole-file task per row group."""
    views = []
    for scan, push, ctx in ((RefScan, RefPushdowns, ref_ctx),
                            (PortScan, PortPushdowns, daft_tpu_torch.execution_config_ctx)):
        sizes = []
        for split in (3, None):
            with ctx(morsel_size_rows=morsel):
                op = scan(sorted_files, row_groups_per_task=split)
                for task in op.to_scan_tasks(push(columns=["k"])):
                    sizes.append([p.num_rows for p in task.read()])
        views.append(sizes)
    assert views[1] == views[0]
