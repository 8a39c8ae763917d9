"""Nested Parquet across the packages: the reference writes (pyarrow) and the
port reads, the port writes (its own writer: repetition and definition
levels, the three-level LIST layout, MAP's key_value group, structs,
BYTE_ARRAY binary, FIXED_LEN_BYTE_ARRAY, the nested ARROW:schema) and the
reference reads, with equal values: lists of lists, structs of lists,
maps, binary, fixed-size binary, fixed-size lists and nulls at every
level. A fixed-size list is written without null rows: pyarrow itself
cannot read back a fixed-size list holding a null row ("Expected all lists
to be of size=..."), whichever writer wrote it.
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

ROWS = 300


def _table(seed=5, n=ROWS):
    rng = np.random.default_rng(seed)

    def maybe(v, p=0.12):
        return None if rng.random() < p else v

    ints = [maybe([maybe(int(x)) for x in rng.integers(-99, 99, rng.integers(0, 4))])
            for _ in range(n)]
    lol = [maybe([maybe([maybe(int(x)) for x in rng.integers(0, 9, rng.integers(0, 3))])
                  for _ in range(rng.integers(0, 3))]) for _ in range(n)]
    words = ["a", "bb", "é", "", "long word"]
    structs = [maybe({"x": maybe(int(rng.integers(0, 5))),
                      "y": maybe([maybe(words[int(w)]) for w in rng.integers(0, 5, 2)]),
                      "z": maybe({"q": maybe(float(rng.random()))})}) for _ in range(n)]
    maps = [maybe([(words[int(k)], maybe(int(v))) for k, v in
                   zip(rng.integers(0, 5, rng.integers(0, 3)), rng.integers(0, 9, 3))])
            for _ in range(n)]
    binary = [maybe(bytes(rng.integers(0, 256, rng.integers(0, 6)).astype(np.uint8)))
              for _ in range(n)]
    fixed = [maybe(bytes(rng.integers(0, 256, 4).astype(np.uint8))) for _ in range(n)]
    fsl = [[int(x) for x in rng.integers(0, 9, 2)] for _ in range(n)]
    dates = [maybe([maybe(datetime.date(2000, 1, 1) + datetime.timedelta(days=int(d)))
                    for d in rng.integers(0, 9000, 2)]) for _ in range(n)]
    floats = [maybe([maybe(float(x)) for x in rng.normal(size=rng.integers(0, 3))])
              for _ in range(n)]
    return pa.table({
        "k": pa.array(range(n), pa.int64()),
        "ints": pa.array(ints, pa.large_list(pa.int64())),
        "lol": pa.array(lol, pa.large_list(pa.large_list(pa.int64()))),
        "st": pa.array(structs, pa.struct([("x", pa.int64()),
                                           ("y", pa.large_list(pa.large_string())),
                                           ("z", pa.struct([("q", pa.float64())]))])),
        "mp": pa.array(maps, pa.map_(pa.large_string(), pa.int64())),
        "b": pa.array(binary, pa.large_binary()),
        "fb": pa.array(fixed, pa.binary(4)),
        "fsl": pa.array(fsl, pa.list_(pa.int32(), 2)),
        "dl": pa.array(dates, pa.large_list(pa.date32())),
        "fl": pa.array(floats, pa.large_list(pa.float32())),
    })


def _port_read(path, **cfg):
    with daft_tpu_torch.execution_config_ctx(device="cpu", **cfg):
        return daft_tpu_torch.read_parquet(path).sort("k").to_pydict()


def _ref_read(path):
    with ref_ctx(device_mode="off"):
        return daft_tpu.read_parquet(path).sort("k").to_pydict()


def _files(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".parquet")]


@pytest.mark.parametrize("kw", [{}, {"use_dictionary": False}, {"compression": "none"},
                                {"data_page_version": "2.0"}, {"row_group_size": 64},
                                {"data_page_size": 512}],
                         ids=["default", "plain", "uncompressed", "page_v2", "row_groups",
                              "small_pages"])
def test_port_reads_what_pyarrow_writes(tmp_path, kw):
    t = _table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, **kw)
    got = _port_read(path)
    assert got == t.to_pydict()


def test_reference_writes_and_port_reads(tmp_path):
    t = _table(7)
    ref = daft_tpu.from_arrow(t) if hasattr(daft_tpu, "from_arrow") else None
    if ref is None:
        ref = daft_tpu.from_pydict({c: daft_tpu.Series.from_arrow(t[c], c)
                                    for c in t.column_names})
    with ref_ctx(device_mode="off"):
        ref.write_parquet(str(tmp_path / "r")).to_pydict()
    got = _port_read(str(tmp_path / "r"))
    assert got == _ref_read(str(tmp_path / "r"))


@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_port_writes_and_the_reference_reads(tmp_path, codec):
    t = _table(9)
    src = str(tmp_path / "src.parquet")
    pq.write_table(t, src)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        df = daft_tpu_torch.read_parquet(src)
        df.write_parquet(str(tmp_path / "p"), compression=codec).to_pydict()
    want = t.to_pydict()
    for f in _files(str(tmp_path / "p")):
        back = pq.read_table(f)
        assert back.schema.equals(t.schema.remove_metadata(), check_metadata=False) or \
            [str(x) for x in back.schema.types] == [str(x) for x in t.schema.types]
    assert _ref_read(str(tmp_path / "p")) == want
    assert _port_read(str(tmp_path / "p")) == want


def test_port_round_trip_keeps_types_and_layouts(tmp_path):
    t = _table(11)
    src = str(tmp_path / "src.parquet")
    pq.write_table(t, src)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        a = daft_tpu_torch.read_parquet(src).collect()
        a.write_parquet(str(tmp_path / "p")).to_pydict()
        b = daft_tpu_torch.read_parquet(str(tmp_path / "p")).collect()
        assert a.schema == b.schema
        assert a.sort("k").to_pydict() == b.sort("k").to_pydict()


def test_nested_reads_prune_columns_and_rows(tmp_path):
    t = _table(13, 2000)
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=256)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = (daft_tpu_torch.read_parquet(path).where(daft_tpu_torch.col("k") >= 1500)
               .select("k", "mp", "lol").sort("k").to_pydict())
    want = t.filter(pa.compute.greater_equal(t["k"], 1500)).select(["k", "mp", "lol"])
    assert got == want.to_pydict()


def test_empty_and_all_null_nested_columns(tmp_path):
    t = pa.table({"k": pa.array([0, 1], pa.int64()),
                  "a": pa.array([None, None], pa.large_list(pa.int64())),
                  "b": pa.array([[], []], pa.large_list(pa.large_string())),
                  "s": pa.array([None, {"x": None}], pa.struct([("x", pa.int64())]))})
    path = str(tmp_path / "e.parquet")
    pq.write_table(t, path)
    assert _port_read(path) == t.to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        daft_tpu_torch.read_parquet(path).write_parquet(str(tmp_path / "o")).to_pydict()
    assert _ref_read(str(tmp_path / "o")) == t.to_pydict()


# the flat binary, fixed-length binary, list and struct columns the port
# refused before the nested slice (tests/test_torch_parquet.py's cases)
READS = {
    "fixed_len_binary": pa.table({"a": pa.array([b"xyz", b"abc"], pa.binary(3))}),
    "struct": pa.table({"a": pa.array([{"x": 1}, {"x": 2}])}),
    "nested": pa.table({"a": pa.array([[1], [2, 3]])}),
    "binary": pa.table({"a": pa.array([b"x", b"y"])}),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_formerly_refused_columns_read_as_pyarrow_reads_them(tmp_path, case):
    path = str(tmp_path / "u.parquet")
    pq.write_table(READS[case], path)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.read_parquet(path).to_pydict()
    assert got == READS[case].to_pydict()


def test_a_legacy_two_level_list_raises_naming_it(tmp_path):
    """A bare repeated field (the legacy two-level list, which pyarrow's
    default writer never writes) raises NotImplementedError by name."""
    from daft_tpu_torch.io import _parquet_format as pf
    from daft_tpu_torch.io import _thrift as th

    schema = [{"name": "schema", "num_children": 1},
              {"type": pf.INT64, "repetition_type": pf.REPEATED, "name": "a"}]
    with pytest.raises(NotImplementedError, match="legacy two-level"):
        pf.column_info(schema)
    assert th is not None
