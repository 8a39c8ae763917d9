"""The port's CSV reader and writer (daft_tpu_torch/io/csv.py,
io/writers.py) against the reference's (daft_tpu/io/csv.py, which reads
through ``pyarrow.csv``): the types inferred from the first block, the
values, the options (headers, delimiter) and the round trip of the port's
files through the reference."""

import datetime

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx

CASES = {
    "ints": "a,b\n1,-2\n 3 ,40\n0x1F,05\n",
    "floats": "a,b\n1.5,2\n-0.25,1e3\n.5,inf\n+1.5,-Infinity\n5.,NAN\n",
    "bools": "a,b\ntrue,1\nFalse,0\nTRUE,1\n",
    "dates": "a,b\n2020-01-01,1992-02-29\n1970-01-01,\n",
    "strings": 'a,b\nx,"q,1"\n"say ""hi""",\n"",NA\n',
    "nulls": "a,b,c\nNA,1,\nnull,,\n,3,N/A\n",
    "mixed": "a,b,c,d\n1,1.5,2020-01-01,true\n2.5,x,5,0\nnan,2,2020-13-01,2\n",
    "big_ints": "a\n9223372036854775807\n-9223372036854775808\n99999999999999999999\n",
    "empty_lines": "a,b\n1,x\n\n2,y\n\n",
    "unicode": "name,n\nÄpfel,1\n日本,2\n",
}


def _write(tmp_path, name, text):
    path = tmp_path / f"{name}.csv"
    path.write_bytes(text.encode("utf-8"))
    return str(path)


def _both(path, **opts):
    with ref_ctx(device_mode="off"):
        ref = daft_tpu.read_csv(path, **opts)
        want = ([(f.name, f.dtype.kind) for f in ref.schema], ref.to_pydict())
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port = daft_tpu_torch.read_csv(path, **opts)
        got = ([(f.name, f.dtype.kind) for f in port.schema], port.to_pydict())
    return got, want


def _eq(a, b):
    return (a is None and b is None) or a == b or (
        isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b))


def _same(got, want):
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for c in want[1]:
        assert len(got[1][c]) == len(want[1][c]) and all(
            _eq(x, y) for x, y in zip(got[1][c], want[1][c])), (c, got[1][c], want[1][c])


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_and_values_match_reference(tmp_path, case):
    got, want = _both(_write(tmp_path, case, CASES[case]))
    _same(got, want)


def test_no_headers_and_delimiter_match_reference(tmp_path):
    path = _write(tmp_path, "bar", "1|x|2020-01-01\n2|y|\n")
    got, want = _both(path, has_headers=False, delimiter="|")
    _same(got, want)
    assert [n for n, _k in got[0]] == ["column_1", "column_2", "column_3"]


def test_inference_reads_only_the_first_block(tmp_path):
    """Past the first 1 MiB block a value its column's type rejects raises
    in both packages; within it, the column is a string."""
    rows = "\n".join(str(i) for i in range(200_000))
    late = _write(tmp_path, "late", "a\n" + rows + "\nx\n")
    with pytest.raises(Exception):
        with ref_ctx(device_mode="off"):
            daft_tpu.read_csv(late).to_pydict()
    with pytest.raises(ValueError, match="invalid value 'x'"):
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            daft_tpu_torch.read_csv(late).to_pydict()
    early = _write(tmp_path, "early", "a\nx\n" + rows + "\n")
    got, want = _both(early)
    assert got[0] == want[0] == [("a", "string")]
    assert got[1]["a"][:3] == want[1]["a"][:3] == ["x", "0", "1"]


def test_large_file_blocks_and_limit_match_reference(tmp_path):
    rng = np.random.default_rng(4)
    n = 60_000
    lines = [f"{i},{v:.6f},{'abc'[i % 3]}" for i, v in enumerate(rng.random(n))]
    path = _write(tmp_path, "large", "k,v,s\n" + "\n".join(lines) + "\n")
    got, want = _both(path)
    _same(got, want)
    with ref_ctx(device_mode="off"):
        want_l = daft_tpu.read_csv(path).limit(70_000 // 7).select("k", "s").to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got_l = daft_tpu_torch.read_csv(path).limit(70_000 // 7).select("k", "s").to_pydict()
    assert got_l == want_l


def test_time_and_timestamp_columns_raise(tmp_path):
    for text in ("a\n12:30:00\n", "a\n2020-01-01 12:00:00\n"):
        with pytest.raises(NotImplementedError, match="time"):
            daft_tpu_torch.read_csv(_write(tmp_path, "t", text)).schema


def test_reference_reads_the_ports_csv(tmp_path):
    rng = np.random.default_rng(9)
    n = 500
    data = {
        "i": rng.integers(-10**12, 10**12, n).tolist(),
        "f": [float(x) for x in rng.standard_normal(n)],
        "whole": [float(x) for x in rng.integers(0, 9, n)],
        "b": (rng.random(n) < 0.5).tolist(),
        "d": [datetime.date(1995, 1, 1) + datetime.timedelta(days=int(x))
              for x in rng.integers(0, 900, n)],
        "s": [f'v{i} "q", x' if i % 5 else "" for i in range(n)],
    }
    for c in ("i", "f", "d"):
        data[c] = [None if j % 11 == 0 else v for j, v in enumerate(data[c])]
    df = daft_tpu_torch.from_pydict(data)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        paths = df.write_csv(str(tmp_path / "out")).to_pydict()["path"]
        back_port = daft_tpu_torch.read_csv(paths[0]).to_pydict()
    assert len(paths) == 1
    with ref_ctx(device_mode="off"):
        ref = daft_tpu.read_csv(paths[0])
        kinds = [f.dtype.kind for f in ref.schema]
        back = ref.to_pydict()
    assert kinds == ["int64", "float64", "float64", "bool", "date", "string"]
    assert back == data and back_port == data


def test_partitioned_write_and_overwrite(tmp_path):
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1, None, 2], "v": [10, 20, 30, 40, 50]})
    root = str(tmp_path / "parts")
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        paths = df.write_csv(root, partition_cols=["k"]).to_pydict()["path"]
        assert sorted(p.split("/")[-2] for p in paths) == \
            ["k=1", "k=2", "k=__HIVE_DEFAULT_PARTITION__"]
        df.write_parquet(root + "_pq", partition_cols=["k"])
        again = df.write_parquet(root + "_pq", partition_cols=["k"],
                                 write_mode="overwrite").to_pydict()["path"]
        got = daft_tpu_torch.read_parquet(root + "_pq").sort("v").to_pydict()
    assert len(again) == 3
    assert got == {"k": [1, 2, 1, None, 2], "v": [10, 20, 30, 40, 50]}
    with ref_ctx(device_mode="off"):
        assert daft_tpu.read_parquet(root + "_pq").sort("v").to_pydict() == got
