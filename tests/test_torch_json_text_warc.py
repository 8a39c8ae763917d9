"""The JSON, text and WARC scans and the JSON writer (io/json.py, text.py,
warc.py, writers.py) against the reference's (daft_tpu/io/json.py on
pyarrow, text.py, warc.py, writers.py), on the same files:

- ``read_json``: schema and ``to_pydict()`` equal, over mixed and missing
  fields, nested lists and structs, ints that overflow into double, an int
  and a double in one column, all-null columns, ISO-8601 timestamps (each
  form pyarrow reads, and the ones it leaves strings), several files, the
  projection and limit pushdowns; each inference rule held to
  ``pyarrow.json`` alone too; kinds that cannot meet raise in both;
- ``read_text``: universal newlines, empty lines, a missing last newline,
  bad UTF-8, ``.gz``, several files, the limit;
- ``read_warc``: the reference's schema and values, plain and ``.gz`` (a
  gzip member a record), missing headers, the limit and projection;
- ``write_json``: the reference's file contents line for line, and read
  back equal; partitioned; rotation by size;
- the reference's own cases (tests/test_breadth.py:14-72,
  tests/test_io.py:84-90) through the port;
- the scans feed the device grouped stage as the CSV scan does.
"""

import datetime
import gzip
import json
import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.io import json as json_io
from daft_tpu_torch.ops import counters

pa = pytest.importorskip("pyarrow")
pajson = pytest.importorskip("pyarrow.json")


def cpu():
    return daft_tpu_torch.execution_config_ctx(device="cpu")


def _lines(path, rows, sep="\n"):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write((r if isinstance(r, str) else json.dumps(r)) + sep)
    return str(path)


def _both(fn_ref, fn_port):
    want = fn_ref(daft_tpu)
    with cpu():
        got = fn_port(daft_tpu_torch)
    return got, want


def _same_frame(path, **kw):
    ref = daft_tpu.read_json(path, **kw)
    with cpu():
        port = daft_tpu_torch.read_json(path, **kw)
        got = port.to_pydict()
        schema = [(f.name, str(f.dtype)) for f in port.schema]
    want = ref.to_pydict()
    assert schema == [(f.name, str(f.dtype)) for f in ref.schema]
    assert got == want
    return got


JSON_CASES = {
    "flat": [{"a": 1, "b": "x", "c": True, "d": 1.5}, {"a": 2, "b": "y", "c": False, "d": -2.0}],
    "missing_fields": [{"a": 1}, {"b": "s"}, {"a": 3, "c": None}, {}],
    "int_then_double": [{"a": 1}, {"a": 2.5}, {"a": 3}],
    "overflow_to_double": [{"a": 1}, {"a": 9223372036854775808}, {"a": -9223372036854775809}],
    "int64_edges": [{"a": 9223372036854775807}, {"a": -9223372036854775808}],
    "all_null": [{"a": None}, {"a": None}],
    "null_then_int": [{"a": None}, {"a": 3}],
    "nested_lists": [{"l": [1, 2]}, {"l": []}, {"l": None}, {"l": [3]}, {"m": [[1], [2, 3]]}],
    "list_int_double": [{"l": [1, 2.5]}],
    "structs": [{"s": {"x": 1, "y": "a"}}, {"s": {"x": 2}}, {"s": None}, {"s": {"z": True}}],
    "list_of_structs": [{"a": [{"k": 1}, {"k": 2, "j": "x"}]}, {"a": []}],
    "timestamps": [{"t": "2020-01-01"}, {"t": "2020-01-01 10:20:30"},
                   {"t": "2020-01-01T10:20"}, {"t": "2020-01-01T10:20:30Z"},
                   {"t": "2020-01-01T10+01"}, {"t": "2020-01-01T10:20:30-05:30"},
                   {"t": "1960-02-29T00:00:00+0100"}, {"t": None}],
    "timestamp_and_string": [{"t": "2020-01-01"}, {"t": "not a date"}],
    "not_timestamps": [{"t": "2020-01-01T10:20:30.123"}, {"t": "2020-13-01"},
                       {"t": "2020-02-30"}, {"t": "2020-01-01T24:00:00"}, {"t": "10:20:30"},
                       {"t": "2020-1-01"}, {"t": "2020-01-01T10:20:30+24:00"}],
    "unicode": [{"s": "é中👍\u0000"}, {"s": "\\u00e9"}],
    "floats": [{"f": 1e300}, {"f": -0.0}, {"f": 1.0}, {"f": 3}],
    "nested_struct_in_struct": [{"s": {"t": {"u": [1, None, 3]}}}, {"s": {"t": None}}],
}


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_read_json_equals_reference(case, tmp_path):
    path = _lines(tmp_path / "a.jsonl", JSON_CASES[case])
    _same_frame(path)


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_inferred_schema_is_pyarrows(case, tmp_path):
    path = _lines(tmp_path / "a.jsonl", JSON_CASES[case])
    table = pajson.read_json(path)
    ours = json_io.infer_schema(path)
    assert ours.column_names() == table.schema.names
    ref = daft_tpu.Schema.from_arrow(table.schema)
    assert [str(f.dtype) for f in ours] == [str(f.dtype) for f in ref]


@pytest.mark.parametrize("rows", [[{"a": 1}, {"a": "x"}], [{"a": True}, {"a": 1}],
                                  [{"a": {"x": 1}}, {"a": [1]}], [{"a": [1]}, {"a": ["x"]}]])
def test_kinds_that_cannot_meet_raise_in_both(rows, tmp_path):
    path = _lines(tmp_path / "a.jsonl", rows)
    with pytest.raises(Exception):
        daft_tpu.read_json(path).to_pydict()
    with cpu(), pytest.raises(ValueError, match="changed from"):
        daft_tpu_torch.read_json(path).to_pydict()


def test_read_json_blank_lines_several_files_and_extensions(tmp_path):
    _lines(tmp_path / "a.json", [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}], sep="\n\n")
    _lines(tmp_path / "b.ndjson", [{"a": 3, "b": None}])
    _lines(tmp_path / "c.jsonl", [{"a": 4, "b": "z"}])
    _lines(tmp_path / "skip.txt", [{"a": 99}])
    got = _same_frame(str(tmp_path))
    assert got["a"] == [1, 2, 3, 4]


def test_read_json_projection_and_limit(tmp_path):
    for i in range(3):
        _lines(tmp_path / f"p{i}.jsonl", [{"a": i * 10 + k, "b": f"s{k}", "c": [k]}
                                          for k in range(7)])
    got, want = _both(lambda m: m.read_json(str(tmp_path)).select("c", "a").limit(9)
                      .to_pydict(),
                      lambda m: m.read_json(str(tmp_path)).select("c", "a").limit(9)
                      .to_pydict())
    assert got == want and len(got["a"]) == 9
    with cpu():
        plan = repr(daft_tpu_torch.read_json(str(tmp_path)).select("a").limit(2)
                    .optimized_plan())
    assert "columns=['a']" in plan and "limit=2" in plan


def test_read_json_streams_in_batches(tmp_path, monkeypatch):
    monkeypatch.setattr(json_io, "LINES_PER_BATCH", 10)
    path = _lines(tmp_path / "a.jsonl", [{"a": i, "b": i * 0.5} for i in range(35)])
    with cpu():
        scan = json_io.JsonScanOperator(path)
        from daft_tpu_torch.io.scan import Pushdowns

        parts = list(scan.to_scan_tasks(Pushdowns())[0].read())
    assert [len(p) for p in parts] == [10, 10, 10, 5]
    _same_frame(path)


def test_read_json_later_file_against_the_first_files_schema(tmp_path):
    _lines(tmp_path / "a.jsonl", [{"a": 1.5, "b": "x"}])
    _lines(tmp_path / "b.jsonl", [{"a": 2, "c": 7}])
    _same_frame(str(tmp_path))


def test_read_json_explicit_schema(tmp_path):
    path = _lines(tmp_path / "a.jsonl", [{"a": 1, "b": "x"}])
    with cpu():
        schema = daft_tpu_torch.Schema.from_pydict({"a": daft_tpu_torch.DataType.float64()})
        assert daft_tpu_torch.read_json(path, schema=schema).to_pydict() == {"a": [1.0]}


def _text_file(path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


TEXT_CASES = {
    "plain": b"hello\nworld\n\nlast",
    "trailing_newline": b"a\nb\n",
    "crlf_and_cr": b"a\r\nb\rc\n\r\nd",
    "bad_utf8": b"ok\n\xff\xfe bad \xc3\n\xe2\x82\xac",
    "empty": b"",
    "only_newlines": b"\n\n\n",
    "unicode_lines": "é x\u0085y\n中".encode(),
}


@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_read_text_equals_reference(case, tmp_path):
    path = _text_file(tmp_path / "a.txt", TEXT_CASES[case])
    got, want = _both(lambda m: m.read_text(path).to_pydict(),
                      lambda m: m.read_text(path).to_pydict())
    assert got == want


def test_read_text_gz_several_files_limit(tmp_path):
    with gzip.open(tmp_path / "b.txt.gz", "wt") as f:
        f.write("\n".join(f"line{i}" for i in range(100)))
    _text_file(tmp_path / "a.txt", b"x\ny\n")
    paths = [str(tmp_path / "a.txt"), str(tmp_path / "b.txt.gz")]
    for n in (None, 1, 5, 50):
        got, want = _both(
            lambda m: (m.read_text(paths) if n is None else m.read_text(paths).limit(n))
            .to_pydict(),
            lambda m: (m.read_text(paths) if n is None else m.read_text(paths).limit(n))
            .to_pydict())
        assert got == want


def test_read_text_batches_of_64k_lines(tmp_path):
    from daft_tpu_torch.io import text as text_io
    from daft_tpu_torch.io.scan import Pushdowns

    path = _text_file(tmp_path / "a.txt", b"\n".join(b"%d" % i for i in range(70_000)))
    parts = list(text_io.TextScanOperator(path).to_scan_tasks(Pushdowns())[0].read())
    assert [len(p) for p in parts] == [65536, 70_000 - 65536]


def _warc(headers: dict, body: bytes) -> bytes:
    head = "WARC/1.0\r\n" + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
    return head.encode() + body + b"\r\n\r\n"


def _warc_records():
    rng = np.random.default_rng(7)
    recs = [_warc({"WARC-Type": "warcinfo", "WARC-Record-ID": "<urn:uuid:0>",
                   "Content-Length": 14}, b"software: test")]
    for i in range(1, 12):
        body = ("páge %d " % i).encode() * int(rng.integers(1, 20)) + bytes([0xff])
        h = {"WARC-Type": "response" if i % 3 else "request",
             "WARC-Record-ID": f"<urn:uuid:{i}>", "WARC-Target-URI": f"http://h{i % 4}.org/{i}",
             "warc-date": "2024-01-01T00:00:00Z", "Content-Type": "application/http",
             "Content-Length": len(body)}
        if i == 5:
            del h["Content-Type"]
        recs.append(_warc(h, body))
    return recs


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz_member_a_record"])
def test_read_warc_equals_reference(gz, tmp_path):
    recs = _warc_records()
    path = tmp_path / ("a.warc.gz" if gz else "a.warc")
    with open(path, "wb") as f:
        f.write(b"".join(gzip.compress(r) for r in recs) if gz else b"\r\n".join(recs))
    path = str(path)
    got, want = _both(lambda m: m.read_warc(path).to_pydict(),
                      lambda m: m.read_warc(path).to_pydict())
    assert got == want
    with cpu():
        assert [(f.name, str(f.dtype)) for f in daft_tpu_torch.read_warc(path).schema] == \
            [(f.name, str(f.dtype)) for f in daft_tpu.read_warc(path).schema]
    got, want = _both(lambda m: m.read_warc(path).select("content_length", "warc_type")
                      .limit(4).to_pydict(),
                      lambda m: m.read_warc(path).select("content_length", "warc_type")
                      .limit(4).to_pydict())
    assert got == want


def test_read_warc_bad_record_raises(tmp_path):
    path = _text_file(tmp_path / "a.warc", b"NOT A WARC\r\n\r\n")
    with cpu(), pytest.raises(ValueError, match="WARC version"):
        daft_tpu_torch.read_warc(path).to_pydict()


WRITE_DATA = {
    "i": [1, 2, None, 4], "f": [1.5, None, -0.0, 2.0], "s": ["a", "é\"q", None, ""],
    "b": [True, False, None, True], "l": [[1, 2], [], None, [3]],
    "st": [{"x": 1, "y": "a"}, None, {"x": 2, "y": None}, {"x": None, "y": "b"}],
    "ts": [datetime.datetime(2020, 1, 2, 3, 4, 5), None, datetime.datetime(1969, 12, 31),
           datetime.datetime(2024, 2, 29, 23, 59, 59)],
    "d": [datetime.date(2020, 1, 2), None, datetime.date(1970, 1, 1), datetime.date(2000, 3, 1)],
}


def _files_text(root):
    out = []
    for dirpath, _d, files in sorted(os.walk(root)):
        for f in sorted(files):
            with open(os.path.join(dirpath, f)) as fh:
                out.append((os.path.relpath(dirpath, root), fh.read()))
    return out


def test_write_json_equals_reference_and_reads_back(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    daft_tpu.from_pydict(WRITE_DATA).write_json(ref_dir)
    with cpu():
        res = daft_tpu_torch.from_pydict(WRITE_DATA).write_json(port_dir).to_pydict()
    assert len(res["path"]) == 1 and res["path"][0].endswith(".jsonl")
    assert [t for _d, t in _files_text(port_dir)] == [t for _d, t in _files_text(ref_dir)]
    _same_frame(port_dir)


def test_write_json_partitioned_and_rotated(tmp_path, monkeypatch):
    from daft_tpu_torch.io import writers

    data = {"k": ["a", "b", "a", None, "b"], "v": [1, 2, 3, 4, 5]}
    with cpu():
        out = daft_tpu_torch.from_pydict(data).write_json(str(tmp_path / "p"),
                                                          partition_cols=["k"]).to_pydict()
    dirs = sorted(os.path.basename(os.path.dirname(p)) for p in out["path"])
    assert dirs == ["k=__HIVE_DEFAULT_PARTITION__", "k=a", "k=b"]
    with cpu():
        back = daft_tpu_torch.read_json(str(tmp_path / "p")).to_pydict()
    assert sorted(back["v"]) == [1, 2, 3, 4, 5]
    monkeypatch.setattr(writers, "_TARGET_FILE_BYTES", 1)
    with cpu():
        df = daft_tpu_torch.from_pydict({"v": list(range(6))}).into_batches(2)
        out = df.write_json(str(tmp_path / "r")).to_pydict()
    assert len(out["path"]) == 3


def test_write_json_modes(tmp_path):
    d = str(tmp_path / "o")
    with cpu():
        daft_tpu_torch.from_pydict({"a": [1]}).write_json(d)
        daft_tpu_torch.from_pydict({"a": [2]}).write_json(d)
        assert sorted(daft_tpu_torch.read_json(d).to_pydict()["a"]) == [1, 2]
        daft_tpu_torch.from_pydict({"a": [3]}).write_json(d, write_mode="overwrite")
        assert daft_tpu_torch.read_json(d).to_pydict() == {"a": [3]}


# ---- the reference's own cases (tests/test_breadth.py:14-72, tests/test_io.py:84-90) ----


def test_breadth_read_text(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("hello\nworld\n\nlast")
    with cpu():
        assert daft_tpu_torch.read_text(str(p)).to_pydict() == \
            {"text": ["hello", "world", "", "last"]}


def test_breadth_read_text_gz_and_limit(tmp_path):
    p = tmp_path / "b.txt.gz"
    with gzip.open(p, "wt") as f:
        f.write("\n".join(f"line{i}" for i in range(100)))
    with cpu():
        out = daft_tpu_torch.read_text(str(p)).limit(5).to_pydict()
    assert out["text"] == [f"line{i}" for i in range(5)]


def _write_breadth_warc(path, records):
    with open(path, "wb") as f:
        for rid, rtype, uri, body in records:
            payload = body.encode()
            hdr = (f"WARC/1.0\r\n"
                   f"WARC-Record-ID: {rid}\r\n"
                   f"WARC-Type: {rtype}\r\n"
                   + (f"WARC-Target-URI: {uri}\r\n" if uri else "")
                   + f"Content-Length: {len(payload)}\r\n"
                   f"Content-Type: text/plain\r\n\r\n").encode()
            f.write(hdr + payload + b"\r\n\r\n")


def test_breadth_read_warc(tmp_path):
    p = tmp_path / "cc.warc"
    _write_breadth_warc(p, [
        ("<urn:uuid:1>", "warcinfo", None, "software: test"),
        ("<urn:uuid:2>", "response", "http://example.com", "<html>hi</html>"),
        ("<urn:uuid:3>", "response", "http://example.org", "body text"),
    ])
    with cpu():
        out = daft_tpu_torch.read_warc(str(p)).to_pydict()
    assert out["warc_type"] == ["warcinfo", "response", "response"]
    assert out["warc_target_uri"] == [None, "http://example.com", "http://example.org"]
    assert out["content"][1] == "<html>hi</html>"
    assert out["content_length"][2] == len(b"body text")


def test_breadth_warc_common_crawl_dedup_shape(tmp_path):
    p = tmp_path / "cc.warc"
    _write_breadth_warc(p, [
        ("<urn:uuid:1>", "response", "http://a", "the quick brown fox jumps"),
        ("<urn:uuid:2>", "response", "http://b", "the quick brown fox jumps"),
        ("<urn:uuid:3>", "response", "http://c", "совершенно другой текст"),
    ])
    with cpu():
        out = (daft_tpu_torch.read_warc(str(p))
               .where(col("warc_type") == "response")
               .with_column("sig", col("content").minhash(num_hashes=8, ngram_size=2))
               .to_pydict())
    assert out["sig"][0] == out["sig"][1] != out["sig"][2]


def test_io_json_roundtrip(tmp_path):
    with cpu():
        df = daft_tpu_torch.from_pydict({"x": [1, 2, 3], "y": ["a", "b", "c"]})
        paths = df.write_json(str(tmp_path / "out")).to_pydict()["path"]
        back = daft_tpu_torch.read_json(paths).sort("x").to_pydict()
    assert back == {"x": [1, 2, 3], "y": ["a", "b", "c"]}


# ---- the scans into the device grouped stage ----------------------------------------


@pytest.mark.parametrize("fmt", ["json", "text", "warc"])
def test_scans_feed_the_grouped_stage(fmt, tmp_path):
    """Each scan under a groupby plans the DeviceGroupedAgg (device="cpu":
    the kernels' plain versions) and equals "off"."""
    if fmt == "json":
        path = _lines(tmp_path / "a.jsonl", [{"k": i % 5, "v": i * 1.5} for i in range(200)])
        q = lambda m: m.read_json(path).groupby("k").agg(m.col("v").sum()).sort("k")  # noqa
    elif fmt == "text":
        path = _text_file(tmp_path / "a.txt", "\n".join(
            "x" * (i % 7) for i in range(300)).encode())
        q = lambda m: m.read_text(path).with_column(  # noqa: E731
            "n", m.col("text").str.length().cast(m.DataType.int64())).groupby("n").agg(
            m.col("n").count().alias("c")).sort("n")
    else:
        path = str(tmp_path / "a.warc.gz")
        with open(path, "wb") as f:
            f.write(b"".join(gzip.compress(r) for r in _warc_records()))
        q = lambda m: m.read_warc(path).groupby("warc_type").agg(  # noqa: E731
            m.col("content_length").sum().alias("s")).sort("warc_type")
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        counters.reset()
        on = q(daft_tpu_torch).to_pydict()
        assert counters.snapshot()["device_grouped_batches"] >= 1
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        off = q(daft_tpu_torch).to_pydict()
    assert on == off
    assert on == q(daft_tpu).to_pydict()
