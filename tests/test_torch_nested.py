"""The nested-types wave against the reference: the types (lists, fixed-size
lists, structs, maps, binary, fixed-size binary), their host storage
(daft_tpu_torch/core/series.py's offsets and child columns) and every
function of the wave (daft_tpu_torch/functions/nested.py).

The same columns (nulls at every level, empty lists, duplicate map keys,
bytes outside ASCII) go through ``daft_tpu`` and ``daft_tpu_torch`` under
device_mode="off"; outputs compare by ``to_pylist``: ints, strings, bytes
and structure exactly, floats within rtol 1e-12 (the reference's list
reductions sum with numpy's pairwise order). gzip stamps the time into
its header, so gzip output is held by a round trip through the other
package's ``decompress``, never by its bytes. The Iceberg bucket hash is
held bit for bit over ints, strings and binary; over dates both raise.
"""

import datetime
import json
import math

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.datatype import DataType as RD
from daft_tpu_torch.datatype import DataType as PD

RTOL = 1e-12


def _types(D):
    return {
        "l": D.list(D.int64()), "lf": D.list(D.float64()), "ls": D.list(D.string()),
        "lb": D.list(D.bool()), "ll": D.list(D.list(D.int64())),
        "fl": D.fixed_size_list(D.int64(), 2),
        "st": D.struct({"x": D.int64(), "y": D.string(), "z": D.list(D.int64())}),
        "mp": D.map(D.string(), D.int64()), "b": D.binary(), "fb": D.fixed_size_binary(3),
        "s": D.string(), "u": D.string(), "t": D.string(), "i": D.int64(),
        "h": D.string(), "e": D.string(), "f32": D.list(D.float32()),
    }


DATA = {
    "l": [[1, 2, 3], None, [], [None, 4], [5, 5, None, 1], [-7], [9, 9, 9, 9, 9, 9, 9, 9, 9],
          [0, None], [None], [3, 1, 2], [10, -10], [2 ** 40, 1]],
    "lf": [[1.5, None], [2.0], None, [], [3.25, -1.0, 0.5], [float("nan"), 1.0], [-0.0],
           [1e300, 1e300], [None, None], [0.1, 0.2, 0.3], [7.0], [2.5, 2.5]],
    "ls": [["a", "b"], None, ["c"], [], ["b", "a", "b"], ["é", None], [None], ["x", "x"],
           ["AIR", "RAIL"], ["", "z"], ["q"], ["b", "c", "a"]],
    "lb": [[True, False], None, [], [True], [False, None], [None], [True, True], [False],
           [True, None, False], [], [False, False], [True]],
    "ll": [[[1], [2, None]], None, [[]], [None, [3]], [], [[4, 5], [6]], [[7]], [None],
           [[8, 9, 10]], [[], []], [[1], [1]], [[0]]],
    "fl": [[1, 2], None, [3, 4], [None, 6], [7, 8], [9, 10], [11, None], [0, 0], [5, 5],
           [-1, -2], None, [3, 3]],
    "st": [{"x": 1, "y": "a", "z": [1]}, None, {"x": None, "y": "b", "z": None},
           {"x": 4, "y": None, "z": []}, {"x": 5, "y": "e", "z": [2, 3]},
           {"x": 6, "y": "f", "z": [None]}, {"x": 7, "y": "g", "z": [4]},
           {"x": None, "y": None, "z": None}, {"x": 9, "y": "i", "z": [5, 6]},
           {"x": 10, "y": "j", "z": []}, {"x": 11, "y": "k", "z": [7]},
           {"x": 12, "y": "l", "z": [8]}],
    "mp": [[("a", 1)], None, [], [("b", None), ("c", 3)], [("a", 5), ("a", 6)], [("c", 7)],
           [("a", None)], [("d", 8)], [], [("a", 9), ("b", 10)], [("e", 11)], [("a", 12)]],
    "b": [b"ab", None, b"", b"\x00\xff", b"xyz", b"hello", b"\x80", b"a", b"bb", b"ccc",
          b"\x01\x02", b"zz"],
    "fb": [b"abc", None, b"\x00\x01\x02", b"xyz", b"aaa", b"bbb", b"\xff\xfe\xfd", b"123",
           b"abc", None, b"qqq", b"rrr"],
    "s": ['{"a": 1, "b": [1, 2, {"c": "x"}]}', None, "not json", '{"a": null}',
          '{"a": {"b": true}}', "[1, 2]", '{"a": "s"}', '{"b": 1.5}', "{}",
          '{"a": [10, 20]}', '"str"', "3"],
    "u": ["http://u:p@h.com:80/a?q=1#f", None, "x", "https://a/b", "ftp://z",
          "http://[::1]:8080/p", "mailto:x@y", "https://ex.com:99999/", "", "//host/path",
          "http://h/?a=1&b=2", "s3://bucket/key"],
    "t": ["hello", None, "", "héllo wörld", "a", "bb", "ccc", "dddd", "eeeee", "f", "gg", "h"],
    "i": [0, 1, -1, None, 2 ** 40, -(2 ** 33), 7, 8, 9, 10, 11, 12],
    "h": ["6162", None, "", "00ff", "zz", "41", "4142", "ff", "0", "1234", "abcd", "AB"],
    "e": ["YWI=", None, "", "AP8=", "eHl6", "aGVsbG8=", "!!", "YQ==", "YmI=", "Y2Nj",
          "AQI=", "eno="],
    "f32": [[0.1, 0.2], None, [], [1e-8, None], [3.3], [0.7, 0.7, 0.7], [2.5], [None],
            [1.1, 2.2], [100.001], [-0.5], [6.0]],
}
N = 12


def _frame(m, D):
    types = _types(D)
    return m.from_pydict({c: m.Series.from_pylist(v, c, types[c]) for c, v in DATA.items()})


def _calls(m):
    c = m.col
    l, lf, ls, lb, ll, fl = (c(n) for n in ("l", "lf", "ls", "lb", "ll", "fl"))
    st, mp, b, fb, s, u, t, i = (c(n) for n in ("st", "mp", "b", "fb", "s", "u", "t", "i"))
    h, e, f32 = c("h"), c("e"), c("f32")
    return {
        "list_length": l.list.length(), "list_length_fsl": fl.list.length(),
        "list_length_nested": ll.list.length(),
        "list_sum": l.list.sum(), "list_sum_f": lf.list.sum(), "list_sum_f32": f32.list.sum(),
        "list_sum_fsl": fl.list.sum(),
        "list_mean": l.list.mean(), "list_mean_f": lf.list.mean(),
        "list_min": l.list.min(), "list_min_f": lf.list.min(), "list_max": l.list.max(),
        "list_max_f32": f32.list.max(),
        "list_get0": l.list.get(0), "list_get_neg": l.list.get(-1),
        "list_get_far": l.list.get(5), "list_get_default": l.list.get(3, 99),
        "list_get_str": ls.list.get(1, "zz"), "list_get_nested": ll.list.get(0),
        "list_get_fsl": fl.list.get(1),
        "list_join": ls.list.join("-"), "list_join_empty": ls.list.join(""),
        "list_contains": l.list.contains(5), "list_contains_str": ls.list.contains("b"),
        "list_contains_null": l.list.contains(None),
        "list_slice": l.list.slice(1), "list_slice_neg": l.list.slice(-2, -1),
        "list_slice_mid": l.list.slice(1, 3), "list_slice_str": ls.list.slice(0, 1),
        "list_sort": l.list.sort(), "list_sort_desc": l.list.sort(desc=True),
        "list_sort_str": ls.list.sort(), "list_sort_str_desc": ls.list.sort(desc=True),
        "list_distinct": l.list.distinct(), "list_distinct_str": ls.list.distinct(),
        "list_chunk": l.list.chunk(2), "list_chunk3": ls.list.chunk(3),
        "list_count": l.list.count(), "list_count_null": l.list.count("null"),
        "list_count_all": l.list.count("all"),
        "list_value_counts": l.list.value_counts(), "value_counts_str": ls.list.value_counts(),
        "list_append": l.list_append(9), "list_append_col": l.list_append(i),
        "list_bool_and": lb.list_bool_and(), "list_bool_or": lb.list_bool_or(),
        "struct_get_x": st.struct.get("x"), "struct_get_z": st.struct.get("z"),
        "map_get": mp.map.get("a"), "map_get_b": mp.map.get("b"),
        "map_get_struct": st.map.get("y"),
        "binary_length": b.binary.length(), "binary_concat": b.binary.concat(b),
        "binary_slice": b.binary.slice(1), "binary_slice_len": b.binary.slice(0, 2),
        "encode_hex": b.binary.encode_hex(), "encode_hex_str": t.binary.encode_hex(),
        "decode_hex": c("h").is_null().if_else(h, h)._fn("try_codec_decode", codec="hex"),
        "encode_base64": b.binary.encode_base64(), "encode_base64_fb": fb.binary.encode_base64(),
        "md5": b._fn("md5"), "sha1": t._fn("sha1"), "sha256": b._fn("sha256"),
        "sha512": fb._fn("sha512"),
        "json_query": s.json.query("$.a"), "json_query_deep": s.jq("$.a.b[1].c")
        if hasattr(s, "jq") else s.json.query("$.a.b[1].c"),
        "json_query_index": s.json.query("$.a[1]"), "json_query_root": s.json.query("$"),
        "to_json_list": l._fn("to_json"), "to_json_struct": st._fn("to_json"),
        "to_json_map": mp._fn("to_json"), "to_json_f": lf._fn("to_json"),
        "parse_url": u.parse_url(),
        "compress_zlib": t.compress("zlib"), "compress_bz2": b.compress("bz2"),
        "compress_deflate": t.compress("deflate"),
        "decompress_zlib": t.compress("zlib").decompress("zlib"),
        "try_decompress_bad": b.try_decompress("zlib"), "try_compress": t.try_compress("bz2"),
        "serialize": l.serialize(), "serialize_struct": st.serialize(),
        "deserialize": l.serialize().deserialize("json", m.DataType.list(m.DataType.int64())),
        "try_deserialize": s.try_deserialize("json", m.DataType.int64()),
        "codec_encode_utf8": t.encode(), "codec_encode_b64": t.encode("base64"),
        "codec_encode_hex": b.encode("hex"), "codec_encode_zlib": t.encode("zlib"),
        "codec_decode_b64": e.try_decode("base64"), "codec_decode_utf8": b.try_decode("utf-8"),
        "try_codec_encode": t.try_encode("latin-1"),
        "codec_decode": t.encode("base64").decode("base64"),
        "bucket_int": i.partition_iceberg_bucket(16), "bucket_str": t.partition_iceberg_bucket(7),
        "bucket_bin": b.partition_iceberg_bucket(5),
        "truncate_int": i.partition_iceberg_truncate(4),
        "truncate_str": t.partition_iceberg_truncate(2),
    }


CALLS = sorted(_calls(daft_tpu_torch))

# where the reference's pyarrow kernel refuses the input (binary_join on
# large_binary, offsets of a fixed-size list), the port is held to a
# plain-Python oracle of the reference's own semantics
REFERENCE_FAILS = {
    "binary_concat": lambda: [None if v is None else v + v for v in DATA["b"]],
    "list_sum_fsl": lambda: [None if v is None or all(x is None for x in v)
                             else sum(x for x in v if x is not None) for v in DATA["fl"]],
}


def _run(m, ctx, D, e):
    with ctx:
        df = _frame(m, D).select(e.alias("out"))
        return df.to_pydict()["out"], df.schema["out"].dtype


def _same(got, want, name):
    def norm(v):
        if isinstance(v, float):
            return ("nan",) if math.isnan(v) else v
        if isinstance(v, list):
            return [norm(x) for x in v]
        if isinstance(v, tuple):
            return tuple(norm(x) for x in v)
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return v

    g, w = norm(got), norm(want)
    if g == w:
        return

    def close(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return math.isclose(a, b, rel_tol=RTOL)
        if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
        if isinstance(a, dict) and isinstance(b, dict):
            return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
        return a == b

    assert close(g, w), (name, got, want)


def _builtin_base(exc_type):
    """The exception class the port raises for one of the reference's: a
    pyarrow error's builtin base (ArrowInvalid is a ValueError)."""
    return next(b for b in exc_type.__mro__ if b.__module__ == "builtins")


@pytest.mark.parametrize("name", CALLS)
def test_nested_function_matches_the_reference_host(name):
    ref_e = _calls(daft_tpu)[name]
    port_e = _calls(daft_tpu_torch)[name]
    if name in REFERENCE_FAILS:
        with pytest.raises(Exception):
            _run(daft_tpu, ref_ctx(device_mode="off"), RD, ref_e)
        got, _dt = _run(daft_tpu_torch, daft_tpu_torch.execution_config_ctx(
            device="cpu", device_mode="off"), PD, port_e)
        _same(got, REFERENCE_FAILS[name](), name)
        return
    try:
        want, want_dt = _run(daft_tpu, ref_ctx(device_mode="off"), RD, ref_e)
    except Exception as exc:  # the reference refuses: the port refuses alike
        with pytest.raises(_builtin_base(type(exc))):
            _run(daft_tpu_torch, daft_tpu_torch.execution_config_ctx(device="cpu",
                                                                      device_mode="off"),
                 PD, port_e)
        return
    got, got_dt = _run(daft_tpu_torch,
                       daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"),
                       PD, port_e)
    assert repr(got_dt) == repr(want_dt), (name, got_dt, want_dt)
    _same(got, want, name)


def test_every_function_of_the_wave_is_called():
    from daft_tpu_torch.functions import nested
    from daft_tpu_torch.functions import registry as port_reg

    called = {e.fname for e in _calls(daft_tpu_torch).values()} | {"decode_hex"}
    called |= {n.fname for e in _calls(daft_tpu_torch).values() for n in e.walk()
               if hasattr(n, "fname")}
    wave = {n for n, spec in port_reg._REGISTRY.items()
            if spec.host.__module__ == nested.__name__}
    assert wave - called == {"decode_hex", "decode_base64", "deserialize"} - called
    assert len(wave) == 46


@pytest.mark.parametrize("value,codec", [(b"\x00\x01\xff" * 40, "gzip"), (b"", "gzip"),
                                         (b"abc", "gzip")])
def test_gzip_round_trips_across_the_packages(value, codec):
    """gzip's bytes carry a time stamp: the port's compress is held by the
    reference's decompress, and the other way round."""
    for a, actx, b, bctx, AD, BD in (
            (daft_tpu_torch, daft_tpu_torch.execution_config_ctx(device="cpu",
                                                                 device_mode="off"),
             daft_tpu, ref_ctx(device_mode="off"), PD, RD),
            (daft_tpu, ref_ctx(device_mode="off"), daft_tpu_torch,
             daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"), RD, PD)):
        with actx:
            packed = a.from_pydict({"v": a.Series.from_pylist([value, None], "v", AD.binary())}) \
                .select(a.col("v").compress(codec)).to_pydict()["v"]
        with bctx:
            back = b.from_pydict({"v": b.Series.from_pylist(packed, "v", BD.binary())}) \
                .select(b.col("v").decompress(codec)).to_pydict()["v"]
        assert back == [value, None]


@pytest.mark.parametrize("name,col,args", [("decode_hex", "h", ()), ("decode_base64", "e", ()),
                                           ("deserialize", "s", ("json", None))])
def test_decode_functions_match_the_reference(name, col, args):
    """Each row alone through both packages: equal values, or both raise
    (the port the builtin base of the reference's error)."""
    for v in DATA[col]:
        outs = []
        for m, ctx in ((daft_tpu, ref_ctx(device_mode="off")),
                       (daft_tpu_torch, daft_tpu_torch.execution_config_ctx(
                           device="cpu", device_mode="off"))):
            e = m.col("v")._fn(name) if not args else m.col("v").deserialize(*args)
            with ctx:
                try:
                    outs.append(m.from_pydict({"v": [v]}).select(e).to_pydict()["v"])
                except Exception as exc:  # noqa: BLE001 -- compared below
                    outs.append(_builtin_base(type(exc)))
        assert outs[0] == outs[1], (name, v, outs)


# ---- types --------------------------------------------------------------------------------


def _type_pairs():
    out = []
    for name in sorted(_types(PD)):
        out.append((name, _types(PD)[name], _types(RD)[name]))
    out += [("map_of_lists", PD.map(PD.int32(), PD.list(PD.string())),
             RD.map(RD.int32(), RD.list(RD.string()))),
            ("list_of_structs", PD.list(PD.struct({"a": PD.date()})),
             RD.list(RD.struct({"a": RD.date()}))),
            ("fsl_of_fsl", PD.fixed_size_list(PD.fixed_size_list(PD.uint8(), 2), 3),
             RD.fixed_size_list(RD.fixed_size_list(RD.uint8(), 2), 3))]
    return out


@pytest.mark.parametrize("name,p,r", _type_pairs(), ids=[t[0] for t in _type_pairs()])
def test_types_match_the_reference(name, p, r):
    assert repr(p) == repr(r)
    for pred in ("is_nested", "is_list", "is_struct", "is_map", "is_binary",
                 "is_comparable", "is_device_compatible", "is_string", "is_numeric"):
        assert getattr(p, pred)() == getattr(r, pred)(), (name, pred)
    if p.is_list():
        assert repr(p.inner) == repr(r.inner)
    if p.kind in ("fixed_size_list", "fixed_size_binary"):
        assert p.size == r.size
    if p.is_struct():
        assert [n for n, _t in p.struct_fields] == [n for n, _t in r.struct_fields]


# ---- host storage -------------------------------------------------------------------------


@pytest.mark.parametrize("col", sorted(DATA))
def test_series_round_trip_and_selection_match_the_reference(col):
    rng = np.random.default_rng(7)
    idx = rng.integers(0, N, 20)
    ps = daft_tpu_torch.Series.from_pylist(DATA[col], col, _types(PD)[col])
    rs = daft_tpu.Series.from_pylist(DATA[col], col, _types(RD)[col])
    _same(ps.to_pylist(), rs.to_pylist(), col)
    _same(ps.take(idx).to_pylist(), rs.take(idx).to_pylist(), col)
    _same(ps.slice(3, 9).to_pylist(), rs.slice(3, 9).to_pylist(), col)
    both = daft_tpu_torch.Series.concat([ps.slice(5, 12), ps.slice(0, 5), ps.take(idx)])
    ref = daft_tpu.Series.concat([rs.slice(5, 12), rs.slice(0, 5), rs.take(idx)])
    _same(both.to_pylist(), ref.to_pylist(), col)
    assert len(ps) == len(rs) == N
    if ps.is_nested and ps.dtype.kind in ("list", "map"):
        off = ps.list_offsets()
        assert off[0] == 0 and off[-1] == len(ps.list_child())
        assert (np.diff(off)[~ps.validity_numpy()] == 0).all()
    # hashing (partitioning, grouping, joining) agrees bit for bit
    assert ps.hash().to_pylist() == rs.hash().to_pylist(), col


@pytest.mark.parametrize("src,dst", [
    ("l", "list(float64)"), ("fl", "list(int64)"), ("t", "binary"), ("b", "string_ok"),
    ("l", "fsl"), ("f32", "list(float64)")])
def test_casts_match_the_reference(src, dst):
    def target(D):
        return {"list(float64)": D.list(D.float64()), "list(int64)": D.list(D.int64()),
                "binary": D.binary(), "string_ok": D.string(),
                "fsl": D.fixed_size_list(D.int64(), 2)}[dst]
    rows = DATA[src] if dst != "string_ok" else [b"ab", None, b"", "é".encode()]
    rows = rows if dst != "fsl" else [[1, 2], None, [3, None]]
    ps = daft_tpu_torch.Series.from_pylist(rows, "x", _types(PD).get(src) if dst != "string_ok"
                                           else PD.binary())
    rs = daft_tpu.Series.from_pylist(rows, "x", _types(RD).get(src) if dst != "string_ok"
                                     else RD.binary())
    _same(ps.cast(target(PD)).to_pylist(), rs.cast(target(RD)).to_pylist(), (src, dst))


def test_a_list_of_the_wrong_length_refuses_a_fixed_size_list_in_both():
    for m, D in ((daft_tpu_torch, PD), (daft_tpu, RD)):
        s = m.Series.from_pylist([[1, 2, 3]], "x", D.list(D.int64()))
        with pytest.raises(Exception):
            s.cast(D.fixed_size_list(D.int64(), 2)).to_pylist()


def test_encoder_output_object_arrays_stay_a_constructor():
    rows = np.empty(3, dtype=object)
    rows[:] = [[0.1, 0.2], None, [1 / 3, 2.0]]
    s = daft_tpu_torch.Series.from_numpy(rows, "e", PD.list(PD.float32()))
    want = daft_tpu.Series.from_pylist(rows.tolist(), "e", RD.list(RD.float32())).to_pylist()
    assert s.to_pylist() == want
    two = daft_tpu_torch.Series.from_numpy(np.arange(6, dtype=np.float32).reshape(3, 2), "m")
    ref = daft_tpu.Series.from_numpy(np.arange(6, dtype=np.float32).reshape(3, 2), "m")
    assert repr(two.dtype) == repr(ref.dtype)
    assert two.to_pylist() == [list(r) for r in ref.to_pylist()]


def test_nested_columns_never_fingerprint_or_upload():
    s = daft_tpu_torch.Series.from_pylist(DATA["l"], "l", _types(PD)["l"])
    for col in ("l", "st", "mp", "b"):
        s = daft_tpu_torch.Series.from_pylist(DATA[col], col, _types(PD)[col])
        with pytest.raises(TypeError):
            s.content_fingerprint()
        with pytest.raises(ValueError):
            s.to_device(device="cpu")


@pytest.mark.parametrize("kind", ["int", "string", "binary", "date"])
def test_iceberg_bucket_is_bit_exact(kind):
    rng = np.random.default_rng(11)
    rows = {"int": [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 300)] + [0, -1, None],
            "string": [f"k{v}é" * (v % 5) for v in range(300)] + [None],
            "binary": [bytes(rng.integers(0, 256, v % 9).astype(np.uint8)) for v in range(300)],
            "date": [datetime.date(2000, 1, 1) + datetime.timedelta(days=v) for v in range(30)],
            }[kind]
    outs = []
    for m, ctx in ((daft_tpu, ref_ctx(device_mode="off")),
                   (daft_tpu_torch, daft_tpu_torch.execution_config_ctx(device="cpu",
                                                                        device_mode="off"))):
        with ctx:
            df = m.from_pydict({"v": rows})
            if kind == "date":
                with pytest.raises(ValueError):
                    df.select(m.col("v").partition_iceberg_bucket(16)).to_pydict()
                continue
            outs.append(df.select(m.col("v").partition_iceberg_bucket(1 << 31 - 1))
                        .to_pydict()["v"])
    if kind != "date":
        assert outs[0] == outs[1]


def test_to_json_and_serialize_text_is_the_references():
    rows = [{"a": [1, None], "b": {"c": "é"}}, None, {"a": [], "b": {"c": None}}]
    outs = []
    for m, D in ((daft_tpu, RD), (daft_tpu_torch, PD)):
        dt_ = D.struct({"a": D.list(D.int64()), "b": D.struct({"c": D.string()})})
        df = m.from_pydict({"v": m.Series.from_pylist(rows, "v", dt_)})
        ctx = ref_ctx(device_mode="off") if m is daft_tpu else \
            daft_tpu_torch.execution_config_ctx(device="cpu")
        with ctx:
            outs.append(df.select(m.col("v")._fn("to_json").alias("j"),
                                  m.col("v").serialize().alias("s")).to_pydict())
    assert outs[0] == outs[1]
    assert json.loads(outs[1]["j"][0]) == rows[0]


def _fixed_shape_pairs():
    """The same seeded rows (one null) as each package's fixed-size list,
    embedding, fixed-shape tensor and fixed-shape image."""
    rng = np.random.default_rng(24)
    f = rng.standard_normal((6, 12)).astype(np.float32)
    u8 = rng.integers(0, 256, (6, 2 * 3 * 2), dtype=np.uint8)
    out = []
    for D, S in ((PD, daft_tpu_torch.Series), (RD, daft_tpu.Series)):
        rows_f = [r.tolist() for r in f]
        rows_f[2] = None
        rows_u = [r.tolist() for r in u8]
        rows_u[2] = None
        out.append({
            "fixed_size_list": S.from_pylist(rows_f, "a", D.fixed_size_list(D.float32(), 12)),
            "embedding": S.from_pylist(rows_f, "a", D.embedding(D.float32(), 12)),
            "fixed_shape_tensor": S.from_pylist(rows_f, "a",
                                                D.fixed_shape_tensor(D.float32(), (3, 4))),
            "fixed_shape_image": S.from_pylist(rows_u, "a", D.fixed_shape_image("RGB", 2, 2)),
        })
    return out


@pytest.mark.parametrize("kind", ["fixed_size_list", "embedding", "fixed_shape_tensor",
                                  "fixed_shape_image"])
def test_fixed_shape_to_numpy_is_dense_as_the_reference(kind):
    """The port's to_numpy of a fixed-shape column was an object array of
    Python lists, where the reference gives the dense (n, *shape) array of
    the element type: the old result differed; now the valid rows are the
    reference's, the null row zero."""
    from daft_tpu_torch.core.series import _object_array

    port, ref = (p[kind] for p in _fixed_shape_pairs())
    want = ref.to_numpy()
    valid = ref.validity_numpy()
    old = _object_array(port.to_pylist())
    assert old.shape != want.shape or old.dtype != want.dtype
    got = port.to_numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got[valid], want[valid])
    assert not got[~valid].any()
    if kind != "fixed_size_list":
        pl, rl = port.to_pylist(), ref.to_pylist()
        assert [v is None for v in pl] == [v is None for v in rl]
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(pl, rl) if b is not None)
    else:
        assert port.to_pylist() == ref.to_pylist()


@pytest.mark.parametrize("kind", ["fixed_size_list", "embedding", "fixed_shape_tensor",
                                  "fixed_shape_image"])
def test_fixed_shape_columns_go_to_the_device_as_dense_planes(kind):
    import torch

    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.observability.metrics import registry

    port, _ref = (p[kind] for p in _fixed_shape_pairs())
    manager().clear()
    before = registry().get("hbm_h2d_bytes")
    vals, valid = port.to_device_cached(8, device="cpu")
    moved = registry().get("hbm_h2d_bytes") - before
    shape = port.to_numpy().shape[1:]
    assert tuple(vals.shape) == (8,) + shape and valid.tolist() == [True, True, False, True,
                                                                    True, True, False, False]
    assert moved == vals.numel() * vals.element_size() + valid.numel()
    assert not vals[6:].any() and not vals[2].any()
    assert torch.equal(vals[:6], torch.from_numpy(port.to_numpy()))
    again = port.slice(0, len(port))  # a new Series of the same content
    before = registry().get("hbm_h2d_bytes")
    again.to_device_cached(8, device="cpu")
    assert registry().get("hbm_h2d_bytes") == before
    assert port.content_fingerprint() == again.content_fingerprint()


def test_variable_nested_columns_still_have_no_device_plane():
    for col_ in ("l", "st", "mp"):
        s = daft_tpu_torch.Series.from_pylist(DATA[col_], col_, _types(PD)[col_])
        with pytest.raises(ValueError):
            s.to_device(device="cpu")
