"""Queries over files: the scan path of the port (ScanSource, the three scan
rules, StreamingScan, the Parquet and CSV operators, residency rebinding,
the session) against the reference's, on TPC-H at SF 0.01 written as
Parquet by the reference's ``write_parquet``.

- The optimized plans of the 22 TPC-H DataFrame queries over the files
  equal the reference's, pushdowns included.
- q1, q3, q5, q6, q12 and q14 over the files give the reference's host
  results, with the port's device path on (device="cpu": the kernels'
  plain versions) and off.
- Over multi-morsel files (``morsel_size_rows`` 8,192) the device, the
  coalescer's and the scan's counters equal the reference's; q3's join
  TopN takes the host plan in both, for a fact of more than one batch.
- A second collect of a file-fed query uploads no column: every plane
  rebinds by content (``hbm_stable_rehits``); a rewritten file misses.
- The snappy library is held against the plain Python decoder, and a
  failed build raises.
- ``current_session()`` resolves SQL tables with no bindings.
"""

import os
import shutil
import sys

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.observability.metrics import registry as ref_registry
from daft_tpu.ops import counters as ref_counters
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.ops import counters

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_optimizer import canonical  # noqa: E402
from test_torch_tpch_sweep import _port_queries, _same  # noqa: E402

TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation",
          "region")
MORSEL = 8192
# the coalescers flush by size alone: a latency flush makes which morsels a
# dispatch folds depend on the decode times
FLUSH_MS = 60_000.0
QUERIES = (1, 3, 5, 6, 12, 14)
# the device counters both packages keep, and the scan's
DEVICE_COUNTERS = ("device_grouped_batches", "device_stage_batches", "device_join_batches",
                   "device_stage_runs", "device_topn_runs", "device_region_dispatches",
                   "device_region_ops_fused", "coalesce_morsels_in", "dispatch_coalesced",
                   "bucket_fill_rows", "bucket_capacity_rows")
SCAN_COUNTERS = ("scan_batches", "scan_rows")


@pytest.fixture(autouse=True, scope="module")
def _drop_planes_after():
    """Leave no content-keyed planes for a later module's tables of equal
    content to rebind."""
    yield
    manager().clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from benchmarking.tpch.datagen import generate

    root = tmp_path_factory.mktemp("tpch_files")
    for name, table in generate(0.01, 0).items():
        with ref_ctx(device_mode="off"):
            daft_tpu.from_arrow(table).write_parquet(str(root / name))
    return str(root)


def _ref_tables(root):
    return {k: daft_tpu.read_parquet(os.path.join(root, k)) for k in TABLES}


def _port_tables(root):
    return {k: daft_tpu_torch.read_parquet(os.path.join(root, k)) for k in TABLES}


def scan_canonical(node):
    """canonical() with each ScanSource's pushdowns."""
    head, kids = canonical(node, exprs=True)
    if type(node).__name__ == "ScanSource":
        pd = node.pushdowns
        head = head + (pd.columns and tuple(pd.columns),
                       repr(pd.filters) if pd.filters is not None else None, pd.limit)
    return head, tuple(scan_canonical(c) for c in node.children())


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_plans_over_files_match_reference(files, qn):
    from benchmarking.tpch.queries import ALL_QUERIES

    want = scan_canonical(ALL_QUERIES[qn](_ref_tables(files))._builder.optimize().plan)
    got = scan_canonical(_port_queries()[qn](_port_tables(files)).optimized_plan())
    assert got == want
    assert "ScanSource" in repr(got)


@pytest.mark.parametrize("qn", QUERIES)
def test_tpch_over_files_matches_reference_host(files, qn):
    from benchmarking.tpch.queries import ALL_QUERIES

    with ref_ctx(device_mode="off"):
        want = ALL_QUERIES[qn](_ref_tables(files)).to_pydict()
    for device_mode in ("on", "off"):
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=device_mode):
            got = _port_queries()[qn](_port_tables(files)).to_pydict()
        _same(got, want)


def _ref_counted(qn, root):
    from benchmarking.tpch.queries import ALL_QUERIES

    ref_counters.reset()
    before = {k: ref_registry().get(k) for k in SCAN_COUNTERS}
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1, morsel_size_rows=MORSEL,
                 batch_latency_ms=FLUSH_MS):
        out = ALL_QUERIES[qn](_ref_tables(root)).to_pydict()
    snap = ref_counters.snapshot()
    snap.update({k: ref_registry().get(k) - before[k] for k in SCAN_COUNTERS})
    return out, snap, dict(ref_counters.rejections)


def _port_counted(qn, root):
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", morsel_size_rows=MORSEL,
                                             batch_latency_ms=FLUSH_MS):
        out = _port_queries()[qn](_port_tables(root)).to_pydict()
    return out, counters.snapshot(), dict(counters.rejections)


@pytest.mark.parametrize("qn", QUERIES)
def test_multi_morsel_counters_match_reference(files, qn):
    manager().clear()
    want, ref_snap, ref_rej = _ref_counted(qn, files)
    got, snap, rej = _port_counted(qn, files)
    _same(got, want)
    assert {k: snap[k] for k in DEVICE_COUNTERS} == \
        {k: ref_snap.get(k, 0) for k in DEVICE_COUNTERS}
    assert snap["coalesce_morsels_in"] + snap["device_topn_runs"] > 0
    if qn == 3:
        # a fact of several batches: the join TopN takes the host plan in
        # both packages, after a first batch (the reference's pipeline reads
        # ahead of its bail, so only the device counters are compared)
        assert snap["device_topn_runs"] == 0 and snap["device_fallbacks"] == 1
        assert any("single fact batch" in r for r in rej), rej
        assert any("multi-batch fact" in r for r in ref_rej), ref_rej
    else:
        assert {k: snap[k] for k in SCAN_COUNTERS} == {k: ref_snap[k] for k in SCAN_COUNTERS}
        assert not rej and not ref_rej, (rej, ref_rej)


def test_warm_q12_probes_as_the_reference_does(files):
    """On a second run over new reads of the same files, K4's table rebinds
    by content in both packages (the reference's deps-free ``ptable``), and
    the fact's index plane, keyed by identity with deps in both, is probed
    again."""
    manager().clear()
    _port_counted(12, files)
    _ref_counted(12, files)
    _, ref_snap, _ = _ref_counted(12, files)
    _, snap, _ = _port_counted(12, files)
    assert snap["plain_hash_probe_build"] == 0
    assert snap["plain_hash_probe_index"] == ref_snap["pallas_probe_dispatches"] == 1


def test_second_collect_uploads_nothing_and_rewrite_misses(tmp_path, monkeypatch):
    from daft_tpu_torch import col
    from daft_tpu_torch.core.series import Series

    rng = np.random.default_rng(8)
    n = 40_000
    df = daft_tpu_torch.from_pydict({
        "k": np.array(["A", "B", "C"], dtype=object)[rng.integers(0, 3, n)],
        "v": rng.random(n), "q": rng.integers(0, 50, n)})
    root = str(tmp_path / "t")
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        df.write_parquet(root)
    uploads = []
    real = Series.to_device

    def counting(self, *args, **kwargs):
        uploads.append(self.name)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Series, "to_device", counting)

    def query():
        return (daft_tpu_torch.read_parquet(root).where(col("q") < 10).groupby("k")
                .agg(col("v").sum(), col("q").max()).sort("k").to_pydict())

    manager().clear()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", morsel_size_rows=4096):
        cold = query()
        assert sorted(set(uploads)) == ["q", "v"]
        for _ in range(2):
            uploads.clear()
            counters.reset()
            assert query() == cold
            assert uploads == [] and counters.hbm_stable_rehits > 0
            assert counters.hbm_cache_misses == 0
        # the coalescer's concatenated batches rebind too
        assert counters.dispatch_coalesced < counters.coalesce_morsels_in
        # rewritten with other values: the content differs, the planes are
        # built again (each morsel's upload a miss)
        shutil.rmtree(root)
        other = rng.random(n)
        daft_tpu_torch.from_pydict({"k": ["A"] * n, "v": other,
                                    "q": np.zeros(n, dtype=np.int64)}).write_parquet(root)
        uploads.clear()
        counters.reset()
        got = query()
        assert got["k"] == ["A"] and got["q"] == [0]
        assert np.isclose(got["v"][0], other.sum(), rtol=1e-5)
        assert sorted(set(uploads)) == ["q", "v"] and counters.hbm_cache_misses > 0


def test_fingerprint_is_content_only():
    from daft_tpu_torch.core.series import Series

    a = Series.from_pylist(["x", "yé", None, ""], "a")
    b = Series.from_pylist(["x", "yé", None, ""], "b")
    c = Series.from_pylist(["xy", "é", None, ""], "a")
    assert a.content_fingerprint() == b.content_fingerprint() != c.content_fingerprint()
    ints = Series.from_numpy(np.arange(5), "i")
    assert ints.content_fingerprint() != Series.from_numpy(np.arange(5) + 1,
                                                           "i").content_fingerprint()
    assert ints.content_fingerprint() != Series.from_numpy(
        np.arange(5), "i", validity=np.array([1, 1, 0, 1, 1], bool)).content_fingerprint()
    assert ints.rename("j")._content_fp == ints.content_fingerprint()


@pytest.mark.parametrize("kind", ["strings", "same_width_strings", "numbers",
                                  "concatenation"])
def test_fingerprint_over_many_pieces(kind):
    """A column of several fingerprint pieces (_FP_PIECE_ROWS rows): equal
    content gives one fingerprint, whether a string column carries
    dictionary codes (as a Parquet read gives it; a dictionary of one UTF-8
    width among them) or not, and whether a
    column was built whole, by concatenating whole pieces (which takes the
    parts' digests) or not; a change in the last piece gives another."""
    from daft_tpu_torch.core import series as sm
    from daft_tpu_torch.io._parquet_format import attach_dictionary_codes

    rng = np.random.default_rng(5)
    rows = sm._FP_PIECE_ROWS
    if kind.endswith("strings"):
        vocab = np.array(["ab", "cd", "\u00e9"] if kind.startswith("same") else
                         ["", "x", "yé", "zzz", "\u00df\u4e2d"], dtype=object)
        n = 2 * rows + 17
        codes = rng.integers(0, len(vocab), n)
        valid = rng.random(n) > 0.1
        values = [v if ok else None for v, ok in zip(vocab[codes].tolist(), valid)]
        plain = sm.Series.from_pylist(values, "s")
        other = sm.Series.from_pylist(values, "t")
        attach_dictionary_codes(other, vocab, codes[valid].astype(np.int32))
        assert other._raw_codes() is not None and plain._raw_codes() is None
        values[-1] = "other"
        changed = sm.Series.from_pylist(values, "s")
    else:
        values = rng.random(3 * rows + 5)
        plain = sm.Series.from_numpy(values, "v")
        other = sm.Series.from_numpy(values.copy(), "w")
        changed_values = values.copy()
        changed_values[-1] += 1.0
        changed = sm.Series.from_numpy(changed_values, "v")
        if kind == "concatenation":
            parts = [sm.Series.from_numpy(values[i:i + rows].copy(), "v")
                     for i in range(0, len(values), rows)]
            other = sm.Series.concat(parts)
            assert isinstance(other._fp_pieces, tuple)
            unaligned = sm.Series.concat([sm.Series.from_numpy(values[:rows - 1], "v"),
                                          sm.Series.from_numpy(values[rows - 1:], "v")])
            assert unaligned._fp_pieces is None
            assert unaligned.content_fingerprint() == plain.content_fingerprint()
            changed = sm.Series.concat(parts[:-1] + [sm.Series.from_numpy(
                changed_values[-5:], "v")])
    assert plain.content_fingerprint() == other.content_fingerprint()
    assert changed.content_fingerprint() != plain.content_fingerprint()


# ---- the snappy codec ----------------------------------------------------------------


def test_snappy_library_against_plain_decoder(files):
    """Every snappy page of the lineitem file decodes the same through the
    library and the plain Python decoder; the library's own output too."""
    from daft_tpu_torch.io import _parquet_format as pf
    from daft_tpu_torch.io import _thrift as th
    from daft_tpu_torch.io import codecs

    d = os.path.join(files, "lineitem")
    path = os.path.join(d, os.listdir(d)[0])
    footer = pf.read_footer(path)
    pages = 0
    with open(path, "rb") as f:
        for c in footer.columns:
            md = footer.chunk(footer.row_groups[0], c.name)
            assert md["codec"] == codecs.SNAPPY
            f.seek(md.get("dictionary_page_offset") or md["data_page_offset"])
            raw = f.read(md["total_compressed_size"])
            pos = 0
            while pos < len(raw):
                h, pos = th.read_struct(raw, pos)
                ph = th.decode(th.PAGE_HEADER, h)
                page = raw[pos:pos + ph["compressed_page_size"]]
                pos += ph["compressed_page_size"]
                if ph["type"] == pf.DATA_PAGE_V2:
                    continue
                lib = codecs.snappy_decompress(page, ph["uncompressed_page_size"])
                assert lib == codecs.plain_snappy_decompress(page)
                again = codecs.snappy_compress(lib)
                assert codecs.plain_snappy_decompress(again) == lib
                pages += 1
    assert pages >= len(footer.columns)


def test_failed_snappy_build_raises(tmp_path):
    from daft_tpu_torch.ops import _build

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.host_library(str(bad))


def test_corrupt_snappy_page_raises():
    from daft_tpu_torch.io import codecs

    good = codecs.snappy_compress(b"abcdefgh" * 100)
    with pytest.raises(ValueError):
        codecs.snappy_decompress(good[:-3])
    with pytest.raises(ValueError):
        codecs.plain_snappy_decompress(b"\x10\x09\x00")  # a copy before any output


# ---- the session ---------------------------------------------------------------------


def test_session_sql_with_no_bindings(files):
    import daft_tpu_torch as dt

    sess = dt.current_session()
    text = ("SELECT n_name, COUNT(*) AS n FROM customer, nation "
            "WHERE c_nationkey = n_nationkey GROUP BY n_name ORDER BY n_name")
    for name in ("customer", "nation"):
        sess.create_temp_table(name, dt.read_parquet(os.path.join(files, name)))
    try:
        with dt.execution_config_ctx(device="cpu"):
            got = dt.sql(text).to_pydict()
            own = dt.Session()
            own.create_temp_table("customer", dt.read_parquet(os.path.join(files, "customer")))
            own.create_temp_table("nation", dt.read_csv(_nation_csv(files)))
            assert own.sql(text).to_pydict() == got
        with ref_ctx(device_mode="off"):
            want = daft_tpu.sql(text, customer=daft_tpu.read_parquet(
                os.path.join(files, "customer")), nation=daft_tpu.read_parquet(
                os.path.join(files, "nation"))).to_pydict()
        assert got == want
        with pytest.raises(ValueError, match="unknown table"):
            dt.sql("SELECT * FROM no_such_table")
    finally:
        for name in ("customer", "nation"):
            sess.drop_temp_table(name)
    assert sess.list_tables() == []


def _nation_csv(root):
    out = os.path.join(root, "nation_csv")
    if not os.path.isdir(out):
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            daft_tpu_torch.read_parquet(os.path.join(root, "nation")).write_csv(out)
    return out


def test_session_catalogs_resolve_dotted_names(files):
    import daft_tpu_torch as dt

    class Catalog:
        name = "wh"

        def load_table(self, rest):
            return dt.read_parquet(os.path.join(files, rest.split(".")[-1]))

    sess = dt.Session()
    sess.attach_catalog(Catalog())
    with dt.execution_config_ctx(device="cpu"):
        got = sess.sql("SELECT COUNT(*) AS n FROM wh.tpch.region").to_pydict()
    assert got == {"n": [5]}
    sess.detach_catalog("wh")
    with pytest.raises(ValueError, match="unknown table"):
        sess.sql("SELECT COUNT(*) AS n FROM wh.tpch.region")


def test_q5_sql_over_csv_dims_plans_as_the_reference(files, tmp_path):
    """q5 in SQL with lineitem and orders from Parquet and its dims from
    CSV: the CSV scans give no row estimate, so the join reorder keeps the
    text's order and neither package captures the star join; the joins run
    on the host into one grouped device stage, in both, with the
    reference's result."""
    import daft_tpu_torch as dt

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    dims = ("customer", "supplier", "nation", "region")
    csv = {}
    with dt.execution_config_ctx(device="cpu"):
        for name in dims:
            csv[name] = str(tmp_path / name)
            dt.read_parquet(os.path.join(files, name)).write_csv(csv[name])
    port = {k: dt.read_parquet(os.path.join(files, k)) for k in ("lineitem", "orders")}
    port.update({k: dt.read_csv(csv[k]) for k in dims})
    ref = {k: daft_tpu.read_parquet(os.path.join(files, k)) for k in ("lineitem", "orders")}
    ref.update({k: daft_tpu.read_csv(csv[k]) for k in dims})
    text = cs.TPCH_SQL[5]
    assert scan_canonical(dt.sql(text, **port).optimized_plan()) == \
        scan_canonical(daft_tpu.sql(text, **ref)._builder.optimize().plan)
    manager().clear()
    ref_counters.reset()
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1):
        want = daft_tpu.sql(text, **ref).to_pydict()
    ref_snap = ref_counters.snapshot()
    counters.reset()
    with dt.execution_config_ctx(device="cpu"):
        got = dt.sql(text, **port).to_pydict()
    assert counters.device_join_batches == ref_snap.get("device_join_batches", 0) == 0
    assert counters.device_grouped_batches == ref_snap["device_grouped_batches"] == 1
    _same(got, want)
