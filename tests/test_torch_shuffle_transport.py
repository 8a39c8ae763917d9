"""The shuffle transport (daft_tpu_torch/distributed/shuffle.py and
fetch_server.py; counterpart of tests/test_shuffle_transport.py).

The port writes and reads its shuffle files with its own Arrow IPC
(io/arrow_ipc.py) where the reference uses pyarrow; both formats are the
same, so each file the port writes is read back by the reference's own
``read_partition`` (pyarrow) and equals the port's read, and files pyarrow
writes (the stream and the file container) are read by the port. Codec
roundtrips (LZ4_FRAME or none; "zstd" raises as io/arrow_ipc.py does),
multi-peer fan-in, bounded prefetch, truncated files, the serial path, the
recorder's cumulative and wall times, early closes, the config checks, and
two workers end to end over the socket transport against the reference's
single-process run (integer sums and counts exact, float sums rtol 1e-12).
"""

import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

import daft_tpu
import daft_tpu.distributed.shuffle as ref_shf
import daft_tpu_torch
import daft_tpu_torch.runners as runners
from daft_tpu_torch import col
from daft_tpu_torch.config import ExecutionConfig, execution_config_ctx
from daft_tpu_torch.core.recordbatch import RecordBatch
from daft_tpu_torch.distributed import shuffle as shf
from daft_tpu_torch.distributed.fetch_server import ShuffleFetchServer, fetch_partition
from daft_tpu_torch.observability.metrics import registry

CPU = dict(device="cpu")


def _batch(n=4000, offset=0):
    # repetitive values so lz4 has something to compress
    return RecordBatch.from_pydict({
        "k": np.array([offset + (i % 100) for i in range(n)], dtype=np.int64),
        "v": np.array([float(i % 13) for i in range(n)]),
    })


def _collect(parts):
    out = {}
    for p in parts:
        for k, vs in p.to_pydict().items():
            out.setdefault(k, []).extend(vs)
    return out


def _rows(d):
    return sorted(zip(d.get("k", []), d.get("v", [])))


def _ref_schema():
    from daft_tpu.datatype import DataType, Field
    from daft_tpu.schema import Schema

    return Schema([Field("k", DataType.int64()), Field("v", DataType.float64())])


# ---------------------------------------------------------------------------
# Codec roundtrips, container detection, the reference's reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "lz4"])
def test_compression_roundtrip_bit_exact(codec, tmp_path):
    b = _batch()
    w = shf.MapOutputWriter(str(tmp_path), "s1", 0, 1, compression=codec)
    before = registry().snapshot()
    w.append(0, b)
    w.close()
    deltas = registry().diff(before)
    path = os.path.join(shf.partition_dir(str(tmp_path), "s1", 0), "m0.arrow")
    wire = os.path.getsize(path)
    logical = b.size_bytes()
    assert deltas["shuffle_logical_bytes"] == logical
    assert deltas["shuffle_wire_bytes"] == wire
    if codec == "none":
        assert wire >= logical
    else:
        assert wire < logical, f"{codec} did not compress"
    got = list(shf.read_partition(str(tmp_path), "s1", 0, b.schema))
    merged = RecordBatch.concat([p.batches[0] for p in got])
    assert merged.to_pydict() == b.to_pydict()
    for c in ("k", "v"):
        assert merged.get_column(c).dtype == b.get_column(c).dtype
    # the reference's reader (pyarrow) reads the port's file to the same rows
    ref = list(ref_shf.read_partition(str(tmp_path), "s1", 0, _ref_schema()))
    assert _rows(_collect(ref)) == _rows(b.to_pydict())


def test_zstd_raises_naming_its_roadmap_entry(tmp_path):
    w = None
    with pytest.raises(NotImplementedError, match="entry 8"):
        w = shf.MapOutputWriter(str(tmp_path), "sz", 0, 1, compression="zstd")
    assert w is None


def test_reader_reads_the_references_files(tmp_path):
    """The reference's writer (pyarrow, lz4) and the port's reader: equal rows."""
    rb = daft_tpu.core.recordbatch.RecordBatch.from_pydict(
        {"k": [i % 100 for i in range(3000)], "v": [float(i % 13) for i in range(3000)]})
    ref_shf.write_map_output(str(tmp_path), "sr", 0, [[rb]], compression="lz4")
    got = _collect(shf.read_partition(str(tmp_path), "sr", 0, _batch(1).schema))
    assert _rows(got) == _rows(rb.to_pydict())


def test_reader_autodetects_legacy_file_format(tmp_path):
    """A shuffle file in the Arrow file container (pyarrow's file writer)
    decodes: the reader sniffs the ARROW1 magic."""
    b = _batch(500)
    d = shf.partition_dir(str(tmp_path), "old", 0)
    os.makedirs(d)
    t = pa.table({"k": pa.array(b.get_column("k").to_pylist(), pa.int64()),
                  "v": pa.array(b.get_column("v").to_pylist(), pa.float64())})
    with ipc.RecordBatchFileWriter(os.path.join(d, "m0.arrow"), t.schema) as w:
        w.write_table(t)
    got = _collect(shf.read_partition(str(tmp_path), "old", 0, b.schema))
    assert _rows(got) == _rows(b.to_pydict())

def test_streaming_read_yields_per_batch(tmp_path):
    """read_partition streams one MicroPartition per IPC batch — reduce-side
    memory is bounded by a batch, never the whole map file."""
    w = shf.MapOutputWriter(str(tmp_path), "s2", 0, 1, compression="lz4")
    for i in range(8):
        w.append(0, _batch(1000, offset=i * 1000))
    w.close()
    parts = list(shf.read_partition(str(tmp_path), "s2", 0, _batch(1).schema))
    assert len(parts) == 8, "map file was materialized instead of streamed"
    assert sum(p.num_rows for p in parts) == 8000


# ---------------------------------------------------------------------------
# Multi-peer fan-in, backpressure, errors
# ---------------------------------------------------------------------------

def test_multi_endpoint_fanin_merges_out_of_order(tmp_path):
    """Reduce-side fan-in over several endpoints: batches arrive in whatever
    order the peers produce them (a large file on one peer streams while the
    other peer's small files finish first); the merge must be exact."""
    d_big, d_small = str(tmp_path / "big"), str(tmp_path / "small")
    w = shf.MapOutputWriter(d_big, "s3", 0, 1, compression="lz4")
    for i in range(6):
        w.append(0, _batch(5000, offset=100 + i))
    w.close()
    w = shf.MapOutputWriter(d_small, "s3", 1, 1, compression="lz4")
    w.append(0, _batch(50, offset=7))
    w.close()
    expect = _rows(_collect(shf.read_partition(d_big, "s3", 0, _batch(1).schema))) \
        + _rows(_collect(shf.read_partition(d_small, "s3", 0, _batch(1).schema)))
    s_big, s_small = ShuffleFetchServer(d_big), ShuffleFetchServer(d_small)
    try:
        got = _collect(fetch_partition(
            [s_big.endpoint, s_small.endpoint], "s3", 0, _batch(1).schema,
            parallelism=2, prefetch=4))
        assert sorted(_rows(got)) == sorted(expect)
    finally:
        s_big.close()
        s_small.close()


def test_bounded_prefetch_backpressure(tmp_path):
    """The prefetch queue never exceeds the knob: a slow consumer
    backpressures the fetch threads instead of buffering the partition."""
    for m in range(3):
        w = shf.MapOutputWriter(str(tmp_path), "s4", m, 1, compression="lz4")
        for i in range(4):
            w.append(0, _batch(500, offset=m * 10 + i))
        w.close()
    registry().reset(["shuffle_fetch_inflight"])
    srv = ShuffleFetchServer(str(tmp_path))
    try:
        seen = 0
        for _p in fetch_partition([srv.endpoint], "s4", 0, _batch(1).schema,
                                  parallelism=2, prefetch=2):
            seen += 1
            time.sleep(0.01)  # slow reduce: producers must block, not buffer
        assert seen == 12
        hw = registry().snapshot().get("shuffle_fetch_inflight", 0)
        assert 0 < hw <= 2, f"prefetch queue exceeded the knob: {hw}"
    finally:
        srv.close()


@pytest.mark.parametrize("parallelism,prefetch", [(1, 0), (4, 4)])
def test_truncated_file_surfaces_clean_error(tmp_path, parallelism, prefetch):
    """A corrupted/truncated map file must raise promptly on the consumer —
    never hang the reduce task or silently drop rows."""
    w = shf.MapOutputWriter(str(tmp_path), "s5", 0, 1, compression="lz4")
    w.append(0, _batch(5000))
    w.close()
    path = os.path.join(shf.partition_dir(str(tmp_path), "s5", 0), "m0.arrow")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    srv = ShuffleFetchServer(str(tmp_path))
    try:
        t0 = time.monotonic()
        with pytest.raises(Exception) as ei:
            _collect(fetch_partition([srv.endpoint], "s5", 0, _batch(1).schema,
                                     parallelism=parallelism, prefetch=prefetch))
        assert time.monotonic() - t0 < 30, "truncated fetch hung"
        assert not isinstance(ei.value, (TimeoutError, AssertionError))
    finally:
        srv.close()


def test_accept_loop_survives_bad_handshakes(tmp_path):
    """Rejected handshakes (wrong auth key) must not kill or wedge the accept
    loop — subsequent authenticated fetches still work."""
    import multiprocessing.connection as mpc

    w = shf.MapOutputWriter(str(tmp_path), "s6", 0, 1, compression="none")
    w.append(0, _batch(100))
    w.close()
    srv = ShuffleFetchServer(str(tmp_path))
    try:
        host, port, key = srv.endpoint
        for _ in range(3):
            with pytest.raises(Exception):
                c = mpc.Client((host, port), family="AF_INET", authkey=b"wrong")
                c.close()
        got = _collect(fetch_partition([srv.endpoint], "s6", 0, _batch(1).schema,
                                       parallelism=2, prefetch=2))
        assert len(got["k"]) == 100
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Serial compatibility guard + recorder over-count fix
# ---------------------------------------------------------------------------

def test_serial_compat_path_matches_and_adds_no_counters(tmp_path):
    """shuffle_fetch_parallelism=1 + shuffle_prefetch_batches=0 +
    shuffle_compression=none reproduces the original serial transport: same
    rows, no pipelined-only counters (overlap/wall/inflight), whole-file
    'fetch' requests."""
    w = shf.MapOutputWriter(str(tmp_path), "s7", 0, 1, compression="none")
    for i in range(3):
        w.append(0, _batch(1000, offset=i))
    w.close()
    srv = ShuffleFetchServer(str(tmp_path))
    registry().reset(["shuffle_fetch_inflight"])
    try:
        expect = _rows(_collect(fetch_partition(
            [srv.endpoint], "s7", 0, _batch(1).schema, parallelism=4, prefetch=4)))
        before = registry().snapshot()
        got = _rows(_collect(fetch_partition(
            [srv.endpoint], "s7", 0, _batch(1).schema, parallelism=1, prefetch=0)))
        deltas = registry().diff(before)
        assert got == expect
        assert deltas.get("shuffle_bytes_fetched", 0) > 0
        for k in ("shuffle_overlap_seconds", "shuffle_fetch_wall_seconds"):
            assert k not in deltas, f"serial path recorded pipelined counter {k}"
    finally:
        srv.close()


def test_recorder_separates_cumulative_and_wall_fetch_time(tmp_path):
    """ShuffleRecorder.fetch_seconds sums per-request in-flight time and
    OVER-COUNTS once requests overlap (by design); fetch_wall_seconds is the
    union transfer window, and their difference is the recorded overlap."""
    for m in range(2):
        w = shf.MapOutputWriter(str(tmp_path), "s8", m, 1, compression="lz4")
        w.append(0, _batch(20_000, offset=m))
        w.close()
    srv = ShuffleFetchServer(str(tmp_path))
    rec = shf.ShuffleRecorder()
    shf.set_recorder(rec)
    try:
        _collect(fetch_partition([srv.endpoint], "s8", 0, _batch(1).schema,
                                 parallelism=2, prefetch=4))
        d = rec.as_dict()
        assert d["fetch_requests"] == 2
        assert d["fetch_wall_seconds"] > 0
        assert d["fetch_seconds"] > d["fetch_wall_seconds"], \
            "pipelined requests should make cumulative exceed wall"
        assert d["overlap_seconds"] == pytest.approx(
            d["fetch_seconds"] - d["fetch_wall_seconds"], rel=0.2)
        assert d["fetch_fanin"] >= 1
    finally:
        shf.set_recorder(None)
        srv.close()


def test_early_generator_close_cleans_up_and_accounts(tmp_path):
    """Closing the reduce iterator mid-partition must unwind the fetch
    threads promptly (no leaked daft-shuffle-fetch-client threads wedged in
    recv) and still account the wire bytes actually transferred."""
    import threading as _threading

    for m in range(4):
        w = shf.MapOutputWriter(str(tmp_path), "s9", m, 1, compression="lz4")
        for i in range(4):
            w.append(0, _batch(2000, offset=m * 10 + i))
        w.close()
    srv = ShuffleFetchServer(str(tmp_path))
    before = registry().snapshot()
    try:
        gen = fetch_partition([srv.endpoint], "s9", 0, _batch(1).schema,
                              parallelism=2, prefetch=2)
        next(gen)
        gen.close()  # runs the finally: stop event + thread join
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and any(
                t.name == "daft-shuffle-fetch-client" and t.is_alive()
                for t in _threading.enumerate()):
            time.sleep(0.05)
        leaked = [t for t in _threading.enumerate()
                  if t.name == "daft-shuffle-fetch-client" and t.is_alive()]
        assert not leaked, f"fetch threads leaked: {leaked}"
        assert registry().diff(before).get("shuffle_bytes_fetched", 0) > 0, \
            "abandoned fetch dropped its transferred bytes from the counters"
    finally:
        srv.close()


def test_serial_early_close_accounts_wire_bytes(tmp_path):
    """Serial path: a consumer stopping mid-file still records the file's
    wire bytes — they were fully received before the first yield."""
    w = shf.MapOutputWriter(str(tmp_path), "s10", 0, 1, compression="lz4")
    for i in range(3):
        w.append(0, _batch(1000, offset=i))
    w.close()
    srv = ShuffleFetchServer(str(tmp_path))
    before = registry().snapshot()
    try:
        gen = fetch_partition([srv.endpoint], "s10", 0, _batch(1).schema,
                              parallelism=1, prefetch=0)
        next(gen)
        gen.close()
        wire = os.path.getsize(os.path.join(
            shf.partition_dir(str(tmp_path), "s10", 0), "m0.arrow"))
        assert registry().diff(before).get("shuffle_bytes_fetched", 0) == wire
    finally:
        srv.close()


def test_shuffle_config_validation():
    with pytest.raises(ValueError, match="shuffle_compression"):
        ExecutionConfig(shuffle_compression="gzip")
    with pytest.raises(ValueError, match="shuffle_fetch_parallelism"):
        ExecutionConfig(shuffle_fetch_parallelism=0)
    with pytest.raises(ValueError, match="shuffle_prefetch_batches"):
        ExecutionConfig(shuffle_prefetch_batches=-1)


# ---------------------------------------------------------------------------
# Two workers end to end: the compressed socket shuffle, overlap, parity
# ---------------------------------------------------------------------------

def _groupby_cols(seed, n, keys):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).tolist(), "v": rng.uniform(0, 10, n).tolist(),
            "c": rng.integers(0, 5, n).tolist()}


def test_two_worker_compressed_shuffle_matches_reference():
    """Two workers, lz4, the socket transport: a shuffled groupby equals
    the reference's single-process run, ships fewer wire bytes than logical
    bytes, and records transfer overlap under the pipelined fetch."""
    from daft_tpu_torch.distributed.runner import DistributedRunner
    from daft_tpu_torch.observability.runtime_stats import StatsCollector, set_collector

    data = _groupby_cols(11, 30_000, 200)

    def q(pkg):
        c = pkg.col
        return (pkg.from_pydict(data).groupby("k")
                .agg(c("v").sum().alias("s"), c("c").sum().alias("cs"),
                     c("v").count().alias("n"))
                .sort("k"))

    expect = q(daft_tpu).to_pydict()
    with execution_config_ctx(shuffle_compression="lz4", shuffle_fetch_parallelism=4,
                              shuffle_prefetch_batches=8, device_mode="off", **CPU):
        r = DistributedRunner(num_workers=2, n_partitions=2, shuffle_transport="socket")
        try:
            before = registry().snapshot()
            runners.set_runner(r)
            set_collector(StatsCollector())
            try:
                got = q(daft_tpu_torch).to_pydict()
            finally:
                set_collector(None)
                runners.set_runner(None)
            deltas = registry().diff(before)
        finally:
            r.shutdown()
    assert got["k"] == expect["k"] and got["cs"] == expect["cs"] and got["n"] == expect["n"]
    np.testing.assert_allclose(got["s"], expect["s"], rtol=1e-12)
    wire = deltas.get("shuffle_wire_bytes", 0)
    logical = deltas.get("shuffle_logical_bytes", 0)
    assert 0 < wire < logical, f"compression did not pay: wire={wire} logical={logical}"
    assert deltas.get("shuffle_overlap_seconds", 0) > 0
    assert deltas.get("shuffle_fetch_seconds", 0) > deltas.get("shuffle_fetch_wall_seconds", 0)


def test_distributed_explain_analyze_shows_compression_and_fanin():
    """EXPLAIN ANALYZE of a socket-transport distributed run renders each
    stage's compression ratio and fetch fan-in."""
    from daft_tpu_torch.distributed.runner import DistributedRunner

    data = _groupby_cols(12, 20_000, 40)
    df = daft_tpu_torch.from_pydict({"k": data["k"], "v": data["v"]})
    with execution_config_ctx(shuffle_compression="lz4", device_mode="off", **CPU):
        r = DistributedRunner(num_workers=2, n_partitions=2, shuffle_transport="socket")
        runners.set_runner(r)
        try:
            report = df.groupby("k").agg(col("v").sum().alias("s")).explain_analyze()
        finally:
            runners.set_runner(None)
            r.shutdown()
    assert "compression:" in report and "wire" in report
    assert "fan-in" in report
    assert "cumulative" in report and "wall" in report
    assert "shuffle_wire_bytes" in report
