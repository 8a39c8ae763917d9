"""The port's gateway (daft_tpu_torch/gateway/) against the reference's
(daft_tpu/gateway/): auth, framing, reconnect and resume by handle,
concurrent tenants, the result cache (hits, invalidation, eviction, thrash),
QoS caps and cancellation on the wire, the observability records and flight
anomalies, doctor's triage, and the restartable driver (kill -9 of
``python -m daft_tpu_torch.gateway --device cpu``, relaunch, resume from
checkpoints): the cases of tests/test_gateway.py, on the CPU. Answers are
held against the reference's SQL over the same columns (numpy planes
carried across with ``from_numpy_columns``).

Cross-wire: the reference's GatewayClient reads the port's GatewayServer
and the port's client the reference's server, with equal answers; the
frames the two packages write are byte for byte the same.
"""

import datetime
import os
import signal
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.gateway import (CachedResult, GatewayClient, GatewayError, GatewayServer,
                                    ResultCache)
from daft_tpu_torch.gateway import protocol as proto
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.observability.metrics import registry
from daft_tpu_torch.serving import FairAdmissionQueue, TenantQueueFull

from fault_injection import requires_fault_injection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPBY_SQL = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _cpu():
    with execution_config_ctx(device="cpu"):
        yield


def _columns(n=20_000, keys=13, salt=0):
    i = np.arange(n, dtype=np.int64)
    return {"k": i % keys, "v": ((i + salt) % 1009).astype(np.float64), "w": i % 83}


def _tables(n=20_000, keys=13, salt=0):
    """(reference frame, port frame) over the same numpy columns."""
    cols = _columns(n, keys, salt)
    ref = daft_tpu.from_pydict({k: v.tolist() for k, v in cols.items()})
    port = from_numpy_columns({k: (v, np.ones(n, dtype=bool)) for k, v in cols.items()},
                              {"k": dt.DataType.int64(), "v": dt.DataType.float64(),
                               "w": dt.DataType.int64()})
    return ref, port


def _table(n=20_000, keys=13, salt=0):
    return _tables(n, keys, salt)[1]


def _ref(ref_df, sql=GROUPBY_SQL):
    """The reference's answer over the reference frame."""
    return daft_tpu.sql(sql, t=ref_df).to_pydict()


def _client(srv, tenant="a", **kw):
    return GatewayClient(srv.host, srv.port, tenant=tenant, timeout=TIMEOUT, **kw)


# ---- auth and framing --------------------------------------------------------------


def test_bad_token_rejected_with_typed_error():
    with GatewayServer(tables={"t": _table()}, tokens={"acme": "s3cret"}) as srv:
        before = registry().get("gateway_auth_failures")
        with pytest.raises(GatewayError) as ei:
            _client(srv, tenant="acme", token="wrong")
        assert ei.value.code == "bad_token"
        with pytest.raises(GatewayError) as ei:
            _client(srv, tenant="nobody", token="s3cret")
        assert ei.value.code == "bad_token"
        assert registry().get("gateway_auth_failures") >= before + 2
        with _client(srv, tenant="acme", token="s3cret") as c:
            assert c.query("SELECT COUNT(*) AS n FROM t")["n"] == [20_000]


def test_open_mode_accepts_any_tenant():
    with GatewayServer(tables={"t": _table()}) as srv:
        with _client(srv, tenant="anyone") as c:
            assert c.query("SELECT COUNT(*) AS n FROM t")["n"] == [20_000]


def test_truncated_frame_gets_clean_error_and_server_survives():
    ref_df, df = _tables()
    with GatewayServer(tables={"t": df}) as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        s.sendall(struct.pack(">I", 100) + b"J" + b"x" * 9)
        s.close()
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        proto.send_json(s, {"verb": "hello", "tenant": "a", "token": ""})
        assert proto.recv_json(s)["ok"]
        s.sendall(struct.pack(">I", 1 << 31) + b"J")
        reply = proto.recv_json(s)
        assert reply["ok"] is False and reply["code"] == "frame_too_large"
        s.close()
        with _client(srv) as c:
            assert c.query(GROUPBY_SQL) == _ref(ref_df)


def test_hello_must_come_first():
    with GatewayServer(tables={"t": _table()}) as srv:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        proto.send_json(s, {"verb": "execute", "sql": GROUPBY_SQL})
        reply = proto.recv_json(s)
        assert reply["ok"] is False and reply["code"] == "bad_request"
        s.close()


# ---- prepared handles across reconnects --------------------------------------------


def test_reconnect_resumes_prepared_handle():
    ref_df, df = _tables()
    with GatewayServer(tables={"t": df}) as srv:
        c = _client(srv, tenant="acme")
        handle = c.prepare(GROUPBY_SQL)
        out1 = c.fetch_pydict(c.execute(handle=handle))
        c.close()
        with _client(srv, tenant="acme") as c2:
            out2 = c2.fetch_pydict(c2.execute(handle=handle))
        assert out1 == out2 == _ref(ref_df)


def test_unknown_handle_is_typed_and_client_reprepares():
    ref_df, df = _tables()
    with GatewayServer(tables={"t": df}) as srv:
        with _client(srv, tenant="acme") as c:
            with pytest.raises(GatewayError) as ei:
                c.execute(handle="feedfacedeadbeef01234567")
            assert ei.value.code == "unknown_handle"
            handle = c.prepare(GROUPBY_SQL)
            srv._handles.clear()
            assert c.fetch_pydict(c.execute(handle=handle)) == _ref(ref_df)


# ---- concurrent tenants ------------------------------------------------------------


def test_concurrent_tenants_bit_identical_to_in_process():
    ref_df, df = _tables(30_000)
    sqls = {
        "groupby": GROUPBY_SQL,
        "filter": "SELECT SUM(v) AS s FROM t WHERE w > 40",
        "minmax": "SELECT w, MIN(v) AS lo, MAX(v) AS hi FROM t GROUP BY w ORDER BY w",
    }
    ref = {name: dt.sql(s, t=df).to_pydict() for name, s in sqls.items()}
    for name, s in sqls.items():
        want = _ref(ref_df, s)
        assert list(ref[name]) == list(want)
        for col in want:
            np.testing.assert_allclose(ref[name][col], want[col], rtol=1e-12)
    failures = []
    with GatewayServer(tables={"t": df}, max_concurrent=2) as srv:

        def tenant_thread(tid):
            try:
                with _client(srv, tenant=f"tenant-{tid}") as c:
                    names = list(sqls)
                    for i in range(6):
                        name = names[(tid + i) % len(names)]
                        if c.query(sqls[name]) != ref[name]:
                            failures.append((tid, name))
            except Exception as e:  # noqa: BLE001 -- reported through the list
                failures.append((tid, repr(e)))

        threads = [threading.Thread(target=tenant_thread, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not failures, failures


# ---- the result cache --------------------------------------------------------------


def test_result_cache_hit_on_repeat_and_invalidation_on_source_change():
    ref_df, df = _tables(salt=0)
    with GatewayServer(tables={"t": df}) as srv:
        with _client(srv) as c:
            out1 = c.query(GROUPBY_SQL)
            assert c.last_source == "executed"
            out2 = c.query(GROUPBY_SQL)
            assert c.last_source == "result_cache"
            assert out1 == out2 == _ref(ref_df)
            ref_df2, df2 = _tables(salt=7)
            srv.set_table("t", df2)
            out3 = c.query(GROUPBY_SQL)
            assert c.last_source == "executed"
            assert out3 == _ref(ref_df2) and out3 != out1
            assert c.query(GROUPBY_SQL) == out3
            assert c.last_source == "result_cache"


def test_result_cache_bounded_eviction_under_tiny_budget():
    cache = ResultCache(budget_bytes=1000)

    def entry(size):
        return CachedResult([b"x" * size], rows=1, columns=["a"])

    before = registry().get("result_cache_evictions")
    cache.put("k1", entry(400))
    cache.put("k2", entry(400))
    assert cache.stats()["entries"] == 2
    cache.put("k3", entry(400))
    st = cache.stats()
    assert st["entries"] == 2 and st["bytes"] <= 1000
    assert cache.get("k1") is None
    assert cache.get("k3") is not None
    assert registry().get("result_cache_evictions") > before
    assert cache.put("huge", entry(2000)) is False
    assert cache.get("k3") is not None


def test_result_cache_zero_budget_disables():
    cache = ResultCache(budget_bytes=0)
    assert cache.put("k", CachedResult([b"x"], 1, ["a"])) is False
    assert cache.get("k") is None


def test_result_cache_thrash_detection(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_GATEWAY_THRASH_WINDOW", "8")
    cache = ResultCache(budget_bytes=100)
    for _ in range(4):
        cache.get("a")
        cache.get("b")
    detail = cache.note_thrash()
    assert detail is not None and "thrash" in detail
    assert cache.note_thrash() is None


def test_result_cache_tracks_the_host_ledger():
    """Under a host memory limit the cached bytes are tracked against the
    ledger and released when the cache clears."""
    from daft_tpu_torch.memory.manager import manager

    with execution_config_ctx(memory_limit_bytes=1 << 30):
        before = manager().tracked_bytes()
        cache = ResultCache(budget_bytes=10_000)
        cache.put("k", CachedResult([b"x" * 500], 1, ["a"]))
        assert manager().tracked_bytes() - before == 500
        cache.clear()
        assert manager().tracked_bytes() == before


# ---- QoS on the wire ---------------------------------------------------------------


def test_tenant_queue_cap_raises_tenant_queue_full(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_TENANT_QUEUE_CAP_CAPPED", "2")
    q = FairAdmissionQueue()
    q.push("capped", "x0")
    q.push("capped", "x1")
    with pytest.raises(TenantQueueFull):
        q.push("capped", "x2")
    for i in range(5):
        q.push("free", f"y{i}")


def test_tenant_weights_order(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_TENANT_WEIGHT_HEAVY", "3")
    q = FairAdmissionQueue()
    for i in range(6):
        q.push("heavy", f"h{i}")
    for i in range(3):
        q.push("light", f"l{i}")
    order = [q.pop(0) for _ in range(9)]
    assert order == ["h0", "h1", "h2", "l0", "h3", "h4", "h5", "l1", "l2"]


def test_over_capacity_maps_to_typed_wire_error():
    with GatewayServer(tables={"t": _table()}) as srv:
        def full(*a, **k):
            raise TenantQueueFull("a", 1, 1)
        srv._session.submit = full
        with _client(srv) as c:
            with pytest.raises(GatewayError) as ei:
                c.execute(sql="SELECT SUM(w) AS sw FROM t")
            assert ei.value.code == "over_capacity"


def test_cancel_queued_query_yields_typed_cancelled_error():
    ref_df, df = _tables()
    with GatewayServer(tables={"t": df}, max_concurrent=1) as srv:
        with _client(srv) as c:
            qid = c.execute(sql=GROUPBY_SQL)
            assert c.cancel(qid) in (True, False)
            try:
                assert c.fetch_pydict(qid) == _ref(ref_df)
            except GatewayError as e:
                assert e.code == "cancelled"


# ---- observability -----------------------------------------------------------------


def test_gateway_query_records_and_dashboard_rollup():
    import json as _json
    import urllib.request

    dash = dt.launch_dashboard()
    try:
        with GatewayServer(tables={"t": _table()}) as srv:
            with _client(srv, tenant="acme") as c:
                c.query(GROUPBY_SQL)
                c.query(GROUPBY_SQL)
        with urllib.request.urlopen(dash.url + "/api/gateway", timeout=10) as r:
            body = _json.load(r)
        acme = body["tenants"]["acme"]
        assert acme["queries"] == 2
        assert acme["executed"] == 1 and acme["result_cache"] == 1
        assert acme["cache_hit_rate"] == 0.5
        assert acme["bytes_streamed"] > 0
        assert body["counters"].get("result_cache_hits", 0) >= 1
    finally:
        dash.shutdown()


def test_gateway_error_and_thrash_are_flight_anomalies(monkeypatch, tmp_path):
    from daft_tpu_torch.observability import flight

    monkeypatch.setenv("DAFT_TPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_COOLDOWN_S", "0")
    flight._reset_for_tests()
    try:
        with GatewayServer(tables={"t": _table()}, tokens={"acme": "good"}) as srv:
            with pytest.raises(GatewayError):
                _client(srv, tenant="acme", token="bad")
            frec = flight.recorder()
            assert frec is not None
            assert frec.dumps, "auth failure produced no dump"
        with GatewayServer(tables={"t": _table(5000)}, result_cache_budget=64) as srv:
            with _client(srv) as c:
                for _ in range(40):
                    c.query(GROUPBY_SQL)
        assert "cache_thrash" in " ".join(frec.dumps), frec.dumps
    finally:
        flight._reset_for_tests()


def test_doctor_triages_gateway_dump():
    from daft_tpu_torch.tools.doctor import triage_dump

    dump = {
        "kind": "cache_thrash",
        "detail": "result-cache thrash: hit rate 0.10 over last 32 lookups",
        "ring": [],
        "metrics": {"result_cache_hits": 3, "result_cache_misses": 29,
                    "result_cache_evictions": 14, "result_cache_bytes": 512,
                    "gateway_connections_total": 5},
    }
    lines = "\n".join(triage_dump(dump, "dump.json"))
    assert "result-cache thrash" in lines
    assert "hit rate" in lines
    gw = {
        "kind": "gateway_error",
        "detail": "auth failure for tenant 'acme'",
        "ring": [],
        "metrics": {"gateway_auth_failures": 3, "gateway_connections_total": 7},
    }
    lines = "\n".join(triage_dump(gw, "gw.json"))
    assert "gateway error" in lines and "auth_failures=3" in lines


# ---- the restartable driver --------------------------------------------------------


def _spawn_gateway(ckpt_dir, rows=8000):
    """``python -m daft_tpu_torch.gateway --device cpu`` as a subprocess;
    the bound port from its banner."""
    env = dict(os.environ)
    env["DAFT_TPU_CHECKPOINT_DIR"] = str(ckpt_dir)
    proc = subprocess.Popen(
        [sys.executable, "-m", "daft_tpu_torch.gateway", "--port", "0", "--demo-rows",
         str(rows), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    banner = []
    t = threading.Thread(target=lambda: banner.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout=120)
    assert banner and banner[0], f"gateway printed no banner (rc={proc.poll()})"
    assert "gateway listening on" in banner[0], banner[0]
    host, port = banner[0].rsplit(" ", 1)[1].strip().rsplit(":", 1)
    return proc, host, int(port)


@requires_fault_injection
def test_kill9_gateway_mid_replay_relaunch_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    sqls = [
        "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k",
        "SELECT SUM(v) AS s FROM t WHERE w > 48",
        "SELECT w, MIN(v) AS lo FROM t GROUP BY w ORDER BY w",
    ]
    proc, host, port = _spawn_gateway(ckpt)
    try:
        c = GatewayClient(host, port, tenant="replay", timeout=120)
        first = {0: c.query(sqls[0]), 1: c.query(sqls[1])}
        assert c.last_source == "executed"
        c.execute(sql=sqls[2])
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        with pytest.raises((GatewayError, OSError, EOFError)):
            c.query(sqls[0])
        c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    proc2, host2, port2 = _spawn_gateway(ckpt)
    try:
        with GatewayClient(host2, port2, tenant="replay", timeout=120) as c2:
            out0 = c2.fetch_pydict(c2.execute(sql=sqls[0]))
            assert c2.last_source == "checkpoint", c2.last_source
            assert out0 == first[0]
            out1 = c2.fetch_pydict(c2.execute(sql=sqls[1]))
            assert c2.last_source == "checkpoint"
            assert out1 == first[1]
            out2 = c2.fetch_pydict(c2.execute(sql=sqls[2]))
            assert c2.last_source in ("executed", "checkpoint")
            assert len(out2["w"]) > 0
    finally:
        proc2.kill()
        proc2.wait(timeout=30)
    # the demo table's answers equal the reference's over the same rows
    i = np.arange(8000)
    ref_t = daft_tpu.from_pydict({"k": (i % 601).tolist(), "v": (i % 8191).astype(float).tolist(),
                                  "w": (i % 97).tolist()})
    assert out0 == daft_tpu.sql(sqls[0], t=ref_t).to_pydict()


def test_checkpoint_restore_across_server_instances(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFT_TPU_CHECKPOINT_DIR", str(tmp_path))
    ref_df, df = _tables()
    with GatewayServer(tables={"t": df}) as srv:
        with _client(srv) as c:
            out1 = c.query(GROUPBY_SQL)
            assert c.last_source == "executed"
    with GatewayServer(tables={"t": df}) as srv2:
        with _client(srv2) as c:
            out2 = c.query(GROUPBY_SQL)
            assert c.last_source == "checkpoint"
            assert out2 == out1 == _ref(ref_df)


# ---- cross-wire --------------------------------------------------------------------

_WIDE_SQL = ("SELECT s, k, SUM(v) AS sv, MIN(w) AS mw, MAX(d) AS last_day, COUNT(*) AS n "
             "FROM t GROUP BY s, k ORDER BY s, k")


def _wide_tables(n=12_000):
    """(reference frame, port frame): ints, floats, strings with nulls and
    dates, over the same numpy columns."""
    i = np.arange(n, dtype=np.int64)
    s = np.array([None if j % 17 == 0 else f"name-{j % 7}-é" for j in range(n)], dtype=object)
    d = (np.datetime64("1995-01-01") + (i % 900)).astype("datetime64[D]")
    cols = {"k": (i % 11, np.ones(n, bool)), "v": ((i % 1009) * 0.25, np.ones(n, bool)),
            "w": (i % 83, i % 5 != 0), "s": (s, s != None), "d": (d, np.ones(n, bool))}  # noqa: E711
    schema = {"k": dt.DataType.int64(), "v": dt.DataType.float64(), "w": dt.DataType.int64(),
              "s": dt.DataType.string(), "d": dt.DataType.date()}
    port = from_numpy_columns(cols, schema)
    ref = daft_tpu.from_pydict({
        "k": cols["k"][0].tolist(), "v": cols["v"][0].tolist(),
        "w": [int(v) if ok else None for v, ok in zip(*cols["w"])],
        "s": s.tolist(), "d": [datetime.date(1995, 1, 1) + datetime.timedelta(days=int(j % 900))
                               for j in i]})
    return ref, port


@pytest.mark.parametrize("compression", ["lz4", "none"])
def test_reference_client_reads_the_ports_server(compression):
    from daft_tpu.gateway import GatewayClient as RefClient

    ref_df, df = _wide_tables()
    want = daft_tpu.sql(_WIDE_SQL, t=ref_df).to_pydict()
    with execution_config_ctx(shuffle_compression=compression):
        with GatewayServer(tables={"t": df}) as srv, \
                RefClient(srv.host, srv.port, tenant="ref", timeout=TIMEOUT) as c:
            got = c.query(_WIDE_SQL)
            assert c.last_source == "executed"
            assert c.query(_WIDE_SQL) == got and c.last_source == "result_cache"
    assert got == want


@pytest.mark.parametrize("compression", ["lz4", "none"])
def test_ports_client_reads_the_reference_server(compression):
    from daft_tpu.config import execution_config_ctx as ref_ctx
    from daft_tpu.gateway import GatewayServer as RefServer

    ref_df, df = _wide_tables()
    want = dt.sql(_WIDE_SQL, t=df).to_pydict()
    with ref_ctx(shuffle_compression=compression, device_mode="off"):
        with RefServer(tables={"t": ref_df}) as srv, _client(srv, tenant="port") as c:
            got = c.query(_WIDE_SQL)
            assert c.last_source == "executed"
            batches = list(c.fetch(c.execute(sql=_WIDE_SQL)))
    assert got == want
    assert all(isinstance(b, dt.RecordBatch) for b in batches)


def test_frames_are_byte_identical_to_the_references():
    from daft_tpu.gateway import protocol as ref_proto

    class Sink:
        def __init__(self):
            self.data = b""

        def sendall(self, b):
            self.data += b

    for obj in ({"verb": "hello", "tenant": "a", "token": ""}, {"ok": False, "code": "x",
                                                                "error": "é"}):
        a, b = Sink(), Sink()
        proto.send_json(a, obj)
        ref_proto.send_json(b, obj)
        assert a.data == b.data
    a, b = Sink(), Sink()
    proto.send_frame(a, proto.TAG_BINARY, b"\x00\x01")
    ref_proto.send_frame(b, ref_proto.TAG_BINARY, b"\x00\x01")
    assert a.data == b.data
    assert proto.parse_token_map("a:1, b:2,bad,:x") == ref_proto.parse_token_map("a:1, b:2,bad,:x")
