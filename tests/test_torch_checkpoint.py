"""The port's checkpoints (daft_tpu_torch/checkpoint/) against the
reference's (daft_tpu/checkpoint/).

- The stores' lifecycle and the checkpointed Parquet write: the cases of
  tests/test_connectors_checkpoint.py:123-180, the write's files read back
  by the reference's reader too.
- The stage checkpointer: a result of every type committed as Arrow IPC
  files and restored equal (the reference's pyarrow reads the files), a
  shuffle stage's files committed and restored, a torn commit left
  uncommitted, the TTL sweep, an unreadable checkpoint counted and skipped.
- ``query_fingerprint``: equal over equal content in another process,
  different when a value changes, None for a file scan; a device star join
  is keyed by its host translation.
- The zero-overhead contract: a query and a served query import nothing of
  checkpoint/stages.py.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow.ipc as ipc
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.checkpoint import FileCheckpointStore, MemoryCheckpointStore
from daft_tpu_torch.checkpoint.stages import StageCheckpointer, query_fingerprint, sweep_expired
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.core.micropartition import MicroPartition
from daft_tpu_torch.observability.metrics import registry
from daft_tpu_torch.plan.physical import translate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with execution_config_ctx(device="cpu"):
        yield


# ---- the stores and the checkpointed write -----------------------------------------


def test_checkpoint_lifecycle_memory():
    st = MemoryCheckpointStore()
    st.stage_keys("c1", [1, 2, 3])
    st.stage_files("c1", ["f1"])
    assert st.get_checkpointed_keys() == set()
    st.checkpoint("c1")
    assert st.get_checkpointed_keys() == {1, 2, 3}
    assert st.get_checkpointed_files() == ["f1"]
    st.mark_committed("c1")
    assert st.get_checkpointed_files() == []
    assert st.get_checkpointed_keys() == {1, 2, 3}
    with pytest.raises(ValueError):
        st.mark_committed("never-sealed")


def test_file_checkpoint_store_survives_restart(tmp_path):
    p = str(tmp_path / "ckpt.jsonl")
    st = FileCheckpointStore(p)
    st.stage_keys("c1", ["a", "b"])
    st.stage_files("c1", ["f1", "f2"])
    st.checkpoint("c1")
    st.mark_committed("c1")
    st.stage_keys("c2", ["c"])
    st.stage_files("c2", ["f3"])
    st.checkpoint("c2")
    st2 = FileCheckpointStore(p)
    assert st2.get_checkpointed_keys() == {"a", "b", "c"}
    assert st2.get_checkpointed_files() == ["f3"]
    # the reference's store reads the port's log, and the other way round
    from daft_tpu.checkpoint import FileCheckpointStore as RefStore

    ref = RefStore(p)
    assert ref.get_checkpointed_keys() == st2.get_checkpointed_keys()
    assert ref.get_checkpointed_files() == st2.get_checkpointed_files()


def test_checkpointed_write_skips_on_rerun(tmp_path):
    store = MemoryCheckpointStore()
    df = dt.from_pydict({"k": [1, 2, 3, 4], "v": ["a", "b", "c", "d"]})
    out_dir = str(tmp_path / "out")
    df.write_parquet(out_dir, checkpoint=(store, "k")).to_pydict()
    assert store.get_checkpointed_keys() == {1, 2, 3, 4}
    df2 = dt.from_pydict({"k": [3, 4, 5, 6], "v": ["c", "d", "e", "f"]})
    df2.write_parquet(out_dir, checkpoint=(store, "k")).to_pydict()
    assert store.get_checkpointed_keys() == {1, 2, 3, 4, 5, 6}
    back = dt.read_parquet(out_dir + "/**/*.parquet").sort("k").to_pydict()
    assert back["k"] == [1, 2, 3, 4, 5, 6]
    assert back["v"] == ["a", "b", "c", "d", "e", "f"]
    ref = daft_tpu.read_parquet(out_dir + "/**/*.parquet").sort("k").to_pydict()
    assert ref == back
    # the files each run sealed are the checkpoint's 2PC set
    assert len(store.get_checkpointed_files()) == 2


def test_checkpointed_write_all_skipped(tmp_path):
    store = MemoryCheckpointStore()
    df = dt.from_pydict({"k": [1, 2], "v": [1.0, 2.0]})
    d = str(tmp_path / "o")
    df.write_parquet(d, checkpoint=(store, "k")).to_pydict()
    df.write_parquet(d, checkpoint=(store, "k")).to_pydict()
    back = dt.read_parquet(d + "/**/*.parquet").sort("k").to_pydict()
    assert back["k"] == [1, 2]


# ---- the stage checkpointer --------------------------------------------------------


def _parts():
    d = datetime.date
    a = MicroPartition.from_pydict({
        "k": np.arange(5, dtype=np.int64), "v": [1.5, None, 3.0, 4.0, 5.0],
        "s": ["a", None, "é", "", "z"], "d": [d(2020, 1, 1), None, d(1970, 1, 1), d(1999, 9, 9),
                                              d(2001, 1, 1)],
        "l": [[1], None, [], [2, 3], [4]]})
    empty = MicroPartition(a.schema, [])
    return [a, empty, a]


@pytest.mark.parametrize("compression", ["lz4", "none"])
def test_result_commit_and_restore(tmp_path, compression):
    parts = _parts()
    with execution_config_ctx(shuffle_compression=compression):
        ck = StageCheckpointer(str(tmp_path), "q1")
        assert not ck.committed("result")
        assert ck.restore_result("result", parts[0].schema) is None
        c0 = registry().get("checkpoint_stages_committed")
        ck.commit_result("result", parts)
        assert registry().get("checkpoint_stages_committed") == c0 + 1
    assert ck.committed("result")
    back = StageCheckpointer(str(tmp_path), "q1").restore_result("result", parts[0].schema)
    assert [p.num_rows for p in back] == [5, 0, 5]
    assert [p.to_pydict() for p in back] == [p.to_pydict() for p in parts]
    # the reference's pyarrow reads the committed files
    with open(tmp_path / "q1" / "result" / "part0.arrow", "rb") as f:
        table = ipc.open_stream(f).read_all()
    assert table.to_pydict() == parts[0].to_pydict()


def test_result_commit_refuses_zstd(tmp_path):
    with execution_config_ctx(shuffle_compression="zstd"):
        with pytest.raises(NotImplementedError, match="zstd"):
            StageCheckpointer(str(tmp_path), "q").commit_result("result", _parts())
    assert not StageCheckpointer(str(tmp_path), "q").committed("result")
    assert not [n for n in os.listdir(tmp_path / "q") if "staging" in n]


def test_torn_and_unreadable_checkpoints(tmp_path):
    parts = _parts()
    ck = StageCheckpointer(str(tmp_path), "q")
    ck.commit_result("result", parts)
    # a payload without its marker is not committed
    os.remove(tmp_path / "q" / "result.committed")
    assert not ck.committed("result")
    ck.commit_result("result", parts)
    with open(tmp_path / "q" / "result" / "part0.arrow", "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 64)
    fails = registry().get("checkpoint_restore_failures")
    assert ck.restore_result("result", parts[0].schema) is None
    assert registry().get("checkpoint_restore_failures") == fails + 1


def test_shuffle_commit_and_restore(tmp_path):
    shuffle = tmp_path / "shuffle"
    (shuffle / "s1" / "p0").mkdir(parents=True)
    (shuffle / "s1" / "p0" / "map0.arrow").write_bytes(b"map-0")
    (shuffle / "s1" / "map1.arrow").write_bytes(b"map-1")
    ck = StageCheckpointer(str(tmp_path / "ckpt"), "q")
    ck.commit_shuffle("shuffle-0", str(shuffle), "s1", {0: (0, 1), 1: (1,)})
    live = tmp_path / "live"
    live.mkdir()
    sid, expected = ck.restore_shuffle("shuffle-0", str(live))
    assert expected == {0: (0, 1), 1: (1,)}
    assert (live / sid / "p0" / "map0.arrow").read_bytes() == b"map-0"
    assert (live / sid / "map1.arrow").read_bytes() == b"map-1"
    assert ck.restore_shuffle("shuffle-1", str(live)) is None


def test_ttl_sweep(tmp_path, monkeypatch):
    old = StageCheckpointer(str(tmp_path), "old")
    old.commit_result("result", _parts())
    os.utime(tmp_path / "old", (0, 0))
    gced0 = registry().get("checkpoint_stages_gced")
    assert sweep_expired(str(tmp_path), ttl_s=0) == 0  # no TTL: no sweep
    monkeypatch.setenv("DAFT_TPU_CHECKPOINT_TTL_S", "60")
    keep = StageCheckpointer(str(tmp_path), "old")  # opening never sweeps its own
    assert keep.committed("result")
    StageCheckpointer(str(tmp_path), "new")
    assert not (tmp_path / "old").exists()
    assert registry().get("checkpoint_stages_gced") == gced0 + 1


# ---- the query fingerprint ---------------------------------------------------------

_FP_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import daft_tpu_torch as dt
from daft_tpu_torch.checkpoint.stages import query_fingerprint
from daft_tpu_torch.plan.physical import translate
df = dt.from_pydict({{"k": np.arange(1000) % 7, "v": np.arange(1000) * 0.5,
                      "s": np.array(["x%d" % (i % 5) for i in range(1000)], dtype=object)}})
with dt.execution_config_ctx(device="cpu"):
    q = dt.sql("SELECT s, SUM(v) AS t FROM t WHERE k > 2 GROUP BY s ORDER BY s", t=df)
    print(query_fingerprint(translate(q.optimized_plan())))
"""


def _fp_frame(bump=0.0):
    return dt.from_pydict({"k": np.arange(1000) % 7, "v": np.arange(1000) * 0.5 + bump,
                           "s": np.array([f"x{i % 5}" for i in range(1000)], dtype=object)})


def _fp(df, sql="SELECT s, SUM(v) AS t FROM t WHERE k > 2 GROUP BY s ORDER BY s"):
    return query_fingerprint(translate(dt.sql(sql, t=df).optimized_plan()))


def test_query_fingerprint_is_stable_and_follows_the_content():
    proc = subprocess.run([sys.executable, "-c", _FP_SCRIPT.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    here = _fp(_fp_frame())
    assert here is not None and proc.stdout.strip() == here
    assert _fp(_fp_frame(bump=1e-9)) != here
    assert _fp(_fp_frame(), "SELECT s, SUM(v) AS t FROM t WHERE k > 3 GROUP BY s "
                            "ORDER BY s") != here


def test_query_fingerprint_refuses_a_file_scan(tmp_path):
    _fp_frame().write_parquet(str(tmp_path / "f"))
    assert _fp(dt.read_parquet(str(tmp_path / "f"))) is None


def test_a_device_star_join_is_keyed_by_its_host_translation():
    from daft_tpu_torch.plan import physical as pp

    o = dt.from_pydict({"o_orderkey": np.arange(200), "o_p": np.array(["a", "b"] * 100,
                                                                      dtype=object)})
    li = dt.from_pydict({"l_orderkey": np.arange(4000) % 200, "q": np.ones(4000)})
    sql = ("SELECT o_p, SUM(q) AS s FROM o, l WHERE o_orderkey = l_orderkey GROUP BY o_p "
           "ORDER BY o_p")
    with execution_config_ctx(device_mode="on", device_min_rows=1):
        phys = translate(dt.sql(sql, o=o, l=li).optimized_plan())
        assert any(isinstance(n, pp.DeviceJoinAgg) for n in phys.walk())
        fp = query_fingerprint(phys)
        again = query_fingerprint(translate(dt.sql(sql, o=o, l=li).optimized_plan()))
    assert fp is not None and fp == again


# ---- the zero-overhead contract ----------------------------------------------------

_ZERO = """
import sys
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
df = dt.from_pydict({{"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}})
with dt.execution_config_ctx(device="cpu"):
    df.groupby("k").agg(col("v").sum()).to_pydict()
    with dt.serving_session(max_concurrent=1) as s:
        s.run(df.groupby("k").agg(col("v").sum()), timeout=60)
print(sorted(m for m in sys.modules if m.startswith("daft_tpu_torch.checkpoint")))
"""


def test_no_checkpoint_code_without_a_checkpoint_dir():
    env = {k: v for k, v in os.environ.items() if k != "DAFT_TPU_CHECKPOINT_DIR"}
    proc = subprocess.run([sys.executable, "-c", _ZERO.format(repo=REPO)], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().replace("'", '"')) == []
