"""The port's console entry point (daft_tpu_torch/cli.py, ``python -m
daft_tpu_torch``) and doctor (daft_tpu_torch/tools/doctor.py) against the
reference's (daft_tpu/cli.py, daft_tpu/tools/doctor.py).

- ``schema`` and ``sql`` over the same Parquet file print what the
  reference prints (tests/test_cli_progress.py:10-27); ``info`` names the
  package, torch, the card and the execution config; ``--device`` sets
  where the queries' device stages run (the default "cuda" raises with no
  card); ``bench`` exits non-zero.
- doctor: ``--compare`` over the committed SF10 capture pair
  (tests/test_flight_recorder.py:322) and the triage of the port's own
  flight dumps (:339) print what the reference's doctor prints.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import daft_tpu_torch as dt
from daft_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def table(tmp_path):
    with dt.execution_config_ctx(device="cpu"):
        dt.from_pydict({"a": [3, 1, 2], "b": ["x", "y", "z"]}).write_parquet(
            str(tmp_path / "t"))
    return str(tmp_path / "t" / "*.parquet")


def test_cli_schema_and_sql(table, capsys):
    from daft_tpu.cli import main as ref_main

    assert main(["schema", table, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "a: Int64" in out and "b: String" in out
    assert ref_main(["schema", table]) == 0
    assert capsys.readouterr().out == out

    query = ["sql", "SELECT a FROM t ORDER BY a DESC", "-t", f"t={table}"]
    assert main(query + ["--json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip()) == {"a": [3, 2, 1]}
    assert ref_main(query + ["--json"]) == 0
    assert capsys.readouterr().out == out
    assert main(query + ["--device", "cpu", "--limit", "2"]) == 0
    assert capsys.readouterr().out.splitlines() == ["a", "3", "2"]


def test_cli_info(capsys):
    assert main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "daft_tpu" in out and "execution config" in out
    assert f"torch {torch.__version__}" in out and "device='cpu'" in out


def test_cli_device_defaults_to_the_card(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sql", "SELECT SUM(a) AS s FROM t", "-t", f"t={table}"])


def test_cli_bench_is_not_written(capsys):
    assert main(["bench"]) != 0
    assert "benchmark is not written yet" in capsys.readouterr().err


def test_python_m_entry_point(table):
    proc = subprocess.run([sys.executable, "-m", "daft_tpu_torch", "sql",
                           "SELECT b FROM t WHERE a > 1 ORDER BY b", "-t", f"t={table}", "--json",
                           "--device", "cpu"],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"b": ["x", "z"]}


# ---- doctor ------------------------------------------------------------------------


def test_doctor_compare_names_regressed_operators_and_counters():
    args = ["--compare", "BENCH_SF10_r04.json", "BENCH_SF10_r05.json"]
    out = subprocess.run([sys.executable, "-m", "daft_tpu_torch.tools.doctor"] + args,
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "q1" in text and "46.8" in text
    assert "device_batches: 4 -> 0" in text
    assert "rss_high_water_bytes" in text
    assert "streaming-scan / host-ledger" in text
    assert "cpu backend" in text
    ref = subprocess.run([sys.executable, "-m", "daft_tpu.tools.doctor"] + args,
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert ref.stdout == text


def test_doctor_reads_the_ports_flight_dump(monkeypatch, tmp_path):
    from daft_tpu_torch.observability import flight

    monkeypatch.setenv("DAFT_TPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_RING", "8")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_WALL_K", "1.0")
    monkeypatch.setenv("DAFT_TPU_ANOMALY_MIN_S", "0.0")
    monkeypatch.setenv("DAFT_TPU_ANOMALY_COOLDOWN_S", "0.0")
    flight._reset_for_tests()
    try:
        rec = flight.recorder()
        rec.record("admission", tenant="t0", query_id="qa", wait_s=0.25, est_pin_bytes=1 << 20)
        rec.note_query("p1", 0.05, query_id="q1", rows=10)
        rec.note_worker_death("worker-1", "connection closed")
        rec.note_query("p1", 0.01, query_id="q2", rows=10, error="RuntimeError: shard lost")
    finally:
        flight._reset_for_tests()
    dumps = sorted(str(p) for p in tmp_path.glob("flight_*.json"))
    assert dumps
    out = subprocess.run([sys.executable, "-m", "daft_tpu_torch.tools.doctor"] + dumps,
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "shard lost" in out.stdout
    assert "worker death" in out.stdout
    assert "findings (ranked):" in out.stdout
    assert "admission wait" in out.stdout
    ref = subprocess.run([sys.executable, "-m", "daft_tpu.tools.doctor"] + dumps,
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert ref.stdout == out.stdout
