"""chip_smoke.py refuses to report a result where it cannot drive the card:
without a CUDA card, and when it stands alone in a directory without the
port beside it. Both exit non-zero and print no {"ok": ...} line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA card" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_partkey_kernel_cases_get_the_stages_inputs(monkeypatch):
    """chip_smoke.py's kernel cases at the partkey cell's shapes feed K1, K2,
    K3 and K7 what the grouped stage itself passes them for that query (on
    the CPU, at a small size: 3,000 rows of 200 parts, bucket 4096, cap
    256), tensor for tensor."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import segment_kernels as sk

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    n, parts = 3000, 200
    rng = np.random.default_rng(7)
    cols = {"l_partkey": rng.permutation(np.arange(n) % parts + 1).astype(np.int64),
            "l_extendedprice": np.round(rng.uniform(900, 100_000, n), 2),
            "l_quantity": rng.integers(1, 51, n).astype(np.float64)}
    seen = {}
    for name in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes",
                 "segment_extreme_int64"):
        def record(*args, _name=name, _fn=getattr(sk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(sk, name, record)
    manager().clear()
    df = dt.from_pydict(cols)
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        (df.groupby("l_partkey")
         .agg(col("l_extendedprice").sum().alias("revenue"),
              col("l_partkey").count().alias("lines"),
              col("l_quantity").max().alias("top_qty"))
         .to_pydict())
    monkeypatch.setattr(cs, "BUCKET", 4096)
    monkeypatch.setattr(cs, "PARTKEY_CAP", 256)
    want = cs.partkey_inputs(cols, torch.device("cpu"))

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == 256 and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want["price"])
    (key, keep, _c, _cap, op), (rows, zero, _c2, _cap2, op2) = seen["segment_extreme_int64"]
    assert op == "max" and op2 == "min"
    assert same([key, keep, rows, zero],
                [want["qty_key"], want["keep"], want["rows"], want["zero"]])


def test_profile_counts_the_ports_own_kernel_activities(monkeypatch):
    """phase_profile holds a capture against the run's counted launches
    with the activities of the port's own kernels only: every __global__
    function of the package's csrc, the warp tier's (nested parentheses in
    its launch bounds) too; torch's elementwise kernels and copies do not
    count, nor a name that only ends in a kernel's name."""
    import re

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    names = cs.port_kernel_names()
    csrc = os.path.join(REPO, "daft_tpu_torch", "ops", "csrc")
    declared = sum(len(re.findall(r"__global__", open(os.path.join(csrc, f)).read()))
                   for f in os.listdir(csrc) if f.endswith(".cu"))
    assert len(names) == declared
    assert {"k7_warp_kernel", "k7_partial_kernel", "k7_merge_kernel", "plane_partial_kernel",
            "k3_partial_kernel", "probe_index_kernel", "bulk_transpose_kernel"} <= set(names)

    class Event:
        def __init__(self, key, count):
            self.key, self.count = key, count

    events = [Event("void (anonymous namespace)::k7_partial_kernel<float, 4, 2>((anonymous", 3),
              Event("(anonymous namespace)::k7_merge_kernel(double const*, int, int)", 3),
              Event("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor", 40),
              Event("Memcpy HtoD (Pageable -> Device)", 7),
              Event("void other::my_k7_partial_kernel<float>(float*)", 5)]
    assert cs.own_activities(events, names) == 6


def _small_tpch(cs):
    """chip_smoke.py's tables at a small size: 40,000 orders (about 160,000
    lineitem rows, enough for q19 to keep a few), 2,000 parts, 4,000
    customers."""
    return cs.tpch_sf1(11, n_orders=40_000, n_parts=2_000, n_customers=4_000)


@pytest.mark.parametrize("name", ["q14", "q19", "q3", "q10"])
def test_join_tail_oracles_match_the_port(monkeypatch, name):
    """chip_smoke.py's numpy oracles of the join tails equal the port's host
    path and its device path on the CPU (the one TopN run for q3 and q10)
    at a small size."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.tails_frames(lineitem, orders, dims)
    query, oracle, floats, topn = cs.TAILS[name]
    want = oracle(lineitem, orders, dims)
    if topn:
        want, margin = want
        assert margin is not None and margin > 0
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        assert cs.same_result(query(frames).to_pydict(), want, floats)
    counters.reset()
    with dt.execution_config_ctx(device="cpu"):
        assert cs.same_result(query(frames).to_pydict(), want, floats)
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 1 and snap["device_fallbacks"] == 0
    assert snap["device_topn_runs"] == int(topn)


def test_topn_kernel_cases_get_the_runs_inputs(monkeypatch):
    """chip_smoke.py's kernel cases at q3's shapes feed K1, K2 and K7 what
    q3's TopN run itself passes them (on the CPU, at a small size), tensor
    for tensor."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import grouped_stage
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops.stage import pad_bucket

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.tails_frames(lineitem, orders, dims)
    seen = {}
    for name in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes"):
        def record(*args, _name=name, _fn=getattr(sk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(sk, name, record)
    manager().clear()
    with dt.execution_config_ctx(device="cpu"):
        cs.q3_query(frames).to_pydict()
    bucket = pad_bucket(len(lineitem["l_orderkey"]))
    cap = grouped_stage._pad_groups(len(orders["o_orderkey"]))
    monkeypatch.setattr(cs, "BUCKET", bucket)
    monkeypatch.setattr(cs, "Q3_CAP", cap)
    want = cs.topn_inputs(lineitem, orders, dims, torch.device("cpu"))["q3"]

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == cap and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want["revenue"])
