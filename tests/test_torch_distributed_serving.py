"""The serving tier over the distributed workers (counterpart of the four
distributed cases of tests/test_serving.py, 411-539): speculative
duplicate dispatch (first result wins), speculation off by environment,
concurrent queries over one worker pool, the scheduler's round-robin
across streams (on both packages' schedulers), and ServingSession with a
``runner=``, several tenants' queries equal to their in-process runs and to
the reference's single-process runs (keys and integer aggregates exactly,
float sums rtol 1e-12).
"""

import os
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest

import daft_tpu
import daft_tpu.distributed.scheduler as ref_sched
import daft_tpu.distributed.task as ref_task
import daft_tpu_torch
import daft_tpu_torch.distributed.scheduler as port_sched
import daft_tpu_torch.distributed.task as port_task
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.observability.metrics import registry

# the latch task below travels to the workers by value: a worker then
# imports neither this module nor the reference package it imports
cloudpickle.register_pickle_by_value(sys.modules[__name__])


class _LatchTask:
    """A scan task whose first attempt creates the latch file and stalls; a
    later (speculative) attempt sees the latch and returns at once, so the
    duplicate wins the race."""

    filters_applied = True
    size_bytes = None
    source_label = "latch"

    def __init__(self, rows, latch=None, delay=0.0):
        self.rows = rows
        self.latch = latch
        self.delay = delay

    def read(self):
        from daft_tpu_torch.core.micropartition import MicroPartition

        if self.latch is not None and not os.path.exists(self.latch):
            open(self.latch, "w").close()
            time.sleep(self.delay)
        yield MicroPartition.from_pydict({"x": np.arange(self.rows, dtype=np.int64)})


def _scan_plan(task):
    from daft_tpu_torch.core.micropartition import MicroPartition
    from daft_tpu_torch.plan import physical as pp

    schema = MicroPartition.from_pydict({"x": np.zeros(1, dtype=np.int64)}).schema
    return pp.StreamingScan([task], schema, None, None)


def _pool(n):
    from daft_tpu_torch.distributed.worker import WorkerPool

    with execution_config_ctx(device="cpu"):
        return WorkerPool(n)


def test_speculative_duplicate_dispatch_first_result_wins(tmp_path, monkeypatch):
    from daft_tpu_torch.distributed.task import SubPlanTask

    monkeypatch.setenv("DAFT_TPU_SPECULATIVE_MIN_S", "0.1")
    monkeypatch.setenv("DAFT_TPU_STRAGGLER_K", "2.0")
    disp0 = registry().get("sched_speculative_dispatches")
    wins0 = registry().get("sched_speculative_wins")
    pool = _pool(2)
    try:
        tasks = [SubPlanTask.from_plan(f"fast-{i}", _scan_plan(_LatchTask(10)))
                 for i in range(3)]
        # a wide delay: the duplicate ends the stage as soon as it sees the
        # latch, so the delay costs nothing on the passing path
        straggler = SubPlanTask.from_plan(
            "straggler", _scan_plan(_LatchTask(10, latch=str(tmp_path / "latch"),
                                               delay=45.0)))
        results = pool.run_tasks(tasks + [straggler], stage_id="spec")
        assert set(results) == {"fast-0", "fast-1", "fast-2", "straggler"}
        assert all(r.rows == 10 for r in results.values())
    finally:
        pool.shutdown()
    assert registry().get("sched_speculative_dispatches") - disp0 >= 1
    assert registry().get("sched_speculative_wins") - wins0 >= 1


def test_speculation_disabled_by_env(tmp_path, monkeypatch):
    from daft_tpu_torch.distributed.task import SubPlanTask

    monkeypatch.setenv("DAFT_TPU_SPECULATIVE", "0")
    monkeypatch.setenv("DAFT_TPU_SPECULATIVE_MIN_S", "0.05")
    disp0 = registry().get("sched_speculative_dispatches")
    pool = _pool(2)
    try:
        tasks = [SubPlanTask.from_plan(f"f{i}", _scan_plan(_LatchTask(5))) for i in range(3)]
        slow = SubPlanTask.from_plan(
            "slow", _scan_plan(_LatchTask(5, latch=str(tmp_path / "l2"), delay=1.0)))
        results = pool.run_tasks(tasks + [slow], stage_id="nospec")
        assert len(results) == 4
    finally:
        pool.shutdown()
    assert registry().get("sched_speculative_dispatches") == disp0


def _tables():
    a = {"k": [i % 11 for i in range(40_000)], "v": [float(i % 301) for i in range(40_000)]}
    b = {"k": [i % 7 for i in range(30_000)], "v": [float(i % 97) for i in range(30_000)]}
    return a, b


def _qa(pkg, a):
    return pkg.from_pydict(a).groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")


def _qb(pkg, b):
    return pkg.from_pydict(b).groupby("k").agg(pkg.col("v").max().alias("m")).sort("k")


def _merged(parts):
    d = {}
    for p in parts:
        for k, v in p.to_pydict().items():
            d.setdefault(k, []).extend(v)
    return d


def test_concurrent_distributed_queries_one_pool():
    from daft_tpu_torch.distributed.runner import DistributedRunner

    a, b = _tables()
    ref_a, ref_b = _qa(daft_tpu, a).to_pydict(), _qb(daft_tpu, b).to_pydict()
    with execution_config_ctx(device="cpu"):
        runner = DistributedRunner(num_workers=2, n_partitions=2)
        try:
            outs, errs = {}, []

            def run(name, q):
                try:
                    outs[name] = _merged(runner.run(q()._plan))
                except Exception as e:  # noqa: BLE001 -- reported below
                    errs.append((name, e))

            ts = [threading.Thread(target=run, args=("a", lambda: _qa(daft_tpu_torch, a))),
                  threading.Thread(target=run, args=("b", lambda: _qb(daft_tpu_torch, b))),
                  threading.Thread(target=run, args=("a2", lambda: _qa(daft_tpu_torch, a)))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
        finally:
            runner.shutdown()
    assert not errs, errs
    assert outs["a"] == ref_a and outs["a2"] == ref_a
    assert outs["b"] == ref_b


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_scheduler_round_robin_across_streams(pkg):
    """Two concurrent stage streams share the workers one task per stream
    per rotation, on both packages' schedulers alike."""
    sched, task = (ref_sched, ref_task) if pkg == "reference" else (port_sched, port_task)
    s = sched.Scheduler({"w0": 1, "w1": 1})
    for i in range(4):
        s.submit(task.SubPlanTask(task_id=f"a{i}", plan_blob=b""), stream_key="qa")
    for i in range(2):
        s.submit(task.SubPlanTask(task_id=f"b{i}", plan_blob=b""), stream_key="qb")
    assigned = s.schedule()
    assert len(assigned) == 2
    assert {t.task_id[0] for t, _w in assigned} == {"a", "b"}
    for _t, w in assigned:
        s.task_finished(w)
    assert len(s.schedule()) == 2
    assert s.pending_count() == 2


def test_serving_session_through_the_runner():
    """ServingSession(runner=...) no longer raises: four tenants' grouped
    and ungrouped queries run through the runner, each equal to its
    in-process run and to the reference's, and every record says it did not
    run in process."""
    from daft_tpu_torch.distributed.runner import DistributedRunner
    from daft_tpu_torch.observability import Subscriber, attach_subscriber, detach_subscriber

    a, _b = _tables()

    def q_sum(pkg):
        return _qa(pkg, a)

    def q_total(pkg):
        return pkg.from_pydict(a).agg(pkg.col("v").sum().alias("t"))

    class Records(Subscriber):
        def __init__(self):
            self.recs = []

        def on_serve_query(self, rec):
            self.recs.append(rec)

    want = {"sum": q_sum(daft_tpu).to_pydict(), "total": q_total(daft_tpu).to_pydict()}
    recs = Records()
    attach_subscriber(recs)
    try:
        with execution_config_ctx(device="cpu"):
            local = {"sum": q_sum(daft_tpu_torch).to_pydict(),
                     "total": q_total(daft_tpu_torch).to_pydict()}
            runner = DistributedRunner(num_workers=2, n_partitions=2)
            try:
                with daft_tpu_torch.serving_session(max_concurrent=4, runner=runner) as sess:
                    futs = [(name, sess.submit(q(daft_tpu_torch), tenant=f"t{i}"))
                            for i in range(4) for name, q in (("sum", q_sum),
                                                              ("total", q_total))]
                    got = [(name, f.to_pydict(timeout=120)) for name, f in futs]
            finally:
                runner.shutdown()
    finally:
        detach_subscriber(recs)
    for name, res in got:
        assert res == local[name], name
        assert list(res) == list(want[name])
        for c in want[name]:
            np.testing.assert_allclose(res[c], want[name][c], rtol=1e-12)
    assert len(recs.recs) == 8 and not any(r.in_process for r in recs.recs)
