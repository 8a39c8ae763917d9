#!/usr/bin/env python3
"""Where a distributed q1 spends its time on the card: the q1 cell of
``chip_smoke.py``'s dist phase (SF1 lineitem, l_extendedprice's min and
max) taken apart.

    python3 dist_timings.py [--root DIR] [--runs 2]

Builds the kernels (``chip_smoke.phase_build``) and the SF1 tables, then:

1. one partial fragment (half of lineitem under the DeviceGroupedAgg the
   planner ships): its pickle's seconds and bytes; ``--runs`` times its
   pickle sent to a fresh process through a multiprocessing connection
   (the socket the pool's workers listen on) against written to a file
   whose path is sent (what the pool does) and read there; and ``--runs``
   times its unpickling and its execution in this process on the card, each
   execution under cProfile (the top functions by cumulative and by own
   time);
2. ``--runs`` traced runs of the q1 through DistributedRunner(2 workers, 2
   partitions, both leased the card): wall seconds, and for every task its
   stage, worker, exec seconds, queue wait (submit to dispatch), schedule
   latency (dispatch to start), operator stats and the residency counters
   of its engine counters; the coordinator under cProfile.

Everything prints on the host's clock; the card's name and power limit
come first. It imports torch, numpy, the port and ``chip_smoke``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _top(pr, key: str, n: int) -> str:
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats(key).print_stats(n)
    return s.getvalue()


_RECEIVER = """
import sys
from multiprocessing.connection import Client

conn = Client(sys.argv[1], "AF_UNIX", authkey=bytes.fromhex(sys.argv[2]))
while True:
    msg = conn.recv()
    if msg is None:
        break
    if isinstance(msg, str):
        with open(msg, "rb") as f:
            msg = f.read()
    conn.send(len(msg))
"""


def transport_times(blob: bytes, runs: int) -> None:
    """Seconds to hand ``blob`` to a fresh process: through a
    multiprocessing connection, and as a file written here and read there."""
    import shutil
    import subprocess
    import tempfile
    from multiprocessing.connection import Listener

    d = tempfile.mkdtemp(prefix="dist_timings_")
    key = os.urandom(16)
    path = os.path.join(d, "plan")
    try:
        with Listener(os.path.join(d, "s.sock"), "AF_UNIX", authkey=key) as lst:
            proc = subprocess.Popen([sys.executable, "-c", _RECEIVER, lst.address, key.hex()])
            conn = lst.accept()
            try:
                for rep in range(runs):
                    t0 = time.perf_counter()
                    conn.send(blob)
                    assert conn.recv() == len(blob)
                    sock_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    with open(path, "wb") as f:
                        f.write(blob)
                    conn.send(path)
                    assert conn.recv() == len(blob)
                    file_s = time.perf_counter() - t0
                    print(f"transport {rep}: socket {sock_s:.3f} s, file {file_s:.3f} s, "
                          f"{len(blob)} bytes", flush=True)
            finally:
                conn.send(None)
                conn.close()
                proc.wait(timeout=60)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def fragment_times(cs, lineitem, runs: int) -> None:
    from daft_tpu_torch.distributed.planner import _split_partitions
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.execution.executor import execute_plan
    from daft_tpu_torch.plan import physical as pp
    from daft_tpu_torch.plan.optimizer import Optimizer

    df = cs.q1_frame(lineitem)
    with cs.dt_ctx():
        cs.q1_query(df, extremes=True).to_pydict()
        phys = pp.translate(Optimizer().optimize(cs.q1_query(df, extremes=True)._plan))
        print(phys.display())
        agg = next(n for n in phys.walk() if isinstance(n, pp.DeviceGroupedAgg))
        half = _split_partitions(agg.input.partitions, 2, agg.input.schema)[0]
        frag = pp.DeviceGroupedAgg(pp.InMemoryScan(half, agg.input.schema), agg.predicate,
                                   agg.groupby, agg.aggregations, agg.schema, agg.region_ops)
        t0 = time.perf_counter()
        task = SubPlanTask.from_plan("fragment", frag)
        print(f"pickle {time.perf_counter() - t0:.3f} s, {len(task.plan_blob)} bytes",
              flush=True)
        transport_times(task.plan_blob, runs)
        for rep in range(runs):
            t0 = time.perf_counter()
            plan = task.plan()
            print(f"unpickle {time.perf_counter() - t0:.3f} s", flush=True)
            pr = cProfile.Profile()
            pr.enable()
            t0 = time.perf_counter()
            list(execute_plan(plan))
            print(f"exec {rep} {time.perf_counter() - t0:.3f} s", flush=True)
            pr.disable()
            print(_top(pr, "cumulative", 30)[:6000])
            print(_top(pr, "tottime", 20)[:4000])


def runner_times(cs, lineitem, runs: int) -> None:
    import daft_tpu_torch.runners as runners
    from daft_tpu_torch.distributed import DistributedRunner
    from daft_tpu_torch.observability.runtime_stats import StatsCollector, set_collector

    df = cs.q1_frame(lineitem)
    with cs.dt_ctx():
        r = DistributedRunner(num_workers=2, n_partitions=2, device_workers=2)
        try:
            for rep in range(runs):
                runners.set_runner(r)
                set_collector(StatsCollector())
                pr = cProfile.Profile()
                pr.enable()
                t0 = time.perf_counter()
                try:
                    cs.q1_query(df, extremes=True).to_pydict()
                finally:
                    el = time.perf_counter() - t0
                    pr.disable()
                    set_collector(None)
                    runners.set_runner(None)
                print(f"DIST {rep} {el:.3f} s", flush=True)
                for ts in r.last_trace.tasks:
                    print(f"  {ts.stage_id} {ts.worker_id} exec {ts.exec_s:.3f} "
                          f"qwait {ts.queue_wait_s:.3f} sched {ts.schedule_latency_s:.3f}")
                    for o in ts.operator_stats:
                        print(f"     op {o.name} {o.seconds:.3f} {o.rows_out}")
                    ec = dict(ts.engine_counters)
                    print("     ec", {k: v for k, v in ec.items()
                                      if "ms" in k or "hbm" in k or "fingerprint" in k})
                print(_top(pr, "cumulative", 25)[:5000])
        finally:
            r.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    parser.add_argument("--runs", type=int, default=2)
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs

    card, _name = cs.phase_card()
    cs.phase_build(card)
    lineitem, _orders, _dims = cs.tpch_sf1(cs.SEED)
    fragment_times(cs, lineitem, args.runs)
    runner_times(cs, lineitem, args.runs)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
