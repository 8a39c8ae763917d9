"""Single-host runner: optimize -> translate -> stream execute (counterpart
of daft_tpu/runners/native.py).

Every executing entry point goes through ``NativeRunner.run_iter``
(``DataFrame.collect`` / ``to_pydict``, SQL results, the writers,
``explain_analyze`` and ``metrics``). It owns the query lifecycle: with a
subscriber attached, ``on_query_start``, ``on_query_optimized``, one
``on_operator_stats`` per operator and ``QueryEnd`` with the query's
registry diff; with the flight recorder on (the default), one ring record
per query and the slow-query / error checks. With neither, the query runs
unobserved: no snapshot, no collector, no clock but the one timing it.

It also owns the query's placement scope (observability/placement.py): an
ambient one (``explain_placement``) wins; otherwise an observed query gets
its own, so ``QueryEnd.placements`` and the flight recorder's query record
carry the cost model's decisions; an unobserved query runs scope-less.
"""

from __future__ import annotations

from typing import Iterator, List

from ..core.micropartition import MicroPartition
from ..plan import logical as lp


class Runner:
    def run(self, plan: lp.LogicalPlan) -> List[MicroPartition]:
        return list(self.run_iter(plan))

    def run_iter(self, plan: lp.LogicalPlan) -> Iterator[MicroPartition]:
        raise NotImplementedError


class NativeRunner(Runner):
    def run_iter(self, plan: lp.LogicalPlan) -> Iterator[MicroPartition]:
        import time
        import uuid

        from ..config import execution_config
        from ..execution.executor import execute_plan
        from ..observability import (QueryEnd, QueryOptimized, QueryStart, flight, notify,
                                     placement, subscribers_active)
        from ..observability.runtime_stats import (StatsCollector, current_collector,
                                                   set_collector)
        from ..plan.optimizer import Optimizer
        from ..plan.physical import translate

        observed = subscribers_active()
        # the flight recorder records EVERY query (bounded ring, anomaly
        # triggers), not just subscriber-observed ones; None when disabled
        frec = flight.recorder()
        qid = uuid.uuid4().hex[:12] if (observed or frec is not None) else ""
        t_start = time.perf_counter()
        reg_before = {}
        if observed or frec is not None:
            from ..observability.metrics import registry

            # per-query engine-path attribution (device batches, launches,
            # spill bytes): counter deltas land in QueryEnd.metrics and the
            # flight ring's query record
            reg_before = registry().snapshot()
        if observed:
            notify("on_query_start", QueryStart(qid, plan.display()))
        t0 = time.perf_counter()
        optimized = Optimizer().optimize(plan)
        phys = translate(optimized)
        fkey = flight.plan_key(phys.display()) if frec is not None else ""
        if observed:
            notify("on_query_optimized", QueryOptimized(
                qid, optimized.display(), phys.display(), time.perf_counter() - t0))

        # inherit any ambient collector (explain_analyze routes through the
        # runner — it wins even with subscribers attached, who then see the
        # same collector's stats); save/restore around every pull so
        # interleaved queries on one thread never clobber each other's stats
        prev = current_collector()
        collector = prev if prev is not None else (StatsCollector() if observed else None)
        # the placement scope, with the same inheritance and save/restore
        prev_scope = placement.current_scope()
        pscope = prev_scope if prev_scope is not None \
            else (placement.PlacementScope() if observed else None)
        rows = 0
        err: str = None
        try:
            if execution_config().device_mode != "off":
                # a query asked to run on a missing card raises here
                from ..utils.torch_setup import resolve_device

                resolve_device(execution_config().device)
            set_collector(collector)
            placement.set_scope(pscope)
            try:
                stream = execute_plan(phys)
            finally:
                set_collector(prev)
                placement.set_scope(prev_scope)
            while True:
                set_collector(collector)
                placement.set_scope(pscope)
                try:
                    part = next(stream)
                except StopIteration:
                    break
                finally:
                    set_collector(prev)
                    placement.set_scope(prev_scope)
                rows += part.num_rows
                yield part
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            set_collector(prev)
            placement.set_scope(prev_scope)
            seconds = time.perf_counter() - t_start
            deltas = {}
            if observed or frec is not None:
                from ..observability.metrics import registry

                deltas = registry().diff(reg_before)
            placements = pscope.to_dicts() if pscope is not None else []
            if observed:
                stats = collector.finish() if collector else []
                for s in stats:
                    notify("on_operator_stats", qid, s)
                notify("on_query_end", QueryEnd(qid, rows, seconds, err, stats,
                                                metrics=deltas, placements=placements))
            if frec is not None:
                # always-on black box: the query record + the slow-query /
                # query-error anomaly checks (observability/flight.py)
                frec.note_query(fkey, seconds, query_id=qid, rows=rows, error=err,
                                metrics=deltas, placements=placements or None)
