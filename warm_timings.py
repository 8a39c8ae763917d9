#!/usr/bin/env python3
"""Time the warm runs of chip_smoke.py's DataFrame cells, and the planning
in each, on one NVIDIA card.

    python3 warm_timings.py [--root DIR] [--runs N] [--cells A,B] [--profile]

Builds chip_smoke.py's SF1 tables and each cell's frames, runs every cell
once cold, then N warm runs each (7 by default; each ends in a
synchronize) and prints, per cell, the median and the runs, and the host
clock's medians of planning the cell's query 20 times: ``optimize()`` and
``translate()`` where the package has the optimizer, ``translate()`` of the
built plan where it has not. With ``--root`` it drives the daft_tpu_torch
of another checkout (for example an unpacked parent commit) through this
script's query builders, so that two versions are timed on one card in
turns (parent, tree, tree, parent): the warm medians of one cell move by up
to about 1 ms between phases and calls, so only turns in one call compare.
``--cells`` keeps the named cells only (the coalescer cell, ``coalesce``,
among them). ``--profile`` also prints, per cell, the host functions that
took the most time over its warm runs (cProfile, their own time per run).
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import chip_smoke as cs

PLANS = 20


def cells(lineitem, orders, dims) -> dict:
    """{cell: the query as a callable returning a DataFrame}."""
    import daft_tpu_torch as dt

    slice_df = dt.from_pydict({**{c: lineitem[c] for c in ("l_orderkey", "l_suppkey",
                                                           "l_linenumber")},
                               "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    q12 = cs.q12_frames(lineitem, orders)
    q1 = cs.q1_frame(lineitem)
    q6 = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                     "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    tails = cs.tails_frames(lineitem, orders, dims)
    q5 = cs.q5_frames(lineitem, orders, dims)
    topn = {"lineitem": dt.from_pydict({c: lineitem[c] for c in ("l_orderkey", "l_partkey",
                                                                  "l_quantity")}),
            "orders": dt.from_pydict({c: orders[c] for c in ("o_orderkey", "o_custkey")})}
    out = {"supplier": lambda: cs.supplier_query(slice_df),
           "q12": lambda: cs.q12_query(*q12),
           "q1": lambda: cs.q1_query(q1),
           "q6": lambda: cs.q6_query(q6)}
    for name in cs.TAILS:
        out[name] = (lambda query: lambda: query(tails))(cs.TAILS[name][0])
    _whole, cut, _n = cs.coalesce_frames(lineitem)
    out.update({"q1 chain": lambda: cs.q1_chain_query(q1),
                "q6 chain": lambda: cs.q6_chain_query(q6),
                "q5": lambda: cs.q5_query(q5),
                "topn order": lambda: cs.topn_sf1_query(topn),
                "coalesce": lambda: cs.coalesce_q6(cut)})
    return out


def plan_ms(query) -> dict:
    from daft_tpu_torch.plan import physical as pp

    frame = query()
    opt, tr = [], []
    for _ in range(PLANS):
        t0 = time.perf_counter()
        plan = frame.optimized_plan() if hasattr(frame, "optimized_plan") else frame._plan
        t1 = time.perf_counter()
        pp.translate(plan)
        opt.append(t1 - t0)
        tr.append(time.perf_counter() - t1)
    return {"optimize_ms": statistics.median(opt) * 1e3 if hasattr(frame, "optimized_plan")
            else None, "translate_ms": statistics.median(tr) * 1e3}


def host_profile(query, runs: int, top: int = 12) -> None:
    """The functions with the most own host time over ``runs`` warm runs
    (cProfile), in ms per run."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(runs):
        query().to_pydict()
        torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in stats.values())
    print(f"  host profile over {runs} warm runs: {total / runs * 1e3:.4f} ms a run in "
          f"profiled functions")
    for (path, line, fn), (_cc, calls, own, cum, _callers) in rows:
        where = f"{os.path.basename(path)}:{line}" if line else path
        print(f"    {own / runs * 1e3:.4f} ms own, {cum / runs * 1e3:.4f} ms with callees, "
              f"{calls / runs:g} calls a run: {fn} ({where})")


def run(card: str, runs: int, names=None, profile: bool = False) -> dict:
    import torch

    from daft_tpu_torch.ops import permute_kernels, probe_kernels, segment_kernels

    segment_kernels.build()
    probe_kernels.build()
    permute_kernels.build()
    lineitem, orders, dims = cs.tpch_sf1(cs.SEED)
    result = {}
    with cs.dt_ctx():
        for name, query in cells(lineitem, orders, dims).items():
            if names is not None and name not in names:
                continue
            cs.clear_residency()
            t0 = time.perf_counter()
            query().to_pydict()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            warm = cs.time_s(lambda: query().to_pydict(), runs)
            r = {"cold_s": cold, "warm_ms": statistics.median(warm) * 1e3,
                 "runs_ms": [w * 1e3 for w in warm], **plan_ms(query)}
            result[name] = r
            opt = "n/a" if r["optimize_ms"] is None else f"{r['optimize_ms']:.4f} ms"
            print(f"{name}: warm median {r['warm_ms']:.4f} ms (runs "
                  f"{', '.join(f'{w:.4f}' for w in r['runs_ms'])}); optimize {opt}, "
                  f"translate {r['translate_ms']:.4f} ms (host clock); cold {cold:.3f} s "
                  f"[{card}]", flush=True)
            if profile:
                host_profile(query, runs)
    return result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    parser.add_argument("--runs", type=int, default=7, help="warm runs per cell")
    parser.add_argument("--cells", default=None,
                        help="comma-separated cells to run (default: every cell)")
    parser.add_argument("--profile", action="store_true",
                        help="print each cell's host functions by own time (cProfile)")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"warm_timings.py: no daft_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, _ = cs.phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        result = run(card, args.runs, args.cells.split(",") if args.cells else None,
                     args.profile)
    except cs.SmokeFailure as exc:
        print(f"warm_timings.py: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
