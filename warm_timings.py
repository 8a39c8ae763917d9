#!/usr/bin/env python3
"""Time the warm runs of chip_smoke.py's DataFrame cells, and the planning
in each, on one NVIDIA card.

    python3 warm_timings.py [--root DIR] [--runs N]

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
    out.update({"q1 chain": lambda: cs.q1_chain_query(q1),
                "q6 chain": lambda: cs.q6_chain_query(q6),
                "q5": lambda: cs.q5_query(q5),
                "topn order": lambda: cs.topn_sf1_query(topn)})
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


def run(card: str, runs: int) -> dict:
    import torch

    from daft_tpu_torch.ops import permute_kernels, probe_kernels, segment_kernels

    segment_kernels.build()
    probe_kernels.build()
    permute_kernels.build()
    lineitem, orders, dims = cs.tpch_sf1(cs.SEED)
    result = {}
    with cs.dt_ctx():
        for name, query in cells(lineitem, orders, dims).items():
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
    return result


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    parser.add_argument("--runs", type=int, default=7, help="warm runs per cell")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"warm_timings.py: no daft_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, _ = cs.phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        result = run(card, args.runs)
    except cs.SmokeFailure as exc:
        print(f"warm_timings.py: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
