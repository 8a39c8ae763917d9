#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past an
error (no phase catches its own failure):

1. card:    print the card's name and power limit (nvidia-smi) and
            torch.cuda.get_device_name(0); fail when no card is found;
2. build:   build the hand-written kernels from ops/csrc (nvcc, one process
            per source, all started together) and print the build seconds;
   data:    generate TPC-H lineitem (about 6.0 M rows) and orders (1.5 M
            rows) at SF1 with numpy from a fixed seed, in the value domains
            of benchmarking/tpch/datagen.py (string columns as codes mapped
            through a small object array);
3. kernels: at the slices' shapes run each kernel on inputs built from the
            generated tables and require the same output as its plain
            PyTorch version; time the kernel, the plain version, one PyTorch
            library call computing the same function where there is one, and
            print the bound. Segment kernels at the supplier query's shapes
            (N = 2^23 rows, cap = 16384, P = 15 separate planes, as the
            stage passes them; Q = 1 for K2; K3's four launches, int64 min
            and max of l_shipdate and l_orderkey; K1a on the (N, 15) stack
            of K1's planes, also equal to K1's output cast to f32), K1
            (P = 5) and K2 (Q = 1) again at q12's cap 8, K1, K2, K3 and K1a
            again at cap 2^17 (l_partkey folded into 2^17 groups) and at
            cap 8 (every kept row on l_shipmode's 7 codes), and K1 on 73
            planes at cap 4096 (past one 64-plane chunk). K1's, K2's and
            K1a's bound counts the bytes the function needs (a trash row's
            plane values are not), beside every input read once; K4 at q12's
            (orders' 1.5 M keys into a 2^22-slot table, 2^23 lineitem keys
            probed, then the same keys shifted past the largest order key:
            every probe misses and walks to an empty slot). K4's build is
            compared as the sorted set of its (key, row) entries: where a
            key lands depends on the order the threads claim their slots.
            K5 on K4's table (lineitem's keys, orders' high/low priority
            planes) at q12's shapes (q12's ship-mode codes), equal to q12's
            oracle for MAIL and SHIP, and with every real row kept on its
            ship mode (about 6.0 M probes that hit), equal to a per-mode
            numpy count; its bound reads each distinct kept key's slot and
            each matched dim row's planes once; probe_timings.py times K5
            through the same functions. K6 at the repartition cell's shapes (8 x 8 blocks of
            23 x 2^20 + 4 words). Every kernel also by its device time under
            torch.profiler (K4's build with the table's clearing, where it
            has one). K1a and K5 have no engine caller, in the port or in
            the reference: they are held here alone;
4. slice:   the per-supplier shipment summary over lineitem through the port
            with device="cuda", device_mode="on"; the counters are zeroed
            just before that run and read just after it. The result must equal
            the port's host path and an independent numpy oracle exactly,
            K1-K3 must show launches, and no stage may fall back. Then the
            warm query time (median of 3) and peak device memory;
5. profile: one more warm supplier query under torch.profiler, for the
            device's busy time and idle share and its longest activities;
6. q12:     TPC-H q12 (lineitem joined to orders, grouped by ship mode)
            through the port with device="cuda", the counters zeroed just
            before the cold run and read just after it: K4 (build and
            probe), K1 and K2 must show launches, with at least one device
            join batch and no fallback, and the result must equal the host
            path and a numpy oracle exactly. Then the warm query (median of
            3, which must launch K4 zero times: its index plane is resident),
            peak device memory, and one warm query under torch.profiler;
7. repartition: lineitem's eight numeric columns at SF1 (about 6.0 M rows)
            repartitioned by ``l_orderkey`` into 8 partitions over a mesh of
            8 shard slots on the card (mesh_devices=8), the counters zeroed
            just before the run and read just after it: K6 must launch once,
            with no all_to_all dispatch. Every partition must equal the
            port's host path and a numpy oracle (splitmix64 of the key bits
            mod 8, rows in input order), rows in order; then the
            kernel_mode="off" tier (all_to_all) must give the same
            partitions. Then the wall time (median of 3), peak device memory
            and one run under torch.profiler;
8. print the {"kernels": [...]} line, the card line, and last the
   {"ok": true, "device": {...}} line.

Every cell runs at SF1: nothing is cut. It imports torch, numpy and the
port; nothing of JAX, pyarrow or daft_tpu.

    python3 chip_smoke.py --kernels-only [--root DIR]

runs phases 1-3 alone, on the daft_tpu_torch of the checkout at DIR (by
default the one beside this script): to time an unpacked parent commit's
kernels and this tree's in one call, on one card, in turns. The checkout
must take the same kernel arguments as this script's package: an older
parent is driven by its own unpacked chip_smoke.py.
"""

from __future__ import annotations

import datetime
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 20261016
SF1_ORDERS = 1_500_000
SF1_SUPPLIERS = 10_000
BUCKET = 1 << 23          # 6.0 M rows pad to this bucket
CAP = 16384               # 10,000 suppliers pad to this group capacity
Q12_CAP = 8               # 7 ship modes pad to this group capacity
K3_SMALL_CAP = 8          # K3 with every kept row on l_shipmode's 7 codes
K3_LARGE_CAP = 1 << 17    # K3 (and K1, K2) at the kernel tier's segment ceiling
WIDE_CAP, WIDE_PLANES = 4096, 73  # K1 past one 64-plane chunk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
EPOCH = datetime.date(1970, 1, 1)
D_1992 = (datetime.date(1992, 1, 1) - EPOCH).days
D_1998 = (datetime.date(1998, 12, 1) - EPOCH).days
CUTOFF = datetime.date(1998, 9, 2)  # TPC-H Q1's ship-date predicate
Q12_FROM, Q12_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
# benchmarking/tpch/datagen.py:36-37
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SF1_PARTS = 200_000
MESH = 8                  # the repartition cell's partitions and shard slots
SEGMENT_SOURCE = "daft_tpu_torch/ops/csrc/segment_reduce.cu"
PROBE_SOURCE = "daft_tpu_torch/ops/csrc/hash_probe.cu"
PERMUTE_SOURCE = "daft_tpu_torch/ops/csrc/ring_permute.cu"
KERNELS = {  # name -> (source, the TPU kernel or host function it replaces)
    "segment_sum_planes": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:129"),
    "segment_extreme_planes": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:184"),
    "segment_extreme_int64": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:248"),
    "hash_probe_build": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:310"),
    "hash_probe_index": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:369"),
    "segment_sum_planes_f32": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:82"),
    "hash_probe_segment_sum": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:421"),
    "ring_permute_words": (PERMUTE_SOURCE, "daft_tpu/ops/pallas_kernels.py:515"),
}
# the repartition cell's columns: lineitem's numeric ones
REPART_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
                  "l_extendedprice", "l_discount", "l_tax")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---- data ----------------------------------------------------------------------


def tpch_sf1(seed: int):
    """(lineitem columns, orders columns) of every cell, with the value
    domains of the repo's TPC-H generator (benchmarking/tpch/datagen.py:
    36-37, 160-190). Dates are int32 days; ``l_shipmode`` and
    ``o_orderpriority`` are int8 codes into SHIPMODES and PRIORITIES. The
    repartition cell's columns are drawn last, so the earlier cells' data
    does not depend on them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o_orderdate = rng.integers(D_1992, D_1998 - 151, SF1_ORDERS).astype(np.int32)
    lines_per_order = rng.integers(1, 8, SF1_ORDERS)
    n_line = int(lines_per_order.sum())
    starts = np.cumsum(lines_per_order) - lines_per_order
    l_orderdate = np.repeat(o_orderdate, lines_per_order)
    lineitem = {
        "l_orderkey": np.repeat(np.arange(1, SF1_ORDERS + 1, dtype=np.int64),
                                lines_per_order),
        "l_suppkey": rng.integers(1, SF1_SUPPLIERS + 1, n_line).astype(np.int64),
        "l_linenumber": (np.arange(n_line) - np.repeat(starts, lines_per_order)
                         + 1).astype(np.int32),
        "l_shipdate": (l_orderdate + rng.integers(1, 122, n_line)).astype(np.int32),
    }
    lineitem["l_commitdate"] = (l_orderdate + rng.integers(30, 91, n_line)).astype(np.int32)
    lineitem["l_receiptdate"] = (lineitem["l_shipdate"]
                                 + rng.integers(1, 31, n_line)).astype(np.int32)
    lineitem["l_shipmode"] = rng.integers(0, len(SHIPMODES), n_line).astype(np.int8)
    orders = {"o_orderkey": np.arange(1, SF1_ORDERS + 1, dtype=np.int64),
              "o_orderpriority": rng.integers(0, len(PRIORITIES),
                                              SF1_ORDERS).astype(np.int8)}
    lineitem["l_partkey"] = rng.integers(1, SF1_PARTS + 1, n_line).astype(np.int64)
    quantity = rng.integers(1, 51, n_line).astype(np.float64)
    lineitem["l_quantity"] = quantity
    lineitem["l_extendedprice"] = np.round(quantity * rng.uniform(900, 2000, n_line) / 10, 2)
    lineitem["l_discount"] = np.round(rng.uniform(0.0, 0.10, n_line), 2)
    lineitem["l_tax"] = np.round(rng.uniform(0.0, 0.08, n_line), 2)
    return lineitem, orders


def supplier_query(df):
    from daft_tpu_torch import col, lit

    return (df.where(col("l_shipdate") <= lit(CUTOFF))
            .groupby("l_suppkey")
            .agg(col("l_orderkey").count().alias("n_lines"),
                 col("l_linenumber").sum().alias("sum_linenumber"),
                 col("l_shipdate").min().alias("first_ship"),
                 col("l_shipdate").max().alias("last_ship"),
                 col("l_orderkey").min().alias("first_order"),
                 col("l_orderkey").max().alias("last_order"))
            .sort("l_suppkey"))


def numpy_oracle(cols) -> dict:
    """The query's answer computed with numpy alone."""
    import numpy as np

    keep = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    supp = cols["l_suppkey"][keep]
    keys, inv = np.unique(supp, return_inverse=True)
    g = len(keys)

    def reduce(ufunc, vals, ident):
        out = np.full(g, ident, dtype=vals.dtype)
        ufunc.at(out, inv, vals)
        return out

    ship, order = cols["l_shipdate"][keep], cols["l_orderkey"][keep]
    line = cols["l_linenumber"][keep].astype(np.int64)
    sum_line = np.zeros(g, dtype=np.int64)
    np.add.at(sum_line, inv, line)

    def dates(days):
        return [EPOCH + datetime.timedelta(days=int(d)) for d in days]

    return {
        "l_suppkey": keys.tolist(),
        "n_lines": np.bincount(inv, minlength=g).tolist(),
        "sum_linenumber": sum_line.tolist(),
        "first_ship": dates(reduce(np.minimum, ship, np.iinfo(np.int32).max)),
        "last_ship": dates(reduce(np.maximum, ship, np.iinfo(np.int32).min)),
        "first_order": reduce(np.minimum, order, np.iinfo(np.int64).max).tolist(),
        "last_order": reduce(np.maximum, order, np.iinfo(np.int64).min).tolist(),
    }


def q12_frames(lineitem, orders):
    """The port's DataFrames of q12: string columns as object arrays."""
    import numpy as np

    import daft_tpu_torch as dt

    modes = np.array(SHIPMODES, dtype=object)
    prios = np.array(PRIORITIES, dtype=object)
    dates = {c: lineitem[c].astype("datetime64[D]")
             for c in ("l_shipdate", "l_commitdate", "l_receiptdate")}
    df_l = dt.from_pydict({"l_orderkey": lineitem["l_orderkey"],
                           "l_shipmode": modes[lineitem["l_shipmode"]], **dates})
    df_o = dt.from_pydict({"o_orderkey": orders["o_orderkey"],
                           "o_orderpriority": prios[orders["o_orderpriority"]]})
    return df_l, df_o


def q12_query(df_l, df_o):
    """TPC-H q12 as benchmarking/tpch/queries.py:220-237 writes it."""
    from daft_tpu_torch import col, lit

    high = col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
    return (df_l.where(col("l_shipmode").is_in(["MAIL", "SHIP"])
                       & (col("l_commitdate") < col("l_receiptdate"))
                       & (col("l_shipdate") < col("l_commitdate"))
                       & (col("l_receiptdate") >= lit(Q12_FROM))
                       & (col("l_receiptdate") < lit(Q12_TO)))
            .join(df_o, left_on="l_orderkey", right_on="o_orderkey")
            .with_column("high_line", high.if_else(lit(1), lit(0)))
            .with_column("low_line", (~high).if_else(lit(1), lit(0)))
            .groupby("l_shipmode")
            .agg(col("high_line").sum().alias("high_line_count"),
                 col("low_line").sum().alias("low_line_count"))
            .sort("l_shipmode"))


def q12_keep(lineitem):
    """q12's lineitem predicate in numpy."""
    import numpy as np

    mode = np.array(SHIPMODES)[lineitem["l_shipmode"]]
    receipt = lineitem["l_receiptdate"]
    return (np.isin(mode, ["MAIL", "SHIP"])
            & (lineitem["l_commitdate"] < receipt)
            & (lineitem["l_shipdate"] < lineitem["l_commitdate"])
            & (receipt >= (Q12_FROM - EPOCH).days) & (receipt < (Q12_TO - EPOCH).days))


def q12_high(lineitem, orders):
    """Per lineitem row: its order's priority is 1-URGENT or 2-HIGH
    (o_orderkey is 1..SF1_ORDERS, so the join is an index)."""
    return orders["o_orderpriority"][lineitem["l_orderkey"] - 1] <= 1


def q12_oracle(lineitem, orders) -> dict:
    """q12's answer computed with numpy alone."""
    import numpy as np

    keep = q12_keep(lineitem)
    high = q12_high(lineitem, orders)[keep]
    mode = lineitem["l_shipmode"][keep]
    present = sorted({SHIPMODES[m] for m in np.unique(mode)})
    out = {"l_shipmode": present, "high_line_count": [], "low_line_count": []}
    for name in present:
        rows = mode == SHIPMODES.index(name)
        out["high_line_count"].append(int(np.count_nonzero(high[rows])))
        out["low_line_count"].append(int(np.count_nonzero(~high[rows])))
    return out


# ---- timing --------------------------------------------------------------------


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls after
    a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, label: str = "") -> float | None:
    """Mean device time of one call: the device activities' own times under
    torch.profiler over ``iters`` calls after a warm-up. Unlike time_ms it
    leaves out the gaps where the card waits for the host to launch: for a
    call whose kernels take less time than its Python wrapper, time_ms
    measures the host. The profiler on the card has been seen to drop a
    call's activities: a capture where some activity did not run a whole
    number of times per call, or none ran, is taken again, up to three
    times; then the time is None, not measured. With a ``label``, print
    each activity's count and mean time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(e.count % iters == 0 for e in events):
            break
    else:
        print(f"  {label}: torch.profiler lost device activities three times: not measured")
        return None
    if label:
        print(f"  {label} device activities over {iters} calls: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / max(e.count, 1):.2f} us"
            for e in events))
    return sum(e.self_device_time_total for e in events) / iters / 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_s(fn, runs: int = 3):
    """Host-clock seconds of ``runs`` calls, each ending in a synchronize."""
    import torch

    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def plane_case(sk, op: str, planes, codes, cap: int, plain_iters: int = 5) -> dict:
    """K1 (op "sum") or K2 (op "min") on a list of planes at one shape: equal
    to its plain version bit for bit, then the kernel's time by CUDA events
    and on the device (torch.profiler), the plain version's, one library
    call's on the (N, P) stack of the same planes (``index_add_`` or
    ``scatter_reduce_`` into a table with a trash row, which the port never
    calls), and two bounds: ``bound_ms``, what the function needs (the codes,
    the 32-byte sectors of the kept rows' planes, the output: a trash row's
    plane values are never needed), and ``bound_read_once_ms``, every input
    read once and the output written once."""
    import torch

    if op == "sum":
        def call():
            return sk.segment_sum_planes(planes, codes, cap)

        def plain():
            return sk.segment_sum_planes_plain(planes, codes, cap)
    else:
        def call():
            return sk.segment_extreme_planes(planes, codes, cap, op)

        def plain():
            return sk.segment_extreme_planes_plain(planes, codes, cap, op)
    got, want = call(), plain()
    torch.cuda.synchronize()
    n, p = codes.numel(), len(planes)
    kernel = "K1 segment_sum_planes" if op == "sum" else "K2 segment_extreme_planes"
    check(torch.equal(got, want), f"{kernel} at cap {cap}, P {p} differs from its plain "
                                  "version")
    stack = torch.stack(planes, dim=1)
    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    if op == "sum":
        table = torch.zeros((cap + 1, p), device=codes.device)

        def library():
            return table.index_add_(0, idx, stack)
        out_bytes = cap * p * 8
    else:
        table = torch.full((cap + 1, p), float("inf"), device=codes.device)
        idx = idx[:, None].expand(n, p)

        def library():
            return table.scatter_reduce_(0, idx, stack, "amin")
        out_bytes = cap * p * 4
    kept = (codes >= 0) & (codes < cap)
    sectors = int(kept.view(-1, 8).any(dim=1).sum())  # n is a multiple of 8 here
    result = {
        "cap": cap, "planes": p, "tier": list(sk.segment_planes_tier(cap, min(p, 64))),
        "kept_share": float(kept.float().mean()),
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"{kernel} cap {cap} P {p}"),
        "plain_ms": time_ms(plain, plain_iters), "library_ms": time_ms(library, 20),
        "bound_ms": bound_ms(n * 4 + sectors * 32 * p + out_bytes),
        "bound_read_once_ms": bound_ms(n * p * 4 + n * 4 + out_bytes),
    }
    del got, want, stack, table, idx, kept
    return result


def k3_case(sk, v, keep, codes, cap: int, op: str) -> dict:
    """K3 at one shape: equal to its plain version bit for bit, then the
    kernel's, the plain version's and ``scatter_reduce_``'s times and the
    bound (13 bytes read per row, 9 written per segment)."""
    import torch

    gv, gn = sk.segment_extreme_int64(v, keep, codes, cap, op)
    wv, wn = sk.segment_extreme_int64_plain(v, keep, codes, cap, op)
    torch.cuda.synchronize()
    check(torch.equal(gv, wv) and torch.equal(gn, wn),
          f"K3 segment_extreme_int64 ({op}, cap {cap}) differs from its plain version")
    info = torch.iinfo(torch.int64)
    ident = info.max if op == "min" else info.min
    lib_vals = torch.where(keep, v, ident)
    lib_idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    lib_table = torch.full((cap + 1,), ident, dtype=torch.int64, device=v.device)
    reduce = "amin" if op == "min" else "amax"
    n = v.numel()
    return {
        "cap": cap,
        "tier": list(sk.segment_extreme_int64_tier(cap)),
        "max_abs_err": max_abs_err(gv, wv),
        "ms": time_ms(lambda: sk.segment_extreme_int64(v, keep, codes, cap, op), 20),
        "device_ms": device_ms(lambda: sk.segment_extreme_int64(v, keep, codes, cap, op), 20),
        "plain_ms": time_ms(
            lambda: sk.segment_extreme_int64_plain(v, keep, codes, cap, op), 20),
        "library_ms": time_ms(
            lambda: lib_table.scatter_reduce_(0, lib_idx, lib_vals, reduce), 20),
        "bound_ms": bound_ms(n * 8 + n * 1 + n * 4 + cap * 8 + cap * 1),
    }


def k1a_case(sk, stack, codes, cap: int) -> dict:
    """K1a on the (N, P) stack at one shape: equal to its plain version bit
    for bit (integer-valued planes, segment totals below 2^24), then the
    kernel's, the plain version's and ``index_add_``'s times (into a table
    with a trash row, which the port never calls) and two bounds, as
    plane_case's: ``bound_ms``, what the function needs (the codes, the
    32-byte sectors of the stack that the kept rows' floats lie in, the f32
    output), and ``bound_read_once_ms``, every input read once."""
    import torch

    def call():
        return sk.segment_sum_planes_f32(stack, codes, cap)
    got = call()
    want = sk.segment_sum_planes_f32_plain(stack, codes, cap)
    torch.cuda.synchronize()
    n, p = stack.shape
    check(torch.equal(got, want), f"K1a segment_sum_planes_f32 at cap {cap}, P {p} differs "
                                  "from its plain version")
    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    table = torch.zeros((cap + 1, p), dtype=torch.float32, device=codes.device)
    # the kept rows' byte ranges [r * 4P, (r + 1) * 4P) in 32-byte sectors;
    # two adjacent kept rows may share one
    rows = torch.nonzero((codes >= 0) & (codes < cap)).squeeze(1)
    first, last = (rows * (4 * p)) >> 5, (rows * (4 * p) + 4 * p - 1) >> 5
    sectors = int((last - first + 1).sum()) - int((first[1:] == last[:-1]).sum())
    result = {
        "cap": cap, "planes": p, "kept_share": rows.numel() / n,
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"K1a cap {cap} P {p}"),
        "plain_ms": time_ms(lambda: sk.segment_sum_planes_f32_plain(stack, codes, cap), 5),
        "library_ms": time_ms(lambda: table.index_add_(0, idx, stack), 20),
        "bound_ms": bound_ms(n * 4 + sectors * 32 + cap * p * 4),
        "bound_read_once_ms": bound_ms(n * p * 4 + n * 4 + cap * p * 4),
    }
    del got, want, idx, table, rows, first, last
    return result


def k5_inputs(cols, orders, table, dev) -> dict:
    """K5's inputs on K4's table of orders: lineitem's keys padded to the
    bucket (padding rows invalid), orders' high/low priority planes, and two
    code columns: q12's ship-mode codes (trash where its predicate drops the
    row: 31,585 rows kept) and every real row coded by its ship mode
    (``all_kept``: q12's date and mode predicates dropped, about 6.0 M
    probes that all hit, padding in the trash). The one input function of
    chip_smoke.py and probe_timings.py."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    keys = torch.zeros(BUCKET, dtype=torch.int64)
    keys[:n] = torch.from_numpy(cols["l_orderkey"])
    valid = torch.zeros(BUCKET, dtype=torch.bool)
    valid[:n] = True
    high = orders["o_orderpriority"] <= 1
    planes = torch.from_numpy(np.stack([high, ~high], axis=1).astype(np.float32))
    keep_np, q12 = q12_codes(cols, dev)
    every = torch.full((BUCKET,), Q12_CAP, dtype=torch.int32)
    every[:n] = torch.from_numpy(cols["l_shipmode"].astype(np.int32))
    return {"keys": keys.to(dev), "valid": valid.to(dev), "planes": planes.to(dev),
            "table": table, "codes": {"q12": q12, "all_kept": every.to(dev)},
            "kept": {"q12": int(keep_np.sum()), "all_kept": n}}


def k5_case(pk, inputs: dict, shape: str, cols, orders) -> dict:
    """K5 at one of k5_inputs' shapes, the one timing of K5 both scripts
    use: equal to its plain version bit for bit (integer-valued planes) and
    to a numpy oracle (q12's for MAIL and SHIP; per ship mode for all_kept),
    then its time by CUDA events and on the device (torch.profiler), each
    over 20 calls after a warm-up, the plain version's, and the bound: every
    code read, each kept row's key and validity byte, each distinct kept
    key's 16-byte slot and each distinct matched dim row's P planes (rows
    sorted by order key share them), then the outputs written."""
    import numpy as np
    import torch

    keys, valid, table = inputs["keys"], inputs["valid"], inputs["table"]
    planes, codes = inputs["planes"], inputs["codes"][shape]

    def call():
        return pk.hash_probe_segment_sum(keys, valid, codes, table, planes, Q12_CAP)
    got_s, got_c = call()
    want_s, want_c = pk.hash_probe_segment_sum_plain(keys, valid, codes, table, planes,
                                                     Q12_CAP)
    torch.cuda.synchronize()
    check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
          f"K5 hash_probe_segment_sum ({shape}) differs from its plain version")
    high = q12_high(cols, orders)
    if shape == "q12":
        oracle = q12_oracle(cols, orders)
        modes = oracle["l_shipmode"]
        want = {m: (h, lo) for m, h, lo in zip(modes, oracle["high_line_count"],
                                                oracle["low_line_count"])}
    else:
        mode = cols["l_shipmode"]
        modes = SHIPMODES
        want = {m: (int(np.count_nonzero(high[mode == i])),
                    int(np.count_nonzero(~high[mode == i]))) for i, m in enumerate(modes)}
    for m in modes:
        code = SHIPMODES.index(m)
        h, lo = want[m]
        check(got_s[code].tolist() == [h, lo] and got_c[code].item() == h + lo,
              f"K5 ({shape}) {m}: {got_s[code].tolist()} / {got_c[code].item()}, "
              f"the oracle's {h} / {lo}")
    print(f"K5 ({shape}) sums equal the numpy oracle: "
          f"{ {m: got_s[SHIPMODES.index(m)].tolist() for m in modes} }")
    kept, p = inputs["kept"][shape], planes.shape[1]
    inside = (codes >= 0) & (codes < Q12_CAP)
    dim_row = pk.hash_probe_index_plain(keys, valid, table)
    slots = torch.unique(keys[inside & valid]).numel()
    matched = torch.unique(dim_row[inside & (dim_row >= 0)]).numel()
    del inside, dim_row
    result = {
        "cap": Q12_CAP, "planes": p, "kept_rows": kept, "distinct_keys": slots,
        "matched_dim_rows": matched,
        "max_abs_err": max(max_abs_err(got_s, want_s), max_abs_err(got_c, want_c)),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"K5 {shape}"),
        "plain_ms": time_ms(lambda: pk.hash_probe_segment_sum_plain(
            keys, valid, codes, table, planes, Q12_CAP), 5),
        "library_ms": None,
        "bound_ms": bound_ms(BUCKET * 4 + kept * (8 + 1) + slots * 16 + matched * p * 4
                             + Q12_CAP * p * 8 + Q12_CAP * 8),
    }
    del got_s, got_c, want_s, want_c
    return result


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries; equal entries (infinities
    included) count 0."""
    import torch

    diff = (a.double() - b.double()).abs()
    diff = torch.where(a == b, torch.zeros_like(diff), diff)
    return float(diff.max().item()) if diff.numel() else 0.0


# ---- phases --------------------------------------------------------------------


def phase_card():
    import torch

    phase("card")
    check(torch.cuda.is_available(), "no CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {card}")
    print(f"torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return card, name


def phase_build(card: str) -> None:
    from daft_tpu_torch.ops import _build, permute_kernels, probe_kernels, segment_kernels

    phase("build")
    t0 = time.perf_counter()
    _build.build_all()
    segment_kernels.build()
    probe_kernels.build()
    permute_kernels.build()
    wall = time.perf_counter() - t0
    for source, info in sorted(_build.BUILD_INFO.items()):
        print(f"built {source}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build wall {wall:.2f} s [{card}]", flush=True)


def slice_inputs(cols, device):
    """The kernels' inputs at the query's shapes and values: codes with
    filtered and padding rows in the trash segment, the 15 sum planes (rows,
    6 counts, 8 digits of l_linenumber) as separate tensors, as the stage
    builds them, and their (N, 15) stack for K1a, the first-row-index plane,
    and the int64 value columns with their keep mask."""
    import numpy as np
    import torch

    n = len(cols["l_suppkey"])
    keep_np = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = torch.from_numpy(keep_np)
    codes = torch.full((BUCKET,), CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(np.where(keep_np, cols["l_suppkey"] - 1, CAP)
                                 .astype(np.int32))
    line = torch.zeros(BUCKET, dtype=torch.int64)
    line[:n] = torch.from_numpy(cols["l_linenumber"].astype(np.int64))
    planes = [keep.float() for _ in range(7)] + [((line >> (8 * k)) & 255).float() * keep
                                                 for k in range(8)]
    first = torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                        torch.tensor(float("inf")))
    ints = {}
    for name in ("l_orderkey", "l_shipdate"):
        v = torch.zeros(BUCKET, dtype=torch.int64)
        v[:n] = torch.from_numpy(cols[name].astype(np.int64))
        ints[name] = v.to(device)
    planes = [t.to(device) for t in planes]
    return {"codes": codes.to(device), "keep": keep.to(device), "planes": planes,
            "stack": torch.stack(planes, dim=-1), "first": [first.to(device)],
            "ints": ints}


def q12_codes(cols, dev):
    """(q12's lineitem predicate in numpy, the int32[BUCKET] ship-mode codes
    on ``dev`` with dropped and padding rows in the trash segment Q12_CAP)."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    keep_np = q12_keep(cols)
    codes8 = torch.full((BUCKET,), Q12_CAP, dtype=torch.int32)
    codes8[:n] = torch.from_numpy(np.where(keep_np, cols["l_shipmode"], Q12_CAP)
                                  .astype(np.int32))
    return keep_np, codes8.to(dev)


def probe_cases(pk, cols, orders, dev, results: dict) -> None:
    """K4's build and probe and K5 at q12's shapes, into ``results``: each
    equal to its plain version (the build as the sorted set of its (key,
    row) entries), timed by events and on the device, beside its bound."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    # K4: orders' keys into the table (its clearing is part of the build),
    # every lineitem key probed; then every lineitem key shifted past the
    # largest order key, so that every probe walks to an empty slot
    dim_keys = torch.from_numpy(orders["o_orderkey"]).to(dev)
    dim_valid = torch.ones(SF1_ORDERS, dtype=torch.bool, device=dev)
    slots = pk.probe_table_slots(SF1_ORDERS)
    table = pk.build_probe_table(dim_keys, dim_valid, slots)
    plain_table = pk.build_probe_table_plain(dim_keys, dim_valid, slots)
    torch.cuda.synchronize()
    (gk, gr), (wk, wr) = pk.table_entries(table), pk.table_entries(plain_table)
    check(torch.equal(gk, wk) and torch.equal(gr, wr),
          "K4 build: the table's (key, row) entries differ from the plain build's")
    print(f"K4 table: {slots} slots, load {SF1_ORDERS / slots:.3f}, "
          f"{table.numel() * table.element_size()} bytes")

    def build():
        return pk.build_probe_table(dim_keys, dim_valid, slots)
    results["hash_probe_build"] = {
        "max_abs_err": max(max_abs_err(gk, wk), max_abs_err(gr, wr)),
        "ms": time_ms(build, 20),
        "device_ms": device_ms(build, 20, "K4 build"),
        "plain_ms": time_ms(lambda: pk.build_probe_table_plain(dim_keys, dim_valid, slots), 2),
        "library_ms": None,
        "bound_ms": bound_ms(SF1_ORDERS * 9 + slots * 12),
        "slots": slots,
    }
    fact_keys = torch.zeros(BUCKET, dtype=torch.int64)
    fact_keys[:n] = torch.from_numpy(cols["l_orderkey"])
    fact_valid = torch.zeros(BUCKET, dtype=torch.bool)
    fact_valid[:n] = True
    fact_keys, fact_valid = fact_keys.to(dev), fact_valid.to(dev)
    sorted_keys = torch.sort(dim_keys)[0]
    probe_bound = bound_ms(BUCKET * 8 + BUCKET + slots * 12 + BUCKET * 4)
    for label, keys in (("hits", fact_keys), ("all_miss", fact_keys + SF1_ORDERS)):
        got = pk.hash_probe_index(keys, fact_valid, table)
        want = pk.hash_probe_index_plain(keys, fact_valid, table)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K4 probe ({label}) differs from its plain version")
        if label == "hits":
            check(torch.equal(got[:n].cpu(), torch.from_numpy(cols["l_orderkey"] - 1).int()),
                  "K4 probe: a lineitem row does not find its order")
        else:
            check(bool((got == -1).all()), "K4 probe (all_miss): a shifted key found a row")

        def probe(keys=keys):
            return pk.hash_probe_index(keys, fact_valid, table)
        case = {
            "max_abs_err": max_abs_err(got, want),
            "ms": time_ms(probe, 20),
            "device_ms": device_ms(probe, 20, f"K4 probe {label}"),
            "plain_ms": time_ms(
                lambda keys=keys: pk.hash_probe_index_plain(keys, fact_valid, table), 5),
            "library_ms": time_ms(lambda keys=keys: torch.searchsorted(sorted_keys, keys), 20),
            "bound_ms": probe_bound,
        }
        if label == "hits":
            results["hash_probe_index"] = case
        else:
            results["hash_probe_index"][label] = case
        del got, want, keys
    del plain_table, sorted_keys

    # K5 on K4's table at q12's shapes, then with every real row kept
    del fact_keys, fact_valid
    k5 = k5_inputs(cols, orders, table, dev)
    results["hash_probe_segment_sum"] = k5_case(pk, k5, "q12", cols, orders)
    results["hash_probe_segment_sum"]["all_kept"] = k5_case(pk, k5, "all_kept", cols, orders)
    del table, k5
    torch.cuda.empty_cache()


def phase_kernels(cols, orders, card: str):
    import numpy as np
    import torch

    from daft_tpu_torch.ops import permute_kernels as rk
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk

    phase("kernels")
    dev = torch.device("cuda")
    x = slice_inputs(cols, dev)
    codes, keep = x["codes"], x["keep"]
    p = x["stack"].shape[1]
    results = {}

    # K1 over the 15 planes; K2 over the first-row-index plane, min
    results["segment_sum_planes"] = plane_case(sk, "sum", x["planes"], codes, CAP)
    results["segment_extreme_planes"] = plane_case(sk, "min", x["first"], codes, CAP)

    # K3: the supplier's four launches (both int64 columns, both ops); the
    # top-level numbers are l_orderkey min's. Then cap 8 (l_shipmode's 7
    # codes: every kept row on 7 addresses) and cap 2^17 (l_partkey folded
    # into 2^17 groups: past one block's shared memory), l_orderkey min.
    # K1 and K2 at both too (cap 8 with 98 % of rows kept, as in TPC-H q1's
    # few groups; cap 2^17 their global tier), and K1 on 73 planes at cap
    # 4096 (l_suppkey folded): past one 64-plane chunk
    cases = {f"{name} {op}": k3_case(sk, v, keep, codes, CAP, op)
             for name, v in x["ints"].items() for op in ("min", "max")}
    orderkey = x["ints"]["l_orderkey"]
    results["segment_extreme_int64"] = {
        **cases["l_orderkey min"],
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "by_column_op": cases}
    rows = len(cols["l_suppkey"])
    k1a_at = {}
    for label, group_np, groups in (
            ("at_cap8", cols["l_shipmode"], K3_SMALL_CAP),
            ("at_cap131072", (cols["l_partkey"] - 1) % K3_LARGE_CAP, K3_LARGE_CAP),
            ("at_cap4096_p73", (cols["l_suppkey"] - 1) % WIDE_CAP, WIDE_CAP)):
        group = torch.full((BUCKET,), groups, dtype=torch.int32)
        group[:rows] = torch.from_numpy(group_np.astype(np.int32))
        codes_k = torch.where(keep, group.to(dev), groups)
        if label == "at_cap4096_p73":
            # 73 distinct planes (copies of the 15): planes that alias would
            # be read from L2, under the bound's bytes
            wide = [x["planes"][j % p].clone() for j in range(WIDE_PLANES)]
            results["segment_sum_planes"][label] = plane_case(sk, "sum", wide, codes_k,
                                                              groups, 2)
            del wide
        else:
            results["segment_extreme_int64"][label] = k3_case(sk, orderkey, keep, codes_k,
                                                              groups, "min")
        if label in ("at_cap8", "at_cap131072"):
            results["segment_sum_planes"][label] = plane_case(sk, "sum", x["planes"], codes_k,
                                                              groups)
            results["segment_extreme_planes"][label] = plane_case(sk, "min", x["first"],
                                                                  codes_k, groups)
            k1a_at[label] = k1a_case(sk, x["stack"], codes_k, groups)
        del group, codes_k

    # K1a: K1's planes, stacked to (N, 15), and codes in one f32 window; the
    # same at cap 8 and cap 2^17 (above)
    results["segment_sum_planes_f32"] = k1a_case(sk, x["stack"], codes, CAP)
    results["segment_sum_planes_f32"].update(k1a_at)
    check(torch.equal(sk.segment_sum_planes_f32(x["stack"], codes, CAP),
                      sk.segment_sum_planes(x["planes"], codes, CAP).float()),
          "K1a segment_sum_planes_f32 differs from K1's output cast to f32")
    del x, orderkey
    torch.cuda.empty_cache()

    # K1 at q12's shapes: 7 ship modes in cap 8, P = 5 planes (kept rows, and
    # the valid count and one digit plane of each CASE-WHEN sum); K2 over the
    # first-row-index plane and the same codes, Q = 1
    n = len(cols["l_orderkey"])
    keep_np, codes8 = q12_codes(cols, dev)
    high_np = q12_high(cols, orders)
    kf = torch.zeros(BUCKET)
    kf[:n] = torch.from_numpy(keep_np.astype(np.float32))
    hf = torch.zeros(BUCKET)
    hf[:n] = torch.from_numpy(high_np.astype(np.float32))
    planes8 = [t.to(dev) for t in (kf, kf, kf * hf, kf, kf * (1 - hf))]
    first8 = torch.where(torch.from_numpy(np.pad(keep_np, (0, BUCKET - n))),
                         torch.arange(BUCKET, dtype=torch.float32),
                         torch.tensor(float("inf"))).to(dev)
    results["segment_sum_planes"]["at_q12_cap8"] = plane_case(sk, "sum", planes8, codes8,
                                                              Q12_CAP)
    results["segment_extreme_planes"]["at_q12_cap8"] = plane_case(sk, "min", [first8], codes8,
                                                                  Q12_CAP, 20)
    del planes8, first8

    del codes8
    probe_cases(pk, cols, orders, dev, results)

    # K6 at the repartition cell's shapes: 8 x 8 blocks of 23 x 2^20 + 4
    # words (7 eight-byte planes, 1 four-byte plane, 8 validity planes, the
    # counts and the alignment pad)
    w = 23 * (1 << 20) + 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    send = torch.randint(-2**31, 2**31 - 1, (MESH, MESH, w), dtype=torch.int32,
                         device=dev, generator=gen)
    got = rk.ring_permute_words(send)
    want = rk.ring_permute_words_plain(send)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K6 ring_permute_words differs from its plain version")
    del got, want
    results["ring_permute_words"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: rk.ring_permute_words(send), 20),
        "device_ms": device_ms(lambda: rk.ring_permute_words(send), 5),
        "plain_ms": time_ms(lambda: rk.ring_permute_words_plain(send), 5),
        "library_ms": time_ms(lambda: send.transpose(0, 1).contiguous(), 20),
        "bound_ms": bound_ms(2 * send.numel() * 4),
    }
    k6 = results["ring_permute_words"]
    k6["share_of_memory_rate"] = k6["bound_ms"] / k6["ms"]
    del send
    torch.cuda.empty_cache()

    print_cases(results, card)
    return results


def print_cases(results: dict, card: str) -> None:
    """One line per case: the top-level one of each kernel, then its other
    shapes."""
    def fmt(v):
        return "null" if v is None else f"{v:.4f}"

    rows = []
    for kname, r in results.items():
        rows.append((kname, r))
        for label, sub in r.items():
            if label == "by_column_op":
                rows += [(f"{kname} {case}", c) for case, c in sub.items()]
            elif isinstance(sub, dict):
                rows.append((f"{kname} {label}", sub))
    for name, r in rows:
        shape = f" cap {r['cap']}" if "cap" in r else ""
        shape += f" P {r['planes']}" if "planes" in r else ""
        tier = f" tier {r['tier']}" if r.get("tier") else ""
        dev = f" (device {fmt(r['device_ms'])})" if "device_ms" in r else ""
        once = (f", bound_read_once_ms {fmt(r['bound_read_once_ms'])}"
                if "bound_read_once_ms" in r else "")
        # the share against the kernel's own device time where it was taken:
        # the events also hold the wrapper's host time
        held, by = ((r["device_ms"], "device") if r.get("device_ms")
                    else (r["ms"], "kernel_ms"))
        print(f"{name}:{shape}{tier} identical to plain (max_abs_err {r['max_abs_err']}); "
              f"kernel_ms {fmt(r['ms'])}{dev}, plain_ms {fmt(r['plain_ms'])}, "
              f"library_ms {fmt(r['library_ms'])}, bound_ms {fmt(r['bound_ms'])}{once} "
              f"(bytes at 3.35 TB/s; {by} at {r['bound_ms'] / held:.1%} of bound_ms) "
              f"[{card}]", flush=True)


def phase_slice(cols, card: str):
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("slice")
    data = {k: cols[k] for k in ("l_orderkey", "l_suppkey", "l_linenumber")}
    data["l_shipdate"] = cols["l_shipdate"].astype("datetime64[D]")
    df = dt.from_pydict(data)
    print(f"lineitem SF1: {len(cols['l_suppkey'])} rows, seed {SEED}", flush=True)

    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = supplier_query(df).to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        warm = time_s(lambda: supplier_query(df).to_pydict())
        peak = torch.cuda.max_memory_allocated()
    print(f"device run counters: {json.dumps(snap, sort_keys=True)}")
    check(snap["device_grouped_batches"] >= 1, "no device grouped batch in the query")
    check(snap["device_fallbacks"] == 0, "the device stage fell back to the host")
    for k in counters.SEGMENT_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the query")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = supplier_query(df).to_pydict()
        host_s = time.perf_counter() - t0
    oracle = numpy_oracle(cols)
    n_groups = len(got["l_suppkey"])
    check(n_groups == SF1_SUPPLIERS, f"{n_groups} groups, expected {SF1_SUPPLIERS}")
    check(got == host, "device result differs from the port's host path")
    check(got == oracle, "device result differs from the numpy oracle")
    check(all(isinstance(v, int) for v in got["n_lines"]), "counts are not ints")
    check(int(np.sum(got["n_lines"])) == int(np.count_nonzero(
        cols["l_shipdate"] <= (CUTOFF - EPOCH).days)), "counts do not cover the kept rows")
    print(f"result: {n_groups} groups, equal to the host path and the numpy oracle")
    print(f"query cold {cold_s:.3f} s; warm median {statistics.median(warm):.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}); host path {host_s:.3f} s; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    return df, launches


def phase_profile(run, card: str, name: str = "profile", **cfg) -> None:
    """One warm device run of ``run()`` under torch.profiler: device busy
    time (the sum of the device activities' own times), the run's wall time
    under the profiler, the idle share, and the device activities that took
    longest. ``cfg`` adds to the execution config."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import daft_tpu_torch as dt

    phase(name)
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on", **cfg):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side activities only (kernels, copies): the CPU op that launched
    # a kernel carries the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "the profiled query shows no device time")
    print(f"warm run under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms x{e.count}: {e.key[:90]}")
    sys.stdout.flush()


def phase_q12(lineitem, orders, card: str):
    """TPC-H q12 at SF1 on the card: the cold run (counted), the host path,
    the numpy oracle, the warm runs, peak memory. Returns (the query as a
    callable, the cold run's launches)."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("q12")
    t0 = time.perf_counter()
    df_l, df_o = q12_frames(lineitem, orders)
    print(f"lineitem {len(lineitem['l_orderkey'])} rows, orders {SF1_ORDERS} rows: "
          f"frames {time.perf_counter() - t0:.2f} s", flush=True)

    def query():
        return q12_query(df_l, df_o)

    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = query().to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        counters.reset()
        warm = time_s(lambda: query().to_pydict())
        warm_snap = counters.snapshot()
        peak = torch.cuda.max_memory_allocated()
    print(f"cold run counters: {json.dumps(snap, sort_keys=True)}")
    print(f"warm runs counters (3 runs): {json.dumps(warm_snap, sort_keys=True)}")
    check(snap["device_join_batches"] >= 1, "no device join batch in q12")
    check(snap["device_fallbacks"] == 0, "the join stage fell back to the host")
    for k in ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
              "segment_extreme_planes"):
        check(launches[k] > 0, f"kernel {k} was not launched by q12")
    check(warm_snap["device_join_batches"] == 3 and warm_snap["device_fallbacks"] == 0,
          "a warm q12 run left the device join path")
    check(warm_snap["launches_hash_probe_index"] == 0
          and warm_snap["launches_hash_probe_build"] == 0,
          "a warm q12 run probed again: the index plane is not resident")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = query().to_pydict()
        host_s = time.perf_counter() - t0
    oracle = q12_oracle(lineitem, orders)
    check(got == host, "q12 on the card differs from the port's host path")
    check(got == oracle, "q12 on the card differs from the numpy oracle")
    check(got["l_shipmode"] == ["MAIL", "SHIP"], f"q12 groups {got['l_shipmode']}")
    check(all(isinstance(v, int) for v in got["high_line_count"] + got["low_line_count"]),
          "q12 counts are not ints")
    print(f"result: {json.dumps(got)}, equal to the host path and the numpy oracle")
    print(f"q12 cold {cold_s:.3f} s; warm median {statistics.median(warm):.4f} s "
          f"(runs {', '.join(f'{w:.4f}' for w in warm)}); host path {host_s:.3f} s; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    return query, launches


def splitmix64_np(x):
    """splitmix64's finalizer over uint64, written out here so the oracle
    does not lean on the port's hashing module."""
    import numpy as np

    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def partition_arrays(part, names):
    """{column: (values, validity)} of one result partition."""
    batch = part.concat_or_empty()
    return {c: (batch.get_column(c).to_numpy(), batch.get_column(c).validity_numpy())
            for c in names}


def same_partitions(a, b, names) -> bool:
    """Partition for partition, column for column: equal bits and validity,
    rows in order."""
    import numpy as np

    if len(a) != len(b):
        return False
    for pa_, pb_ in zip(a, b):
        x, y = partition_arrays(pa_, names), partition_arrays(pb_, names)
        for c in names:
            (xv, xm), (yv, ym) = x[c], y[c]
            if xv.dtype != yv.dtype or not np.array_equal(xm, ym) \
                    or not np.array_equal(xv.view(f"u{xv.itemsize}"),
                                          yv.view(f"u{yv.itemsize}")):
                return False
    return True


def phase_repartition(lineitem, card: str):
    """The mesh hash repartition of SF1 lineitem's numeric columns over 8
    shard slots on the card. Returns (the run as a callable, the run's
    launches)."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    import daft_tpu_torch.device.residency  # noqa: F401
    from daft_tpu_torch import col
    from daft_tpu_torch.ops import counters

    phase("repartition")
    # the earlier cells' resident planes stay out of this cell's peak memory
    dt.device.residency.manager().clear()
    torch.cuda.empty_cache()
    cols = {c: lineitem[c] for c in REPART_COLUMNS}
    rows = len(cols["l_orderkey"])
    df = dt.from_pydict(cols)
    mesh_cfg = {"device": "cuda", "device_mode": "on", "mesh_devices": MESH}

    def run():
        return df.repartition(MESH, col("l_orderkey")).collect()._result

    with dt.execution_config_ctx(kernel_mode="on", **mesh_cfg):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        peak = torch.cuda.max_memory_allocated()
        warm = time_s(run)
    print(f"run counters: {json.dumps(snap, sort_keys=True)}")
    check(not counters.rejections, f"the repartition was refused: {counters.rejections}")
    check(launches["ring_permute_words"] == 1,
          f"K6 launched {launches['ring_permute_words']} times, expected once")
    check(snap["mesh_fused_permute_dispatches"] >= 1, "no fused-permute exchange")
    check(snap["mesh_alltoall_dispatches"] == 0, "the all_to_all tier ran")
    check(snap["mesh_alltoall_rows"] == rows, "the exchange did not carry every row")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = df.repartition(MESH, col("l_orderkey")).collect()._result
        host_s = time.perf_counter() - t0
    check(same_partitions(got, host, REPART_COLUMNS),
          "a partition differs from the port's host path")
    dest = splitmix64_np(cols["l_orderkey"].view(np.uint64)) % np.uint64(MESH)
    sizes = []
    for d, part in enumerate(got):
        arrays = partition_arrays(part, REPART_COLUMNS)
        mine = dest == d
        sizes.append(int(mine.sum()))
        for c in REPART_COLUMNS:
            values, valid = arrays[c]
            check(valid.all() and np.array_equal(values, cols[c][mine]),
                  f"partition {d}, column {c} differs from the numpy oracle")
    check(sum(sizes) == rows, "the partitions do not cover the rows")

    with dt.execution_config_ctx(kernel_mode="off", **mesh_cfg):
        counters.reset()
        t0 = time.perf_counter()
        off = run()
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        off_snap = counters.snapshot()
    check(off_snap["mesh_alltoall_dispatches"] == 1
          and off_snap["launches_ring_permute_words"] == 0,
          "kernel_mode='off' did not take the all_to_all tier")
    check(same_partitions(off, got, REPART_COLUMNS),
          "the all_to_all tier's partitions differ from the K6 tier's")
    print(f"lineitem SF1 {rows} rows, {len(REPART_COLUMNS)} columns by l_orderkey into "
          f"{MESH} partitions {sizes}: equal to the host path and the numpy oracle, "
          f"and the all_to_all tier equal to the K6 tier")
    print(f"repartition first {first_s:.3f} s; warm median {statistics.median(warm):.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}); all_to_all tier {off_s:.3f} s; "
          f"host path {host_s:.3f} s; exchange {snap['mesh_exchange_bytes']} bytes; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    return run, launches


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the card, build, data and kernels phases only: the "
                             "kernels against their plain versions, with their times "
                             "(no main path runs, so no launches are counted)")
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose daft_tpu_torch is driven (default: the "
                             "one beside this script), e.g. an unpacked parent commit to "
                             "time its kernels on the same card")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"chip_smoke.py: no daft_tpu_torch package in {root}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, name = phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        phase_build(card)
        t0 = time.perf_counter()
        lineitem, orders = tpch_sf1(SEED)
        print(f"datagen {time.perf_counter() - t0:.2f} s", flush=True)
        kernel_results = phase_kernels(lineitem, orders, card)
        paths = {}
        if not args.kernels_only:
            df, paths["supplier"] = phase_slice(lineitem, card)
            phase_profile(lambda: supplier_query(df).to_pydict(), card)
            q12, paths["q12"] = phase_q12(lineitem, orders, card)
            phase_profile(lambda: q12().to_pydict(), card, "q12 profile")
            del df, q12
            repart, paths["repartition"] = phase_repartition(lineitem, card)
            phase_profile(repart, card, "repartition profile", mesh_devices=MESH)
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    import torch

    kernels = []
    for kname, r in kernel_results.items():
        source, replaces = KERNELS[kname]
        by_path = {path: launches[kname] for path, launches in paths.items()}
        entry = {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()) if by_path else None,
                 "launches_by_path": by_path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": "bytes", "library_ms": r["library_ms"]}
        # the rest: device_ms, the read-once bound, tiers, the other shapes
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
