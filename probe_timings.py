#!/usr/bin/env python3
"""Time the hash-probe kernels K4 (build and probe) and K5 at TPC-H SF1
q12's shapes, K4's probe at several hit rates, on one NVIDIA card.

    python3 probe_timings.py [--root DIR]

Orders' 1.5 M keys go into a table of ``probe_table_slots(1.5 M)`` slots;
lineitem's keys (padded to 2^23 rows, as the join stage pads them) are
probed with the keys of a seeded share of orders shifted past the largest
order key, as if the dim had been filtered: 100, 50, 10 and 0 % of the
lineitem rows find their order. K5 probes every lineitem key and sums
orders' high and low priority planes by q12's ship-mode codes, then by
every row's ship mode. Every probe and K5 must equal their plain versions. Prints each kernel's device ms
(torch.profiler) and CUDA events ms, with the card's name and power limit,
then one JSON line. A variant of the kernels (a copy of daft_tpu_torch with
one constant changed) is timed the same way, through ``--root``.

``--root`` drives the daft_tpu_torch of another checkout, for example an
unpacked parent commit, so that two versions are timed on one card in turns.

K5 is timed by chip_smoke.py's ``k5_inputs`` and ``k5_case``, the one way
both scripts time it, at q12's shapes and with every real row kept.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as cs

HIT_SHARES = (1.0, 0.5, 0.1, 0.0)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"probe_timings.py: no daft_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, _ = cs.phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        result = run(card)
    except cs.SmokeFailure as exc:
        print(f"probe_timings.py: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    print(card)
    return 0


def run(card: str) -> dict:
    import numpy as np
    import torch

    from daft_tpu_torch.ops import probe_kernels as pk

    pk.build()
    lineitem, orders = cs.tpch_sf1(cs.SEED)
    dev = torch.device("cuda")
    dim_keys = torch.from_numpy(orders["o_orderkey"]).to(dev)
    dim_valid = torch.ones(cs.SF1_ORDERS, dtype=torch.bool, device=dev)
    slots = pk.probe_table_slots(cs.SF1_ORDERS)
    table = pk.build_probe_table(dim_keys, dim_valid, slots)

    def build():
        return pk.build_probe_table(dim_keys, dim_valid, slots)
    result = {"slots": slots, "build": {"ms": cs.time_ms(build, 20),
                                        "device_ms": cs.device_ms(build, 20, "K4 build")}}
    print(f"K4 build: {result['build']} [{card}]", flush=True)

    n = len(lineitem["l_orderkey"])
    line_keys = torch.from_numpy(lineitem["l_orderkey"]).to(dev)
    valid = torch.zeros(cs.BUCKET, dtype=torch.bool, device=dev)
    valid[:n] = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    order_draw = torch.rand(cs.SF1_ORDERS, device=dev, generator=gen)
    for share in HIT_SHARES:
        # a lineitem row misses when its order is dropped from the dim
        dropped = (order_draw >= share)[line_keys - 1]
        keys = torch.zeros(cs.BUCKET, dtype=torch.int64, device=dev)
        keys[:n] = torch.where(dropped, line_keys + cs.SF1_ORDERS, line_keys)
        got = pk.hash_probe_index(keys, valid, table)
        want = pk.hash_probe_index_plain(keys, valid, table)
        cs.check(torch.equal(got, want), f"K4 probe at {share:.0%} hits differs from its "
                                         "plain version")
        hits = int((got >= 0).sum())

        def probe(keys=keys):
            return pk.hash_probe_index(keys, valid, table)
        case = {"hit_rows": hits, "hit_share": hits / n, "ms": cs.time_ms(probe, 20),
                "device_ms": cs.device_ms(probe, 20, f"K4 probe {share:.0%}")}
        result[f"probe_{round(share * 100)}"] = case
        print(f"K4 probe at {share:.0%} of orders kept: {case} [{card}]", flush=True)
        del got, want, keys, dropped

    # K5 through chip_smoke.py's own input and timing functions, at both its shapes
    del line_keys, valid, order_draw
    k5 = cs.k5_inputs(lineitem, orders, table, dev)
    for shape in ("q12", "all_kept"):
        result[f"k5_{shape}"] = cs.k5_case(pk, k5, shape, lineitem, orders)
        print(f"K5 ({shape}): {result[f'k5_{shape}']} [{card}]", flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main())
