#!/usr/bin/env python3
"""Time the segment kernels K7 and K3 in each of their tiers at the caps
where one tier could take another's place, on one NVIDIA card.

    python3 tier_timings.py [--root DIR]

K7 (``segment_sum_float_planes``) sums lineitem's four float columns
(l_quantity, l_extendedprice, l_discount, l_tax as f32 planes; rows past the
supplier query's ship-date predicate kept, the rest and the padding to 2^23
rows in the trash segment) by l_suppkey folded into caps 64, 1024 and the
supplier query's 16,384, once in each tier the package has for those caps
that are not its thread tier ("block", "global"). K3
(``segment_extreme_int64``) takes the min of l_orderkey by l_partkey folded
into caps 2^15, 2^16 and 2^17, in the tier the package picks there and in
its global tier (one table in device memory). A tier is forced by
replacing the package's tier function for the call; every forced call must
agree with the kernel's plain version (K7 within twice the worst case of f64
summation, K3 exactly). Prints each case's device ms (torch.profiler) and
CUDA events ms, with the card's name and power limit, then one JSON line.

``--root`` drives the daft_tpu_torch of another checkout, for example an
unpacked parent commit, so that two versions are timed on one card in turns.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import chip_smoke as cs

K7_CAPS = (64, 1024, 16384)
K3_CAPS = (1 << 15, 1 << 16, 1 << 17)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"tier_timings.py: no daft_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, _ = cs.phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        result = run(card)
    except cs.SmokeFailure as exc:
        print(f"tier_timings.py: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    print(card)
    return 0


@contextlib.contextmanager
def _forced(sk, name: str, tier_fn):
    """Run with ``sk.<name>`` replaced by ``tier_fn`` and K7's cached launch
    plans dropped, so that the forced tier is the one planned."""
    saved = getattr(sk, name)
    setattr(sk, name, tier_fn)
    sk._float_plans.clear()
    try:
        yield
    finally:
        setattr(sk, name, saved)
        sk._float_plans.clear()


def run(card: str) -> dict:
    import numpy as np
    import torch

    from daft_tpu_torch.ops import segment_kernels as sk

    sk.build()
    lineitem, _orders = cs.tpch_sf1(cs.SEED)
    dev = torch.device("cuda")
    x = cs.slice_inputs(lineitem, dev)
    keep = x["keep"]
    rows = len(lineitem["l_suppkey"])
    floats = []
    for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        t = torch.zeros(cs.BUCKET, dtype=torch.float32)
        t[:rows] = torch.from_numpy(lineitem[name].astype(np.float32))
        floats.append(torch.where(keep, t.to(dev), 0.0))

    def folded(column: str, cap: int):
        group = torch.full((cs.BUCKET,), cap, dtype=torch.int32)
        group[:rows] = torch.from_numpy(((lineitem[column] - 1) % cap).astype(np.int32))
        return torch.where(keep, group.to(dev), cap)

    result = {"k7": {}, "k3": {}}
    own_k7 = sk.segment_sum_float_tier
    for cap in K7_CAPS:
        codes = folded("l_suppkey", cap)
        kinds = [k for k in ("block", "global") if k in sk._FLOAT_TIER_IDS]
        for kind in kinds:
            def tier(c, k, kind=kind):
                own = own_k7(c, k)
                return own if own.kind == kind else sk.FloatTier(kind, k)
            if kind == "block" and own_k7(cap, len(floats)).kind != "block":
                continue  # no block table fits this cap
            with _forced(sk, "segment_sum_float_tier", tier):
                case = cs.k7_case(sk, floats, codes, cap, f"cap {cap} {kind}")
            result["k7"][f"cap{cap}_{kind}"] = case
            print(f"K7 cap {cap} {kind} tier {case['tier']}: device_ms {case['device_ms']}, "
                  f"ms {case['ms']:.4f}, bound_ms {case['bound_ms']:.4f} [{card}]", flush=True)
        del codes

    orderkey = x["ints"]["l_orderkey"]
    own_k3 = sk.segment_extreme_int64_tier
    for cap in K3_CAPS:
        codes = folded("l_partkey", cap)
        tiers = {"own": own_k3(cap),
                 "global": own_k3(cap)._replace(cluster=0, slice=-(-cap // 32) * 32,
                                                warp_agg=False)}
        for label, forced in tiers.items():
            if label == "global" and tiers["own"] == forced:
                continue  # the package's own tier is the global one
            with _forced(sk, "segment_extreme_int64_tier", lambda c, t=forced: t):
                case = cs.k3_case(sk, orderkey, keep, codes, cap, "min")
            result["k3"][f"cap{cap}_{label}"] = case
            print(f"K3 cap {cap} {label} tier {case['tier']}: device_ms {case['device_ms']}, "
                  f"ms {case['ms']:.4f}, bound_ms {case['bound_ms']:.4f} [{card}]", flush=True)
        del codes
    return result


if __name__ == "__main__":
    sys.exit(main())
