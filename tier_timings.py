#!/usr/bin/env python3
"""Time the segment kernels K7 and K3 in each of their tiers at the caps
where one tier could take another's place, on one NVIDIA card.

    python3 tier_timings.py [--root DIR] [--k7-only]

K7 (``segment_sum_float_planes``) sums lineitem's four float columns
(l_quantity, l_extendedprice, l_discount, l_tax as f32 planes; rows past the
supplier query's ship-date predicate kept, the rest and the padding to 2^23
rows in the trash segment) by l_suppkey folded into caps 64 and 1024 and
the supplier query's 16,384: in the tier the package picks, in its block
tier with each plane group that fits a block, and in its global tier; and
in the designs of measure/k7_leads.cu: the two cluster designs, which read
the codes once for every plane (a cluster of blocks fed by one multicast
bulk copy of each tile of codes, each block holding a plane group's tables,
or a code range of every plane's, entry-major), and the split design (the
block tier with the codes past a split adding into device memory, K7_SPLITS).
Then at the partkey cell's own inputs (cap
2^18, l_extendedprice in f64) and at cap 2^20 (l_orderkey folded, two f32
planes) the same way. Each block- and global-tier case also measures the
card's rate of f64 atomic adds at its shape (chip_smoke.k7_atomic_rate) and
prints the atomics floor (the call's adds at that rate: the floor of a
design that adds each value by an atomic) beside the bytes bound.
``--k7-only`` stops there. K3 (``segment_extreme_int64``) takes the min of
l_orderkey by l_partkey folded into caps 2^15, 2^16 and 2^17, in the tier
the package picks there and in its global tier (one table in device
memory). A tier is forced by replacing the package's tier function for the
call; every call must agree with the kernel's plain version (K7 within
twice the worst case of f64 summation, K3 exactly). Prints each case's
device ms (torch.profiler) and CUDA events ms, with the card's name and
power limit, then one JSON line.

``--root`` drives the daft_tpu_torch of another checkout, for example an
unpacked parent commit, so that two versions are timed on one card in turns;
the cluster designs and the atomic rate are built from this checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import chip_smoke as cs

K7_CAPS = (64, 1024, 16384)
# the split design's (plane group, shared-table codes) at (cap, planes): the
# codes past the table add into device memory
K7_SPLITS = {(1024, 4): ((4, 768), (2, 768)),
             (16384, 4): ((1, 16384), (1, 13312), (1, 11776), (1, 10240), (2, 14528),
                          (2, 11776), (4, 7264))}
K3_CAPS = (1 << 15, 1 << 16, 1 << 17)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=cs.HERE,
                        help="the checkout whose daft_tpu_torch is driven")
    parser.add_argument("--k7-only", action="store_true", help="time K7 alone")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"tier_timings.py: no daft_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        card, _ = cs.phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        result = run(card, args.k7_only)
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


def _k7_forced_tiers(sk, cap: int, nplanes: int):
    """K7's tiers at one shape, each with a label: the package's own; its
    block tier with each plane group from one plane to all that fit a
    block's shared memory; its global tier."""
    own = sk.segment_sum_float_tier(cap, nplanes)
    tiers = [(own.kind if own.kind != "block" else f"block{own.group}", own)]
    fit = min(nplanes, sk.PLANE_SMEM_MAX // (cap * 8))
    tiers += [(f"block{g}", sk.FloatTier("block", g)) for g in range(1, fit + 1)
              if sk.FloatTier("block", g) != own]
    if own.kind != "global":
        tiers.append(("global", sk.FloatTier("global", nplanes)))
    return tiers


def _print_case(label: str, kind: str, case: dict, card: str) -> None:
    rate = case.get("atomic_rate")
    rates = list(rate.values()) if rate and "memory" not in rate else [rate] if rate else []
    atomics = (f", atomics floor {case['bound_atomics_ms']:.4f} ms (f64 atomics at " +
               " and ".join(f"{r['adds_per_s']:.4g}/s in {r['memory']} memory" for r in rates) +
               ")" if case.get("bound_atomics_ms") else "")
    print(f"K7 {label} {kind} tier {case['tier']}: device_ms {case['device_ms']}, "
          f"ms {case['ms']:.4f}, bound_ms {case['bound_ms']:.4f}{atomics}, "
          f"max_abs_err {case['max_abs_err']} [{card}]", flush=True)


def _lead_case(call, planes, codes, cap: int, tier: list, label: str, floor) -> dict:
    """A design of measure/k7_leads.cu on f32 planes, held to twice the f64
    order bound of the package's plain version like the package's tiers and
    timed the same way. ``floor(kept)`` gives its atomics floor in ms and
    the rate or rates it was taken at, from the mask of kept rows."""
    from daft_tpu_torch.ops import segment_kernels as sk

    got = call().clone()
    want = sk.segment_sum_float_planes_plain(planes, codes, cap)
    err = (got - want).abs()
    cs.check(bool((err <= 2 * cs.f64_order_bound(planes, codes, cap)).all()),
             f"K7 {label} differs from the plain version past the f64 order bound")
    kept = (codes >= 0) & (codes < cap)
    sectors = int(kept.view(-1, 8).any(dim=1).sum())
    n, p = codes.numel(), len(planes)
    floor_ms, rate = floor(kept)
    return {"cap": cap, "planes": p, "tier": tier, "max_abs_err": float(err.max()),
            "ms": cs.time_ms(call, 20), "device_ms": cs.device_ms(call, 20, f"K7 {label}"),
            "bound_ms": cs.bound_ms(n * 4 + sectors * 32 * p + cap * p * 8),
            "atomic_rate": rate, "bound_atomics_ms": floor_ms}


def _at_rate(adds: int, rate: dict):
    """ms of ``adds`` atomics at a measured rate (None where not measured)."""
    return adds / rate["adds_per_s"] * 1e3 if rate["adds_per_s"] else None


def k7_cluster_case(planes, codes, cap: int, by_range: bool, label: str):
    """K7 by a cluster design of measure/k7_leads.cu; None where no cluster
    of at most 8 blocks holds the shape's tables."""
    import ctypes

    import torch

    lib = cs.measure_library()
    g, clusters, words = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    p = len(planes)
    if lib.daft_k7_cluster_shape(int(by_range), cap, p, ctypes.byref(g), ctypes.byref(clusters),
                                 ctypes.byref(words)) != 0:
        return None
    part = torch.empty(words.value, dtype=torch.float64, device=codes.device)
    out = torch.empty((cap, p), dtype=torch.float64, device=codes.device)
    ptrs = (ctypes.c_void_p * p)(*[t.data_ptr() for t in planes])
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    n = codes.numel()

    def call():
        rc = lib.daft_k7_cluster(int(by_range), ptrs, p, codes.data_ptr(), part.data_ptr(),
                                 out.data_ptr(), n, cap, clusters.value, stream)
        cs.check(rc == 0, f"K7 {label} failed to launch (CUDA error {rc})")
        return out
    def floor(kept):
        # every add at the atomic rate into one block's table: a code range
        # of every plane, or every code of a plane group
        if by_range:
            rate = cs.k7_atomic_rate(codes, -(-cap // g.value), p, shared=True)
        else:
            rate = cs.k7_atomic_rate(codes, cap, -(-p // g.value), shared=True)
        return _at_rate(sum(int((kept & (t != 0)).sum()) for t in planes), rate), rate
    case = _lead_case(call, planes, codes, cap, ["range" if by_range else "groups", g.value],
                      label, floor)
    case["clusters"] = clusters.value
    return case


def k7_split_case(planes, codes, cap: int, group: int, split: int, label: str) -> dict:
    """K7 by the split design of measure/k7_leads.cu: plane groups of
    ``group`` in blocks whose shared tables hold the codes below ``split``,
    the rest adding into the output by device-memory reductions."""
    import ctypes

    import torch

    lib = cs.measure_library()
    fit = ctypes.c_int(0)
    cs.check(lib.daft_k7_split_blocks(group, split, ctypes.byref(fit)) == 0,
             f"K7 {label}: no launch fits")
    p = len(planes)
    groups = -(-p // group)
    blocks = groups * max(1, fit.value // groups)
    part = torch.empty(blocks * group * split, dtype=torch.float64, device=codes.device)
    out = torch.empty((cap, p), dtype=torch.float64, device=codes.device)
    ptrs = (ctypes.c_void_p * p)(*[t.data_ptr() for t in planes])
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    n = codes.numel()

    def call():
        out.zero_()
        rc = lib.daft_k7_split(ptrs, p, codes.data_ptr(), part.data_ptr(), out.data_ptr(), n,
                               cap, split, group, blocks, stream)
        cs.check(rc == 0, f"K7 {label} failed to launch (CUDA error {rc})")
        return out
    def floor(kept):
        # the codes below split at the shared-memory rate, the rest at the
        # device-memory rate; the two units work side by side
        nonzero = [kept & (t != 0) for t in planes]
        shared = cs.k7_atomic_rate(codes, split, group, shared=True)
        device = cs.k7_atomic_rate(codes, cap, p)
        times = [_at_rate(sum(int((z & (codes < split)).sum()) for z in nonzero), shared),
                 _at_rate(sum(int((z & (codes >= split)).sum()) for z in nonzero), device)]
        return (None if None in times else max(times)), {"shared": shared, "device": device}
    case = _lead_case(call, planes, codes, cap, ["split", group, split], label, floor)
    case["device_share"] = 1 - split / cap
    return case


def _k7_cases(sk, planes, codes, cap: int, label: str, card: str, out: dict) -> None:
    """K7 at one shape in each tier the package has for it, then in the
    cluster designs where the planes are f32."""
    for kind, forced in _k7_forced_tiers(sk, cap, len(planes)):
        with _forced(sk, "segment_sum_float_tier", lambda c, k, t=forced: t):
            case = cs.k7_case(sk, planes, codes, cap, f"{label} {kind}")
        out[f"{label}_{kind}"] = case
        _print_case(label, kind, case, card)
    if planes[0].dtype.itemsize != 4:
        return
    for by_range in (False, True):
        kind = "cluster_range" if by_range else "cluster_groups"
        case = k7_cluster_case(planes, codes, cap, by_range, f"{label} {kind}")
        if case is not None:
            out[f"{label}_{kind}"] = case
            _print_case(label, kind, case, card)
    for group, split in K7_SPLITS.get((cap, len(planes)), ()):
        kind = f"split{group}_{split}"
        case = k7_split_case(planes, codes, cap, group, split, f"{label} {kind}")
        out[f"{label}_{kind}"] = case
        _print_case(label, kind, case, card)


def run(card: str, k7_only: bool = False) -> dict:
    import numpy as np
    import torch

    from daft_tpu_torch.ops import segment_kernels as sk

    sk.build()
    lineitem, _orders, _dims = cs.tpch_sf1(cs.SEED)
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
    for cap in K7_CAPS:
        codes = folded("l_suppkey", cap)
        _k7_cases(sk, floats, codes, cap, f"cap{cap}", card, result["k7"])
        del codes
    pk_in = cs.partkey_inputs(lineitem, dev)
    _k7_cases(sk, pk_in["price"], pk_in["codes"], cs.PARTKEY_CAP, "partkey_cap262144_f64",
              card, result["k7"])
    del pk_in
    codes = folded("l_orderkey", cs.MAX_CAP)
    _k7_cases(sk, floats[:2], codes, cs.MAX_CAP, "cap1048576", card, result["k7"])
    del codes, floats
    torch.cuda.empty_cache()
    if k7_only:
        return result

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
