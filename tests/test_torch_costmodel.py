"""The port's cost model (daft_tpu_torch/ops/costmodel.py) against the
reference's (daft_tpu/ops/costmodel.py).

One Calibration is built from the same seeded numbers in both packages
(the reference's one-hot, scatter and Pallas rates, which the port has no
tier for, are filled in on its side only). Every arm both packages have
gives the reference's terms and totals exactly on numpy-seeded shapes:
``CostBreakdown`` arithmetic and comparisons, ``expected_coalesce_factor``,
``_base_terms``, ``device_ungrouped_cost``, ``device_udf_cost``, the host
arms and ``rebuild_cost_estimate``. With every ``DAFT_TPU_COST_*`` set,
``calibrate()`` returns the reference's values for the shared fields and
probes nothing. The port's own arms (``device_grouped_kernel_cost``,
``device_join_kernel_cost``: the kernel tier, which has no rows x cap
cells) are held to what they price: resident bytes make them cheaper, more
planes, rows, probed rows or a larger cap dearer. The reference's
``device_grouped_cost``, ``device_grouped_sort_cost``,
``device_join_agg_cost``, ``device_*_pallas_cost`` and
``_segment_reduce_terms`` have no counterpart (ROADMAP Queue 3), and its
mesh arms wait for the mesh stages (Queue 1 item 3).
"""

import dataclasses

import numpy as np
import pytest

from daft_tpu.ops import costmodel as ref
from daft_tpu_torch.ops import costmodel as port

SEED = 20261018
SHARED = ("rtt_s", "h2d_bytes_per_s", "d2h_bytes_per_s", "mm_plane_rows_per_s",
          "host_agg_rate", "host_factorize_rate", "host_probe_rate",
          "udf_device_flops_per_s", "udf_host_flops_per_s")
# the reference's fields without a port tier: (field, its env override)
REF_ONLY = (("mm_cell_rate", "DAFT_TPU_COST_MM_CELL_RATE"),
            ("scatter_rows_per_s", "DAFT_TPU_COST_SCATTER_RATE"),
            ("ext_cell_rate", "DAFT_TPU_COST_EXT_RATE"),
            ("pallas_cell_rate", "DAFT_TPU_COST_PALLAS_RATE"),
            ("pallas_probe_cell_rate", "DAFT_TPU_COST_PALLAS_PROBE_RATE"),
            ("ici_bytes_per_s", "DAFT_TPU_COST_ICI"),
            ("mesh_dispatch_s", "DAFT_TPU_COST_MESH_DISPATCH"))
# each shared field's override, the same name in both packages
SHARED_ENV = {"rtt_s": "DAFT_TPU_COST_RTT", "h2d_bytes_per_s": "DAFT_TPU_COST_H2D",
              "d2h_bytes_per_s": "DAFT_TPU_COST_D2H",
              "mm_plane_rows_per_s": "DAFT_TPU_COST_MM_RATE",
              "host_agg_rate": "DAFT_TPU_COST_HOST_AGG",
              "host_factorize_rate": "DAFT_TPU_COST_HOST_FACT",
              "host_probe_rate": "DAFT_TPU_COST_HOST_PROBE",
              "udf_device_flops_per_s": "DAFT_TPU_COST_UDF_FLOPS",
              "udf_host_flops_per_s": "DAFT_TPU_COST_UDF_HOST_FLOPS"}


def _numbers(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"rtt_s": float(rng.uniform(1e-5, 1e-1)),
            "h2d_bytes_per_s": float(rng.uniform(1e8, 5e10)),
            "d2h_bytes_per_s": float(rng.uniform(1e6, 5e10)),
            "mm_plane_rows_per_s": float(rng.uniform(1e9, 1e12)),
            "host_agg_rate": float(rng.uniform(1e7, 1e10)),
            "host_factorize_rate": float(rng.uniform(1e6, 1e9)),
            "host_probe_rate": float(rng.uniform(1e6, 1e9)),
            "udf_device_flops_per_s": float(rng.uniform(1e11, 1e14)),
            "udf_host_flops_per_s": float(rng.uniform(1e9, 1e12))}


def _pair(seed: int):
    """(reference Calibration, port Calibration) from the same numbers."""
    nums = _numbers(seed)
    rng = np.random.default_rng(seed + 1)
    extra = {name: float(rng.uniform(1e9, 1e12)) for name, _env in REF_ONLY}
    return ref.Calibration(**nums, **extra), port.Calibration(**nums)


def _shape(seed: int) -> dict:
    rng = np.random.default_rng(seed + 2)
    return {"rows": int(rng.integers(1, 1 << 24)),
            "bytes": int(rng.integers(0, 1 << 30)),
            "resident": int(rng.integers(0, 1 << 30)),
            "partials": int(rng.integers(1, 16)),
            "aggs": int(rng.integers(0, 12)),
            "dims": int(rng.integers(0, 5)),
            "region_ops": int(rng.integers(0, 6)),
            "coalesce": float(rng.choice([1.0, 1.0, rng.uniform(1.0, 64.0)])),
            "flops": float(rng.uniform(1e6, 1e14)),
            "fetch": int(rng.integers(0, 1 << 24)),
            "grouped": bool(rng.integers(0, 2)),
            "pred": bool(rng.integers(0, 2))}


SEEDS = [SEED + i for i in range(6)]


def _same(a, b) -> None:
    """Equal breakdowns: the same terms and notes, value for value, exactly."""
    assert a.as_dict() == b.as_dict()
    assert a.total == b.total


@pytest.mark.parametrize("seed", SEEDS)
def test_shared_arms_equal_the_reference_exactly(seed):
    rc, pc = _pair(seed)
    s = _shape(seed)
    _same(port._base_terms(pc, s["bytes"], s["coalesce"], s["resident"]),
          ref._base_terms(rc, s["bytes"], s["coalesce"], s["resident"]))
    _same(port.device_ungrouped_cost(pc, s["rows"], s["bytes"], s["partials"],
                                     coalesce=s["coalesce"], resident_bytes=s["resident"]),
          ref.device_ungrouped_cost(rc, s["rows"], s["bytes"], s["partials"],
                                    coalesce=s["coalesce"], resident_bytes=s["resident"]))
    _same(port.device_udf_cost(pc, s["rows"], s["bytes"], s["flops"], s["fetch"],
                               coalesce=s["coalesce"]),
          ref.device_udf_cost(rc, s["rows"], s["bytes"], s["flops"], s["fetch"],
                              coalesce=s["coalesce"]))
    _same(port.host_udf_cost(pc, s["flops"]), ref.host_udf_cost(rc, s["flops"]))
    _same(port.host_agg_cost(pc, s["rows"], s["aggs"], s["grouped"], s["pred"],
                             n_region_ops=s["region_ops"]),
          ref.host_agg_cost(rc, s["rows"], s["aggs"], s["grouped"], s["pred"],
                            n_region_ops=s["region_ops"]))
    _same(port.host_join_agg_cost(pc, s["rows"], s["dims"], s["aggs"], s["grouped"],
                                  s["pred"]),
          ref.host_join_agg_cost(rc, s["rows"], s["dims"], s["aggs"], s["grouped"],
                                 s["pred"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_cost_breakdown_arithmetic_and_comparisons_match(seed):
    rng = np.random.default_rng(seed)
    terms = {k: float(rng.uniform(0, 1)) for k in ("rtt", "h2d", "compute", "d2h")}
    terms["factorize"] = 0.0  # a zero term is dropped by both
    notes = {"coalesce": float(rng.uniform(1, 8))}
    a, b = port.CostBreakdown(_notes=notes, **terms), ref.CostBreakdown(_notes=notes, **terms)
    _same(a, b)
    x = float(rng.uniform(0, 2))
    for op in ("__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__"):
        assert getattr(a, op)(x) == getattr(b, op)(x)
    assert float(a) == float(b) and a * 1e3 == b * 1e3 and 2.0 * a == 2.0 * b
    assert repr(a) == repr(b) and hash(a) == hash(b)
    _same(a + x, b + x)
    _same(x + a, x + b)
    other = {"compute": float(rng.uniform(0, 1)), "probe": float(rng.uniform(0, 1))}
    _same(a + port.CostBreakdown(**other), b + ref.CostBreakdown(**other))
    _same(a.add("compute", x).note("k", x), b.add("compute", x).note("k", x))


@pytest.mark.parametrize("seed", SEEDS)
def test_expected_coalesce_factor_matches(seed):
    rng = np.random.default_rng(seed)
    for first, target in zip(rng.integers(-4, 1 << 20, 64), rng.integers(-4, 1 << 20, 64)):
        assert port.expected_coalesce_factor(int(first), int(target)) == \
            ref.expected_coalesce_factor(int(first), int(target))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_rebuild_cost_estimate_matches(seed, monkeypatch):
    rc, pc = _pair(seed)
    rng = np.random.default_rng(seed)
    cases = [(int(b), int(r)) for b, r in zip(rng.integers(0, 1 << 30, 8),
                                              rng.integers(0, 1 << 24, 8))]
    monkeypatch.setattr(ref, "_CAL", rc)
    monkeypatch.setattr(port, "_CAL", pc)
    for nbytes, rows in cases:
        assert port.rebuild_cost_estimate(nbytes, rows) == ref.rebuild_cost_estimate(nbytes,
                                                                                     rows)
    # uncalibrated, both read the same overrides
    monkeypatch.setattr(ref, "_CAL", None)
    monkeypatch.setattr(port, "_CAL", None)
    monkeypatch.setenv("DAFT_TPU_COST_H2D", repr(pc.h2d_bytes_per_s))
    monkeypatch.setenv("DAFT_TPU_COST_HOST_FACT", repr(pc.host_factorize_rate))
    for nbytes, rows in cases:
        assert port.rebuild_cost_estimate(nbytes, rows) == ref.rebuild_cost_estimate(nbytes,
                                                                                     rows)


def test_calibrate_from_env_equals_the_reference_without_probing(monkeypatch):
    rc, pc = _pair(SEED)
    for f in SHARED:
        monkeypatch.setenv(SHARED_ENV[f], repr(getattr(pc, f)))
    for f, env in REF_ONLY:
        monkeypatch.setenv(env, repr(getattr(rc, f)))

    def no_probe(*_a, **_k):
        raise AssertionError("calibrate() probed the link with every term pinned")

    monkeypatch.setattr(port, "_probe_link", no_probe)
    monkeypatch.setattr(ref, "_probe_mesh_terms", no_probe)
    port.reset_calibration()
    ref.reset_calibration()
    try:
        got, want = port.calibrate(), ref.calibrate()
        for f in SHARED:
            assert getattr(got, f) == getattr(want, f), f
        assert port.current_calibration() is got
        assert {k: port.calibration_dict()[k] for k in SHARED} == \
            {k: ref.calibration_dict()[k] for k in SHARED}
    finally:
        port.reset_calibration()
        ref.reset_calibration()
    assert port.calibration_dict() == {}


def test_calibration_fields_are_the_shared_ones_and_the_ports_own():
    fields = {f.name for f in dataclasses.fields(port.Calibration)}
    ref_fields = {f.name for f in dataclasses.fields(ref.Calibration)}
    assert set(SHARED) <= fields and set(SHARED) <= ref_fields
    own = fields - set(SHARED)
    assert own == {"k1_plane_rows_per_s", "k7_plane_rows_per_s", "k2_plane_rows_per_s",
                   "k3_plane_rows_per_s", "k4_probe_rows_per_s", "gather_plane_rows_per_s",
                   "sort_rows_per_s", "table_bytes_per_s"}
    # every rate but the three link terms has a default and an override of
    # its own; none is the reference's (v5e) default
    assert set(port.RATES) == fields - {"rtt_s", "h2d_bytes_per_s", "d2h_bytes_per_s"}
    ref_defaults = {1.5e8, 8e6, 3e7, 5e9, 2e11}  # host agg, factorize, probe, mm, udf
    assert len({env for env, _v in port.RATES.values()}) == len(port.RATES)
    assert not ref_defaults & {v for _env, v in port.RATES.values()}


def _kernel_cal() -> port.Calibration:
    return port.Calibration(**_numbers(SEED))


@pytest.mark.parametrize("seed", SEEDS)
def test_grouped_kernel_arm_prices_what_it_reads(seed):
    cal = _kernel_cal()
    s = _shape(seed)
    rng = np.random.default_rng(seed)
    planes = [int(x) for x in rng.integers(1, 6, 4)]
    cap = int(rng.choice([8, 1 << 10, 1 << 16, 1 << 20]))
    args = dict(k1=planes[0], k7=planes[1], k2=planes[2], k3=planes[3], cap=cap,
                factorize_rows=s["rows"], coalesce=s["coalesce"])
    base = port.device_grouped_kernel_cost(cal, s["rows"], s["bytes"], **args)
    assert {"rtt", "compute", "table", "d2h", "factorize"} <= set(base.terms)
    # resident bytes are priced at zero and noted as the credit
    res = port.device_grouped_kernel_cost(cal, s["rows"], 0, resident_bytes=s["bytes"] + 1,
                                          **args)
    assert res.total < base.total or s["bytes"] == 0
    assert res.notes["residency_credit_s"] > 0
    # more rows, another plane of each family, a larger cap: dearer
    assert port.device_grouped_kernel_cost(cal, 2 * s["rows"], s["bytes"], **args) > base
    for fam in ("k1", "k7", "k2", "k3"):
        more = dict(args, **{fam: args[fam] + 1})
        assert port.device_grouped_kernel_cost(cal, s["rows"], s["bytes"], **more) > base
    bigger = dict(args, cap=cap * 2)
    assert port.device_grouped_kernel_cost(cal, s["rows"], s["bytes"], **bigger) > base
    # the kernels read each plane once: no rows x cap cells
    assert base.terms["compute"] == pytest.approx(s["rows"] * (
        planes[0] / cal.k1_plane_rows_per_s + planes[1] / cal.k7_plane_rows_per_s
        + planes[2] / cal.k2_plane_rows_per_s + planes[3] / cal.k3_plane_rows_per_s))


@pytest.mark.parametrize("seed", SEEDS)
def test_join_kernel_arm_prices_what_it_reads(seed):
    cal = _kernel_cal()
    s = _shape(seed)
    grouped = dict(k1=2, k7=1, k2=1, k3=0, n_partials=0)
    ungrouped = dict(k1=0, k7=0, k2=0, k3=0, n_partials=s["partials"])
    for kind in (grouped, ungrouped):
        args = dict(probe_rows=s["rows"], n_gathers=3, cap_est=1 << 12, fetch_bytes=s["fetch"],
                    factorize_rows=s["rows"], coalesce=s["coalesce"], **kind)
        base = port.device_join_kernel_cost(cal, s["rows"], s["bytes"], **args)
        assert {"rtt", "probe", "compute", "factorize"} <= set(base.terms)
        assert ("table" in base.terms) == (kind is grouped)
        warm = port.device_join_kernel_cost(cal, s["rows"], 0, resident_bytes=s["bytes"] + 1,
                                            **dict(args, probe_rows=0, factorize_rows=0))
        assert warm < base and "probe" not in warm.terms
        assert port.device_join_kernel_cost(cal, 2 * s["rows"], s["bytes"], **args) > base
        assert port.device_join_kernel_cost(cal, s["rows"], s["bytes"],
                                            **dict(args, n_gathers=4)) > base
        assert base.terms["probe"] == s["rows"] / cal.k4_probe_rows_per_s


def test_calibration_terms_exported_as_gauges(monkeypatch):
    from daft_tpu_torch.observability.metrics import registry

    monkeypatch.setenv("DAFT_TPU_COST_RTT", "0.042")
    monkeypatch.setenv("DAFT_TPU_COST_H2D", "2e9")
    monkeypatch.setenv("DAFT_TPU_COST_D2H", "3e6")
    port.reset_calibration()
    try:
        cal = port.calibrate()
        assert cal.rtt_s == 0.042
        snap = registry().snapshot()
        assert snap["cost_rtt_s"] == 0.042
        assert snap["cost_h2d_bytes_per_s"] == 2e9
        assert snap["cost_d2h_bytes_per_s"] == 3e6
        assert snap["cost_udf_flops_per_s"] == cal.udf_device_flops_per_s
        assert port.calibration_dict()["k1_plane_rows_per_s"] == \
            port.RATES["k1_plane_rows_per_s"][1]
    finally:
        port.reset_calibration()
    assert registry().snapshot()["cost_rtt_s"] == 0.0
    assert port.calibration_dict() == {}


def test_calibrate_without_a_card_or_the_link_terms_raises(monkeypatch):
    import torch

    for env in ("DAFT_TPU_COST_RTT", "DAFT_TPU_COST_H2D", "DAFT_TPU_COST_D2H"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port.reset_calibration()
    with pytest.raises(RuntimeError, match="DAFT_TPU_COST_RTT"):
        port.calibrate()
    assert port.current_calibration() is None
