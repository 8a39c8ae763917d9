"""The expression surface's operators and device functions through four
paths, against the reference (daft_tpu/expressions/expressions.py:116-263,
daft_tpu/ops/device_eval.py).

Each case runs the same seeded columns through the reference's host
(``select`` under device_mode="off"), the reference's ``build_device_expr``
on JAX's CPU, the port's host and the port's device program
(``build_device_expr`` on ``torch.device("cpu")``). The port's two paths
equal the reference's host: integers, booleans and validity bit for bit,
floats within rtol 1e-5 (infinities and NaN in the same places). The
reference's own device program equals its host too, except where
``REF_DEVICE_DIFFERS`` says why not. The inputs hold nulls, NaN, +-inf,
-0.0, zero divisors and int64 values on both sides of 2^53.

The device program in f32 (``float_dtype=torch.float32``, the grouped
stage's program where no float min or max forces f64) is held against the
reference's host on the same float columns rounded to f32 (DATA's rows and
more, 4096 in all), each float result rounded to f32: integers, booleans
and validity bit for bit, floats within ``F32_ULPS`` units in the last
place (NaN and infinities, f32 overflow included, in the same places). Grouped queries of the functions without a float extreme run
through the stage on the CPU, in f32 and, where a float is rounded to
decimals, in f64, and equal the host path within rtol 1e-5.

A whole f32 stage, end to end: f64 columns uploaded as f32, a fused
Project / Filter chain of the device functions (fill_nan, log10, sqrt,
round, clip, abs, floor, ``%``, ``//``) under a grouped and an ungrouped
aggregate, one dispatch each, equal to the host path over the f64 columns:
keys, counts and integer min/max bit for bit, float sums and means within
rtol 1e-5 (F3's device-vs-host tolerance).

``is_device_evaluable`` agrees with the reference's on a list of
expressions over one schema, uint64 aside (no torch device type).
"""

import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
import f32_stage_case
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.ops import device_eval as ref_de
from daft_tpu_torch.ops import device_eval as port_de

RTOL = 1e-5
# units in the last place of f32 the f32 program may be off: its inputs are
# the target's, so only the op's own rounding is left (CUDA's f32 math
# functions are within 4 ulps, torch's CPU ones within 1 here)
F32_ULPS = 8
BIG = 2 ** 53
N = 48


def _columns():
    rng = np.random.default_rng(20)
    i = [0, 1, -1, 7, -7, BIG - 1, BIG + 1, -(BIG + 3), 123456789, None, 5, -12]
    # the reference's floordiv goes through f64 and refuses an integer past 2^53
    k = [0, 1, -1, 7, -7, BIG - 1, BIG, -BIG, 123456789, None, 5, -12]
    j = [3, 0, -2, 2, -3, 7, -5, 4, 0, 3, None, 5]
    f = [1.5, -0.0, 0.0, float("nan"), float("inf"), float("-inf"), -2.25, 0.5, None,
         3.0, 1e-3, 17.75]
    g = [2.0, 0.0, -0.0, 1.5, 2.0, -3.0, 0.75, float("nan"), 4.0, None, -0.5, 2.5]
    b = [True, False, None, True, False, None, True, False, True, None, False, True]
    c = [True, True, False, None, None, False, False, True, None, True, False, False]
    m = len(i)
    extra = N - m
    i += rng.integers(-10 ** 6, 10 ** 6, extra).tolist()
    k += rng.integers(-10 ** 6, 10 ** 6, extra).tolist()
    j += rng.integers(-9, 10, extra).tolist()
    f += np.round(rng.normal(0, 40, extra), 3).tolist()
    g += rng.choice([-2.5, -1.0, 0.0, 0.5, 3.0], extra).tolist()
    b += rng.choice([True, False], extra).tolist()
    c += rng.choice([True, False], extra).tolist()
    s = rng.integers(-20, 21, N).astype(np.int32)
    u = np.round(rng.uniform(0.0, 1.0, N), 3)  # in arcsin's domain
    return {"i": i, "k": k, "j": j, "f": f, "g": g, "b": b, "c": c, "s": s, "u": u}


DATA = _columns()


def _cases(m):
    """name -> expression in package ``m`` (daft_tpu or daft_tpu_torch)."""
    col, lit = m.col, m.lit
    i, j, k, f, g, s, u = (col(n) for n in "ijkfgsu")
    b, c = col("b"), col("c")
    out = {
        "floordiv_int": k // j, "floordiv_float": f // g, "floordiv_lit": s // 3,
        "floordiv_big": k // 7, "mod_int": i % j, "mod_float": f % g, "mod_lit": s % 4,
        "mod_neg": i % -3, "pow_float": f ** 2, "pow_frac": s ** 0.5, "pow_int": j ** 3,
        "xor": b ^ c, "fill_null_int": i.fill_null(5), "fill_null_float": f.fill_null(1.5),
        "fill_null_bool": b.fill_null(False), "eq_null_safe_int": i.eq_null_safe(j),
        "eq_null_safe_float": f.eq_null_safe(g), "eq_null_safe_bool": b.eq_null_safe(c),
        "abs_int": i.abs(), "abs_float": f.abs(), "abs_i32": s.abs(),
        "is_in_i32": s.is_in([1, 3, 5, -7]), "is_in_big": i.is_in([0, BIG + 1, 7]),
        "is_in_float": f.is_in([1.5, 0.0, -2.25]), "is_in_nan": f.is_in([float("nan"), 3.0]),
        "abs_diff_gt": ((f - g).abs() > 1.0), "mod_filter": (i % 7) != 0,
        "log": f.log(), "log_base": f.log(2.0), "round0": f.round(), "round1": f.round(1),
        "round_i": s.round(-1), "clip_float": f.clip(-1.0, 2.0), "clip_int": s.clip(-5, 5),
        "is_nan": f.float.is_nan(), "is_inf": f.float.is_inf(), "not_nan": f.float.not_nan(),
        "fill_nan": f.float.fill_nan(9.5), "floor_i": s.floor(), "ceil_i": s.ceil(),
        "sign_i": s.sign(), "arcsin": u.arcsin(), "arccos": u.arccos(),
    }
    for name in ("exp", "sqrt", "sin", "cos", "tan", "arctan", "log2", "log10", "cbrt",
                 "expm1", "log1p", "sinh", "cosh", "tanh", "degrees", "radians", "floor",
                 "ceil", "sign"):
        out[name] = m.col("f")._fn(name)
    return out


CASES = sorted(_cases(daft_tpu_torch))
# cases where the reference's own device program gives another answer than
# its host: (case, why); the port's two paths still equal the reference's host
REF_DEVICE_DIFFERS = {
    "round_i": "jnp.round refuses an integer column with decimals < 0",
    "is_in_float": "jnp's == takes -0.0 for 0.0; Arrow's is_in does not",
    "is_in_nan": "jnp's == never matches NaN; Arrow's is_in does",
    "sign": "jnp.sign(-0.0) is -0.0; Arrow's is 0.0",
}


def _ref_host(name):
    e = _cases(daft_tpu)[name].alias("out")
    with ref_ctx(device_mode="off"):
        return daft_tpu.from_pydict(DATA).select(e).to_pydict()["out"]


def _port_host(name):
    e = _cases(daft_tpu_torch)[name].alias("out")
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        return daft_tpu_torch.from_pydict(DATA).select(e).to_pydict()["out"]


def _planes(batch):
    return {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns()}


def _pylist(values, valid):
    v = np.broadcast_to(np.asarray(values), valid.shape)
    return [x if ok else None for x, ok in zip(v.tolist(), valid.tolist())]


def _port_device(name):
    part = daft_tpu_torch.MicroPartition.from_pydict(DATA)
    batch = part.batches[0]
    e = _cases(daft_tpu_torch)[name]
    assert port_de.is_device_evaluable(e, batch.schema), name
    cols = {n: (torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(m))
            for n, (v, m) in _planes(batch).items()}
    v, m = port_de.build_device_expr(e, batch.schema)(cols, torch.device("cpu"))
    valid = np.broadcast_to(m.numpy(), (N,))
    return _pylist(v.numpy(), valid)


def _ref_device(name):
    import jax.numpy as jnp

    df = daft_tpu.from_pydict(DATA).collect()
    batch = df._result[0].concat_or_empty()
    e = _cases(daft_tpu)[name]
    assert ref_de.is_device_evaluable(e, batch.schema), name
    cols = {s.name: (jnp.asarray(s.to_numpy()), jnp.asarray(s.validity_numpy()))
            for s in batch.columns}
    v, m = ref_de.build_device_expr(e, batch.schema)(cols)
    valid = np.broadcast_to(np.asarray(m), (N,))
    return _pylist(np.asarray(v), valid)


def _same(got, want, name):
    assert [x is None for x in got] == [x is None for x in want], name
    gv = [x for x in got if x is not None]
    wv = [x for x in want if x is not None]
    if any(isinstance(x, float) for x in wv):
        g, w = np.array(gv, dtype=np.float64), np.array(wv, dtype=np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        assert np.array_equal(np.isposinf(g), np.isposinf(w)), name
        assert np.array_equal(np.isneginf(g), np.isneginf(w)), name
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=0.0, err_msg=name)
    else:
        assert gv == wv, name


@pytest.mark.parametrize("name", CASES)
def test_four_paths_equal_the_reference_host(name):
    want = _ref_host(name)
    _same(_port_host(name), want, f"{name} (port host)")
    _same(_port_device(name), want, f"{name} (port device)")
    if name not in REF_DEVICE_DIFFERS:
        _same(_ref_device(name), want, f"{name} (reference device)")


F32_ROWS = 4096


def _f32_data():
    """DATA's rows and more drawn alike, F32_ROWS in all, with the float
    columns rounded to f32 (still f64 columns)."""
    rng = np.random.default_rng(32)
    extra = F32_ROWS - N
    out = {
        "i": DATA["i"] + rng.integers(-10 ** 6, 10 ** 6, extra).tolist(),
        "k": DATA["k"] + rng.integers(-10 ** 6, 10 ** 6, extra).tolist(),
        "j": DATA["j"] + rng.integers(-9, 10, extra).tolist(),
        "f": DATA["f"] + np.round(rng.normal(0, 40, extra), 3).tolist(),
        "g": DATA["g"] + rng.choice([-2.5, -1.0, 0.0, 0.5, 3.0], extra).tolist(),
        "b": DATA["b"] + rng.choice([True, False], extra).tolist(),
        "c": DATA["c"] + rng.choice([True, False], extra).tolist(),
        "s": np.concatenate([DATA["s"], rng.integers(-20, 21, extra).astype(np.int32)]),
        "u": np.concatenate([DATA["u"], np.round(rng.uniform(0.0, 1.0, extra), 3)]),
    }
    for n in ("f", "g"):
        out[n] = [None if v is None else float(np.float32(v)) for v in out[n]]
    out["u"] = out["u"].astype(np.float32).astype(np.float64)
    return out


def _round_f32(values):
    with np.errstate(over="ignore"):  # past f32's range rounds to inf, as the program gives
        return [float(np.float32(v)) if isinstance(v, float) else v for v in values]


def _same_f32(got, want, name):
    """``_same`` at f32's tolerance, ``F32_ULPS`` units in the last place of
    ``want`` (already rounded to f32; a subnormal's unit included)."""
    assert [x is None for x in got] == [x is None for x in want], name
    gv = [x for x in got if x is not None]
    wv = [x for x in want if x is not None]
    if any(isinstance(x, float) for x in wv):
        g, w = np.array(gv, dtype=np.float64), np.array(wv, dtype=np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        assert np.array_equal(np.isposinf(g), np.isposinf(w)), name
        assert np.array_equal(np.isneginf(g), np.isneginf(w)), name
        ok = np.isfinite(w)
        ulp = np.spacing(np.abs(w[ok]).astype(np.float32)).astype(np.float64)
        off = np.abs(g[ok] - w[ok]) > F32_ULPS * ulp
        assert not off.any(), (name, g[ok][off][:5], w[ok][off][:5])
    else:
        assert gv == wv, name


@pytest.mark.parametrize("name", CASES)
def test_port_device_in_f32_equals_the_reference_host_on_f32_inputs(name):
    data = _f32_data()
    e = _cases(daft_tpu)[name].alias("out")
    with ref_ctx(device_mode="off"):
        want = _round_f32(daft_tpu.from_pydict(data).select(e).to_pydict()["out"])
    batch = daft_tpu_torch.MicroPartition.from_pydict(data).batches[0]
    pe = _cases(daft_tpu_torch)[name]
    cols = {n: (torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(m))
            for n, (v, m) in _planes(batch).items()}
    v, m = port_de.build_device_expr(pe, batch.schema, float_dtype=torch.float32)(
        cols, torch.device("cpu"))
    assert not v.dtype.is_floating_point or v.dtype == torch.float32, (name, v.dtype)
    _same_f32(_pylist(v.numpy(), np.broadcast_to(m.numpy(), (F32_ROWS,))), want, name)


@pytest.mark.parametrize("decimals", [0, 1], ids=["f32_stage", "round_f64_stage"])
def test_functions_query_through_the_stage_equals_the_host(decimals):
    """A grouped query of round, floordiv, pow, log, clip and fill_nan with
    no float min or max, on the CPU. Rounding to whole numbers leaves the
    grouped stage's program in f32; rounding to a decimal keeps it in f64
    (``needs_f64``: a decimal tie such as 3.45 falls on either side once
    rounded to f32). Equal to the host path: keys and integers exactly,
    floats within rtol 1e-5."""
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.ops.grouped_stage import GroupedAggStage

    rng = np.random.default_rng(7)
    n = 1 << 12
    x = np.round(rng.uniform(0.5, 20, n), 2)
    x[::97] = np.nan
    data = {"k": rng.integers(0, 9, n), "x": x, "y": rng.integers(-40, 40, n)}
    col = daft_tpu_torch.col
    df = daft_tpu_torch.from_pydict(data)
    aggs = [col("x").float.fill_nan(1.0).log().sum().alias("l"),
            (col("y") // 4).max().alias("m"), (col("x") ** 2).sum().alias("p"),
            col("x").clip(2.0, 9.0).mean().alias("c"),
            col("x").float.fill_nan(0.5).round(decimals).mean().alias("fr")]
    stage = GroupedAggStage(df.schema, None, [col("k")],
                            [(a.name(), a.child) for a in aggs])
    assert stage._use_f64 == (decimals != 0)

    def q():
        return (df.where(col("k").is_in([1, 2, 5, 7]) & ((col("y") % 3) != 0))
                .groupby("k").agg(*aggs).sort("k"))

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        got = q().to_pydict()
    assert counters.device_grouped_batches == 1 and counters.device_fallbacks == 0
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        want = q().to_pydict()
    for c in want:
        _same(got[c], want[c], c)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_f32_stage_end_to_end_equals_the_host(grouped):
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.ops.grouped_stage import try_build_grouped_agg_stage
    from daft_tpu_torch.ops.stage import try_build_filter_agg_stage
    from daft_tpu_torch.plan import physical as pp

    df = daft_tpu_torch.from_pydict(f32_stage_case.data(1 << 12))
    q = f32_stage_case.query(daft_tpu_torch, df, grouped)
    node_type = pp.DeviceGroupedAgg if grouped else pp.DeviceFilterAgg
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        plan = pp.translate(q.optimized_plan())
        node = next(nd for nd in plan.walk() if isinstance(nd, node_type))
        # the optimizer pushes the Filter down; the chain is one region all the same
        assert node.region_ops[-1] == "agg" and "filter" in node.region_ops
        assert node.region_ops.count("project") >= 3
        stage = (try_build_grouped_agg_stage(node.input.schema, node.predicate, node.groupby,
                                             node.aggregations) if grouped else
                 try_build_filter_agg_stage(node.input.schema, node.predicate,
                                            node.aggregations))
        assert not stage._use_f64
        counters.reset()
        got = q.to_pydict()
    assert counters.device_fallbacks == 0 and counters.device_region_dispatches == 1
    assert (counters.device_grouped_batches if grouped else counters.device_stage_batches) == 1
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        want = q.to_pydict()
    f32_stage_case.check(got, want)


def test_function_options_key_the_stage_cache():
    """Two stages that differ only in a function's options (round's
    decimals, clip's bounds, log's base) are two compiled stages: run one
    after the other on the device path, each equals the host path."""
    rng = np.random.default_rng(9)
    n = 1 << 10
    data = {"k": rng.integers(0, 4, n), "x": np.round(rng.uniform(0.5, 20, n), 2)}
    col = daft_tpu_torch.col
    df = daft_tpu_torch.from_pydict(data)
    x = col("x")
    for e in (x.round(0), x.round(1), x.clip(1.0, 5.0), x.clip(2.0, 9.0), x.log(2.0),
              x.log(10.0)):
        def q():
            return df.groupby("k").agg(e.sum().alias("s")).sort("k")
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
            got = q().to_pydict()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
            want = q().to_pydict()
        _same(got["s"], want["s"], repr(e))


def test_is_in_null_item_matches_null_rows_on_both_paths():
    """A null among the items makes a null row true (Arrow's is_in with
    nulls matching, the port's semantics; the reference's host refuses to
    concatenate a null literal with its integer items)."""
    e = daft_tpu_torch.col("j").is_in([3, None]).alias("out")
    want = [v == 3 or v is None for v in DATA["j"]]
    assert _port_host_expr(e) == want
    assert _port_device_expr(e) == want


def _port_host_expr(e):
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        return daft_tpu_torch.from_pydict(DATA).select(e).to_pydict()["out"]


def _port_device_expr(e):
    batch = daft_tpu_torch.MicroPartition.from_pydict(DATA).batches[0]
    cols = {n: (torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(m))
            for n, (v, m) in _planes(batch).items()}
    v, m = port_de.build_device_expr(e, batch.schema)(cols, torch.device("cpu"))
    return _pylist(v.numpy(), np.broadcast_to(m.numpy(), (N,)))


def _schema_cases(m):
    col, lit = m.col, m.lit
    return [
        col("i") // col("j"), col("f") % 2.0, col("f") ** col("g"), col("b") ^ col("c"),
        col("i").fill_null(0), col("f").eq_null_safe(col("g")), col("i").abs(),
        col("s").is_in([1, 2]), col("f").sqrt() + col("f").exp(), col("f").round(2),
        col("f").clip(0.0, 1.0), col("f").float.is_nan(), col("f").float.fill_nan(0.0),
        col("f").log(10.0), col("i").sign(), col("f").floor(), col("s").cbrt(),
        (col("d") > lit(__import__("datetime").date(2000, 1, 1))) & col("b"),
        # host only in both packages
        col("t").str.upper() == "A", col("t").str.length() > 2, col("d").dt.month() == 3,
        col("f").arccosh(), col("i").hash(), col("f").sum(), col("f").stddev(),
        col("b").bool_and(), col("t").is_in(["a", "b"]),
        # uint64: the reference keeps it on its device, the port on the host
        col("w") + 1, col("w").is_in([1, 2]),
    ]


UINT64 = {len(_schema_cases(daft_tpu_torch)) - 2, len(_schema_cases(daft_tpu_torch)) - 1}


def test_is_device_evaluable_agrees_with_the_reference():
    import datetime

    data = {"i": [1, None], "j": [2, 3], "f": [1.0, None], "g": [0.5, 2.0],
            "b": [True, None], "c": [False, True], "s": np.array([1, 2], dtype=np.int32),
            "t": ["a", "bcd"], "d": [datetime.date(2000, 1, 2), None],
            "w": np.array([1, 2], dtype=np.uint64)}
    ref_schema = daft_tpu.from_pydict(data).schema
    port_schema = daft_tpu_torch.from_pydict(data).schema
    ref_cases, port_cases = _schema_cases(daft_tpu), _schema_cases(daft_tpu_torch)
    for k, (re_, pe) in enumerate(zip(ref_cases, port_cases)):
        want = ref_de.is_device_evaluable(re_, ref_schema)
        got = port_de.is_device_evaluable(pe, port_schema)
        if k in UINT64:
            assert want and not got, repr(pe)
        else:
            assert got == want, repr(pe)
