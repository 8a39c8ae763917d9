"""The expression surface's device ops and functions on the card, against
the port's host path (expressions/eval.py and the registry's host
kernels). Marked ``cuda``: skipped where no card is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_device_ops.py

Each case's device program (ops/device_eval.py ``build_device_expr``) runs
on CUDA tensors of the same columns in f64 (the type of a stage with a
float min or max) and equals the host: integers, booleans and validity bit
for bit, floats within rtol 1e-5 (NaN and infinities in the same places).
In f32 (the grouped stage's program without a float extreme) it equals the
host on the float columns rounded to f32, each float result rounded to
f32, floats within ``F32_ULPS`` units in the last place. The inputs hold nulls, NaN, +-inf, -0.0,
zero divisors and int64 values on both sides of 2^53. Grouped queries of
the functions run through the device stage, in f64 and in f32, and equal
the host path. A whole f32 stage end to end (tests/f32_stage_case.py: f64
columns uploaded as f32, a fused Project / Filter chain of device
functions, grouped and ungrouped) equals the host path: keys, counts and
integer min/max bit for bit, float sums and means within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import daft_tpu_torch
import f32_stage_case
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import device_eval as de

pytestmark = pytest.mark.cuda

RTOL = 1e-5
# units in the last place of f32 the f32 program may be off: its inputs are
# the target's, so only the op's own rounding is left (CUDA's f32 math
# functions are within 4 ulps)
F32_ULPS = 8
BIG = 2 ** 53


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _data():
    rng = np.random.default_rng(20)
    n = 4096
    i = rng.integers(-10 ** 6, 10 ** 6, n).tolist()
    i[:8] = [0, 1, -1, BIG - 1, BIG + 1, -(BIG + 3), None, 7]
    k = rng.integers(-10 ** 6, 10 ** 6, n).tolist()
    k[:8] = [0, 1, -1, BIG - 1, BIG, -BIG, None, 7]
    j = rng.integers(-9, 10, n).tolist()
    j[:4] = [0, 3, None, -2]
    f = np.round(rng.normal(0, 40, n), 3).tolist()
    f[:9] = [1.5, -0.0, 0.0, float("nan"), float("inf"), float("-inf"), None, 0.5, -2.25]
    g = rng.choice([-2.5, -1.0, 0.0, 0.5, 3.0], n).tolist()
    g[:4] = [0.0, -0.0, float("nan"), None]
    b = [None if r % 11 == 0 else bool(v) for r, v in enumerate(rng.integers(0, 2, n))]
    c = [None if r % 7 == 0 else bool(v) for r, v in enumerate(rng.integers(0, 2, n))]
    return {"i": i, "k": k, "j": j, "f": f, "g": g, "b": b, "c": c,
            "s": rng.integers(-20, 21, n).astype(np.int32),
            "u": np.round(rng.uniform(0.0, 1.0, n), 3)}


DATA = _data()


def _cases():
    col = daft_tpu_torch.col
    i, j, k, f, g, s, u = (col(n) for n in "ijkfgsu")
    b, c = col("b"), col("c")
    out = {
        "floordiv_int": k // j, "floordiv_float": f // g, "floordiv_lit": s // 3,
        "mod_int": i % j, "mod_float": f % g, "mod_neg": i % -3, "pow_float": f ** 2,
        "pow_frac": s ** 0.5, "xor": b ^ c, "fill_null_int": i.fill_null(5),
        "fill_null_float": f.fill_null(1.5), "eq_null_safe_int": i.eq_null_safe(j),
        "eq_null_safe_float": f.eq_null_safe(g), "eq_null_safe_bool": b.eq_null_safe(c),
        "abs_int": i.abs(), "abs_float": f.abs(), "is_in_i32": s.is_in([1, 3, 5, -7]),
        "is_in_big": i.is_in([0, BIG + 1, 7]), "is_in_float": f.is_in([1.5, 0.0, -2.25]),
        "is_in_nan": f.is_in([float("nan"), 3.0]), "is_in_null": j.is_in([3, None]),
        "log_base": f.log(2.0), "round0": f.round(), "round1": f.round(1),
        "round_i": s.round(-1), "clip_float": f.clip(-1.0, 2.0), "clip_int": s.clip(-5, 5),
        "is_nan": f.float.is_nan(), "is_inf": f.float.is_inf(), "not_nan": f.float.not_nan(),
        "fill_nan": f.float.fill_nan(9.5), "arcsin": u.arcsin(), "arccos": u.arccos(),
    }
    for name in ("exp", "sqrt", "sin", "cos", "tan", "arctan", "log2", "log10", "cbrt",
                 "expm1", "log1p", "sinh", "cosh", "tanh", "degrees", "radians", "floor",
                 "ceil", "sign", "log"):
        out[name] = f._fn(name)
    return out


CASES = _cases()


def _f32_data():
    """DATA with its float columns rounded to f32 (still f64 columns)."""
    out = dict(DATA)
    for n in ("f", "g"):
        out[n] = [None if v is None else float(np.float32(v)) for v in DATA[n]]
    out["u"] = DATA["u"].astype(np.float32).astype(np.float64)
    return out


F32_DATA = _f32_data()


def _host(e, data=DATA):
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        return daft_tpu_torch.from_pydict(data).select(e.alias("out")).to_pydict()["out"]


def _device(e, device, fdt, data=DATA):
    batch = daft_tpu_torch.MicroPartition.from_pydict(data).batches[0]
    assert de.is_device_evaluable(e, batch.schema)
    cols = {}
    for s in batch.columns():
        v = torch.from_numpy(np.ascontiguousarray(s.to_numpy())).to(device)
        cols[s.name] = (v, torch.from_numpy(s.validity_numpy()).to(device))
    v, m = de.build_device_expr(e, batch.schema, float_dtype=fdt)(cols, device)
    n = batch.num_rows
    vals = np.broadcast_to(v.cpu().numpy(), (n,))
    valid = np.broadcast_to(m.cpu().numpy(), (n,))
    return [x if ok else None for x, ok in zip(vals.tolist(), valid.tolist())]


def _same(got, want, name, ulps=None):
    """Validity, NaN and infinities in the same places; integers and
    booleans equal; floats within rtol 1e-5, or within ``ulps`` units in
    the last place of f32 (a subnormal's unit included)."""
    assert [x is None for x in got] == [x is None for x in want], name
    gv = [x for x in got if x is not None]
    wv = [x for x in want if x is not None]
    if any(isinstance(x, float) for x in wv):
        gg, ww = np.array(gv, dtype=np.float64), np.array(wv, dtype=np.float64)
        assert np.array_equal(np.isnan(gg), np.isnan(ww)), name
        assert np.array_equal(np.isposinf(gg), np.isposinf(ww)), name
        assert np.array_equal(np.isneginf(gg), np.isneginf(ww)), name
        ok = np.isfinite(ww)
        if ulps is None:
            np.testing.assert_allclose(gg[ok], ww[ok], rtol=RTOL, atol=0.0, err_msg=name)
        else:
            ulp = np.spacing(np.abs(ww[ok]).astype(np.float32)).astype(np.float64)
            off = np.abs(gg[ok] - ww[ok]) > ulps * ulp
            assert not off.any(), (name, gg[ok][off][:5], ww[ok][off][:5])
    else:
        assert gv == wv, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_op_on_the_card_equals_the_host(cuda, name):
    e = CASES[name]
    _same(_device(e, cuda, torch.float64), _host(e), name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_op_on_the_card_in_f32_equals_the_host_on_f32_inputs(cuda, name):
    e = CASES[name]
    with np.errstate(over="ignore"):  # past f32's range rounds to inf, as the program gives
        want = [float(np.float32(v)) if isinstance(v, float) else v
                for v in _host(e, F32_DATA)]
    _same(_device(e, cuda, torch.float32, F32_DATA), want, name, F32_ULPS)


@pytest.mark.parametrize("extreme", [True, False], ids=["f64_stage", "f32_stage"])
def test_functions_query_through_the_card_stage_equals_the_host(cuda, extreme):
    """The grouped stage runs in f64 where a float min stands among the
    aggregates (``extreme``), else in f32."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    x = np.round(rng.uniform(0.5, 20, n), 2)
    x[::97] = np.nan
    data = {"k": rng.integers(0, 9, n), "x": x, "y": rng.integers(-40, 40, n)}
    col = daft_tpu_torch.col
    df = daft_tpu_torch.from_pydict(data)
    aggs = [col("x").float.fill_nan(1.0).log10().sum().alias("l"),
            (col("y") // 4).max().alias("m"), col("x").round(1).sum().alias("r"),
            (col("x") ** 2).sum().alias("p"), col("x").clip(2.0, 9.0).mean().alias("c"),
            col("x").float.fill_nan(0.5).round(1).mean().alias("fr")]
    if extreme:
        aggs.append((col("x") - 10).abs().min().alias("a"))

    def q():
        return (df.where(col("k").is_in([1, 2, 5, 7]) & ((col("y") % 3) != 0))
                .groupby("k").agg(*aggs).sort("k"))

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cuda", device_mode="on"):
        got = q().to_pydict()
    assert counters.device_grouped_batches == 1 and counters.device_fallbacks == 0
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        want = q().to_pydict()
    for c in want:
        _same(got[c], want[c], c)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_f32_stage_end_to_end_on_the_card_equals_the_host(cuda, grouped):
    """tests/test_torch_device_ops.py's f32 stage at 2^18 rows on the card:
    one dispatch, no fallback, equal to the host path over the f64 columns."""
    df = daft_tpu_torch.from_pydict(f32_stage_case.data(1 << 18))
    q = f32_stage_case.query(daft_tpu_torch, df, grouped)
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cuda", device_mode="on"):
        got = q.to_pydict()
    assert counters.device_fallbacks == 0 and counters.device_region_dispatches == 1
    assert (counters.device_grouped_batches if grouped else counters.device_stage_batches) == 1
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        want = q.to_pydict()
    f32_stage_case.check(got, want)
