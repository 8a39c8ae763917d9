"""The end-to-end f32 stage case shared by tests/test_torch_device_ops.py
(on the CPU) and tests/test_torch_cuda_device_ops.py (on the card): its
columns, its query, and how its result is held against the host path's.
Imports no JAX (the card's machine has none)."""

import numpy as np

RTOL = 1e-5  # F3's device-vs-host tolerance


def data(n: int, seed: int = 11) -> dict:
    """Float columns at two decimals (no f32 rounding moves one across the
    filter's 2.005 or a tie of ``round``), a NaN in x every 89 rows, nulls
    in x and z, positive values so no sum cancels."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(1.0, 20.0, n), 2)
    x[::89] = np.nan
    z = np.round(rng.uniform(0.25, 40.0, n), 2)
    xv, zv = rng.random(n) < 0.93, rng.random(n) < 0.95
    return {"k": rng.integers(0, 13, n).tolist(),
            "x": [float(v) if ok else None for v, ok in zip(x, xv)],
            "y": rng.integers(-500, 500, n).tolist(),
            "z": [float(v) if ok else None for v, ok in zip(z, zv)]}


def query(m, df, grouped: bool):
    """A Project / Filter chain of device functions under an aggregate with
    no float min or max: the stage's program stays f32."""
    col = m.col
    chain = (df.with_column("lx", col("x").float.fill_nan(1.0).log10())
             .where((col("x") > 2.005) & ((col("y") % 3) != 0))
             .with_column("sq", col("z").sqrt() + col("lx"))
             .with_column("r", (col("x") * 1.5).round(0) + (col("z") - 20.0).abs().floor()))
    aggs = [col("lx").sum().alias("lx_sum"), col("sq").mean().alias("sq_mean"),
            col("r").sum().alias("r_sum"), col("z").clip(1.0, 30.0).mean().alias("c_mean"),
            col("x").count().alias("n"), (col("y") // 4).min().alias("y_min"),
            (col("y") % 7).max().alias("y_max")]
    return chain.groupby("k").agg(*aggs).sort("k") if grouped else chain.agg(*aggs)


EXACT = ("k", "n", "y_min", "y_max")


def check(got: dict, want: dict) -> None:
    for c in want:
        if c in EXACT:
            assert got[c] == want[c], c
        else:
            _close(got[c], want[c], c)


def _close(got, want, name):
    """Nulls in the same places; floats within RTOL (NaN and infinities in
    the same places)."""
    assert [x is None for x in got] == [x is None for x in want], name
    g = np.array([x for x in got if x is not None], dtype=np.float64)
    w = np.array([x for x in want if x is not None], dtype=np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w)), name
    assert np.array_equal(np.isinf(g) & (g > 0), np.isinf(w) & (w > 0)), name
    assert np.array_equal(np.isinf(g) & (g < 0), np.isinf(w) & (w < 0)), name
    ok = np.isfinite(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=0.0, err_msg=name)
