"""Approximate sketches (counterpart of daft_tpu/core/kernels/sketches.py):
HyperLogLog at p = 14 for ``approx_count_distinct`` and a DDSketch of
relative accuracy alpha for ``approx_percentile``.

HLL hashes each valid row with ``Series.hash`` (equal to the reference's),
takes the register from the hash's top 14 bits and the rank from the
leading zeros of the rest (its low 14 bits set, so the rank is at most 51).
The port counts the leading zeros from each 32-bit half's exponent
(``np.frexp``, exact below 2^53) where the reference shifts bit by bit; the
registers are the same. The estimate and the DDSketch are the reference's
arithmetic in the same order.
"""

from __future__ import annotations

import numpy as np

HLL_P = 14
HLL_M = 1 << HLL_P


def _leading_zeros(x: np.ndarray) -> np.ndarray:
    """Leading zero bits of nonzero uint64 values."""
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
    _m, ehi = np.frexp(hi)
    _m, elo = np.frexp(lo)
    return np.where(hi > 0, 32 - ehi, 64 - elo).astype(np.uint8)


def hll_registers(series) -> np.ndarray:
    """The HLL register array (uint8[HLL_M]) of a Series (sketches.py:15-40)."""
    h = series.hash().to_numpy().astype(np.uint64)
    h = h[series.validity_numpy()]
    regs = np.zeros(HLL_M, dtype=np.uint8)
    if len(h) == 0:
        return regs
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int64)
    rest = (h << np.uint64(HLL_P)) | np.uint64((1 << HLL_P) - 1)
    np.maximum.at(regs, idx, _leading_zeros(rest) + 1)
    return regs


def hll_estimate(regs: np.ndarray) -> int:
    """The register array's cardinality estimate, small-range corrected
    (sketches.py:47-55)."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = np.power(2.0, -regs.astype(np.float64))
    e = alpha * m * m / inv.sum()
    zeros = int((regs == 0).sum())
    if e <= 2.5 * m and zeros:
        e = m * np.log(m / zeros)
    return int(round(e))


def hll_count_distinct(series) -> int:
    return hll_estimate(hll_registers(series))


DD_DEFAULT_ALPHA = 0.01


class DDSketch:
    """Quantiles within relative error alpha (sketches.py:67-132): values
    bucket by ceil(log(|v|) / log(gamma)), gamma = (1 + a) / (1 - a);
    mergeable bucket by bucket."""

    def __init__(self, alpha: float = DD_DEFAULT_ALPHA):
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = np.log(self.gamma)
        self.pos: dict = {}
        self.neg: dict = {}
        self.zeros = 0
        self.count = 0

    def add_array(self, vals: np.ndarray) -> None:
        vals = vals[~np.isnan(vals)]
        if len(vals) == 0:
            return
        self.count += len(vals)
        self.zeros += int((vals == 0).sum())
        for store, sel in ((self.pos, vals > 0), (self.neg, vals < 0)):
            v = np.abs(vals[sel])
            if len(v) == 0:
                continue
            keys = np.ceil(np.log(v) / self._lg).astype(np.int64)
            uniq, cnt = np.unique(keys, return_counts=True)
            for k, c in zip(uniq.tolist(), cnt.tolist()):
                store[k] = store.get(k, 0) + int(c)

    def merge(self, other: "DDSketch") -> None:
        for mine, theirs in ((self.pos, other.pos), (self.neg, other.neg)):
            for k, c in theirs.items():
                mine[k] = mine.get(k, 0) + c
        self.zeros += other.zeros
        self.count += other.count

    def _bucket_value(self, key: int, negative: bool) -> float:
        v = 2.0 * (self.gamma ** key) / (self.gamma + 1.0)
        return -v if negative else v

    def quantile(self, q: float):
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        acc = 0
        for k in sorted(self.neg.keys(), reverse=True):
            acc += self.neg[k]
            if acc > rank:
                return self._bucket_value(k, negative=True)
        acc += self.zeros
        if acc > rank:
            return 0.0
        for k in sorted(self.pos.keys()):
            acc += self.pos[k]
            if acc > rank:
                return self._bucket_value(k, negative=False)
        if self.pos:
            return self._bucket_value(max(self.pos), negative=False)
        if self.zeros:
            return 0.0
        return self._bucket_value(min(self.neg), negative=True) if self.neg else None


def ddsketch_percentiles(values: np.ndarray, percentiles, alpha: float = DD_DEFAULT_ALPHA):
    """Approximate percentiles of float64 ``values`` (the valid rows; None
    each for none) (sketches.py:135-141)."""
    sk = DDSketch(alpha)
    sk.add_array(np.asarray(values, dtype=np.float64))
    return [sk.quantile(float(p)) for p in percentiles]
