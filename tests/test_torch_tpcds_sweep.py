"""The 25 TPC-DS queries of benchmarking/tpcds/queries.py through the port,
against the reference's host path.

``ALL_QUERIES`` runs unchanged, its imports of ``daft_tpu`` read as imports
of ``daft_tpu_torch`` (``chip_smoke.tpcds_port_queries``, as the card run
reads them), over the reference's SF 0.01 tables
(``benchmarking/tpcds/datagen.generate(0.01, 0)``) carried across column for
column with ``from_numpy_columns``. Each query runs through the port with
device_mode "on" (device="cpu": the kernels' plain versions) and "off", and
both equal the reference's host result: rows in order, floats within rtol
1e-5, everything else exactly.

The queries riding the device join are computed from both packages'
counters (the reference's with its device_mode="on"); the port's set holds
the reference's, and a query only the port rides would be listed in
``PORT_ONLY`` with its reason (none: the sets are equal).

``chip_smoke.tpcds_tables`` (the card's generator, numpy alone) gives the
reference's tables column for column at SF 0.01.
"""

import os
import sys

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the card's generator and query reader)

RTOL = 1e-5
# queries the port rides on the device join and the reference does not,
# with the reason: none
PORT_ONLY = {}


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


@pytest.fixture(scope="module")
def tpcds():
    from benchmarking.tpcds.datagen import generate
    from benchmarking.tpcds.queries import ALL_QUERIES

    arrow = generate(0.01, 0)
    ref = {k: daft_tpu.from_arrow(v).collect() for k, v in arrow.items()}
    return arrow, ref, {k: _carry(v) for k, v in ref.items()}, ALL_QUERIES, \
        chip_smoke.tpcds_port_queries()


def _same(got, want):
    assert list(got) == list(want)
    for c in got:
        g, w = got[c], want[c]
        assert len(g) == len(w), c
        if any(isinstance(v, float) for v in w):
            assert [v is None for v in g] == [v is None for v in w], c
            np.testing.assert_allclose([np.nan if v is None else v for v in g],
                                       [np.nan if v is None else v for v in w],
                                       rtol=RTOL, atol=0.0, err_msg=c)
        else:
            assert g == w, c


@pytest.fixture(scope="module")
def ref_device_join_set(tpcds):
    from daft_tpu.ops import counters as ref_counters

    _arrow, ref, _port, ref_queries, _pq = tpcds
    rode = set()
    for qn in ref_queries:
        ref_counters.reset()
        with ref_ctx(device_mode="on"):
            ref_queries[qn](ref).to_pydict()
        if ref_counters.device_join_batches:
            rode.add(qn)
    return rode


QUERIES = [3, 6, 7, 12, 19, 20, 27, 33, 36, 42, 43, 48, 51, 52, 55, 56, 59, 63, 65, 73, 79,
           88, 89, 96, 98]


def test_the_query_list_is_the_references(tpcds):
    assert sorted(tpcds[3]) == QUERIES == sorted(tpcds[4])


@pytest.mark.parametrize("qn", QUERIES)
def test_tpcds_query_matches_reference_host(tpcds, ref_device_join_set, qn):
    _arrow, ref, port, ref_queries, port_queries = tpcds
    with ref_ctx(device_mode="off"):
        want = ref_queries[qn](ref).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        _same(port_queries[qn](port).to_pydict(), want)
    manager().clear()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        dev = port_queries[qn](port).to_pydict()
    _same(dev, want)
    snap = counters.snapshot()
    assert all(snap[f"launches_{k}"] == 0 for k in counters.KERNEL_NAMES)
    rides = snap["device_join_batches"] >= 1
    if qn in ref_device_join_set:
        assert rides, f"q{qn}: the reference rides the device join, the port does not"
    else:
        assert not rides or qn in PORT_ONLY, f"q{qn}: rides the device join, the reference " \
                                             "does not"


def test_the_cards_generator_gives_the_references_tables(tpcds):
    arrow = tpcds[0]
    mine = chip_smoke.tpcds_tables(0.01, 0)
    assert list(mine) == list(arrow)
    for t, table in arrow.items():
        assert list(mine[t]) == table.column_names, t
        for c in table.column_names:
            want = table[c].to_numpy(zero_copy_only=False)
            got = mine[t][c]
            assert got.dtype == want.dtype, (t, c)
            assert np.array_equal(got, want), (t, c)
