"""The build-once host join (daft_tpu_torch/execution/executor.py
``JoinProbe`` over core/kernels/join.py ``ProbeTable``) held against the
reference's ``daft_tpu.core.relational.JoinProbe`` and the port's per-batch
join it replaces (``join_indices`` over each left batch and the whole right
side). The same seeded columns go to both packages; the right side is
indexed once and the left side probed in several batches. Inner, left,
semi and anti joins; int (a dense and a sparse value range, and an int32
left key against an int64 right one), float, string, date and two-column
keys; nulls and duplicates on both sides. The fused filter
(``probe_filtered``) equals the probe of the filtered batch.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.core import relational as rel
from daft_tpu.plan import physical as ref_pp
from daft_tpu_torch.core.kernels.join import ProbeTable, join_indices
from daft_tpu_torch.core.recordbatch import RecordBatch
from daft_tpu_torch.execution import executor as ex
from daft_tpu_torch.execution.executor import JoinProbe
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.plan import physical as pp

SEED = 20261018
N_LEFT, N_RIGHT = 6000, 900
HOWS = ("inner", "left", "semi", "anti")


def _mask(rng, n, share):
    return rng.random(n) >= share


def _int_keys(rng, n, hi):
    return rng.integers(0, hi, n)


def _columns(kind, rng, n):
    """{name: (values, validity, DataType kind)} of one side's key columns
    (about 8 % nulls) for the key ``kind``."""
    if kind == "int":
        return {"k": (_int_keys(rng, n, 400), _mask(rng, n, 0.08), "int64")}
    if kind == "sparse":
        vocab = np.random.default_rng(SEED).integers(-(1 << 50), 1 << 50, 300)  # both sides
        return {"k": (vocab[rng.integers(0, 300, n)], _mask(rng, n, 0.08), "int64")}
    if kind == "float":
        vocab = np.array([0.0, -0.0, 1.5, -2.25, 1e300, 3.0, 7.125, -1e-300])
        return {"k": (vocab[rng.integers(0, len(vocab), n)], _mask(rng, n, 0.08), "float64")}
    if kind == "string":
        vocab = np.array([f"s{i:03d}" for i in range(250)] + [""], dtype=object)
        vals = vocab[rng.integers(0, len(vocab), n)]
        valid = _mask(rng, n, 0.08)
        vals = np.where(valid, vals, None)
        return {"k": (vals, valid, "string")}
    if kind == "date":
        days = rng.integers(9000, 9400, n).astype(np.int32)
        return {"k": (days, _mask(rng, n, 0.08), "date")}
    assert kind == "pair"
    vocab = np.array(["a", "b", "c", "d"], dtype=object)
    sv = _mask(rng, n, 0.05)
    return {"k": (_int_keys(rng, n, 60), _mask(rng, n, 0.05), "int64"),
            "k2": (np.where(sv, vocab[rng.integers(0, 4, n)], None), sv, "string")}


def _tables(kind, left_int32=False):
    """(reference left, reference right, port left, port right) frames."""
    rng = np.random.default_rng(SEED + sum(map(ord, kind)))
    out = []
    for side, n in (("l", N_LEFT), ("r", N_RIGHT)):
        cols = _columns(kind, rng, n)
        if side == "l":
            cols["v"] = (np.arange(n, dtype=np.int64), np.ones(n, dtype=bool), "int64")
            if left_int32:
                vals, valid, _ = cols["k"]
                cols["k"] = (vals.astype(np.int32), valid, "int32")
        else:
            cols = {f"r{c}": x for c, x in cols.items()}
            cols["w"] = (rng.standard_normal(n), _mask(rng, n, 0.1), "float64")
        schema = {c: daft_tpu_torch.DataType(t) for c, (_v, _m, t) in cols.items()}
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
            port = from_numpy_columns({c: (v, m) for c, (v, m, _t) in cols.items()},
                                      schema).collect()
            data = port.to_pydict()
        ref = daft_tpu.from_pydict(data).with_columns(
            {c: daft_tpu.col(c).cast(daft_tpu.DataType(t)) for c, (_v, _m, t) in cols.items()})
        out.append((ref.collect(), port))
    (ref_l, port_l), (ref_r, port_r) = out
    return ref_l, ref_r, port_l, port_r


def _on(kind):
    return (["k", "k2"], ["rk", "rk2"]) if kind == "pair" else (["k"], ["rk"])


def _port_node(left, right, how, kind):
    lo, ro = _on(kind)
    df = left.join(right, left_on=lo, right_on=ro, how=how)
    plan = pp.translate(df.optimized_plan())
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, pp.HashJoin):
            return n
        stack.extend(n.children())
    raise AssertionError("no HashJoin in the plan")


def _ref_node(left, right, how, kind):
    lo, ro = _on(kind)
    df = left.join(right, left_on=lo, right_on=ro, how=how)
    plan = ref_pp.translate(df._builder.optimize().plan)
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, ref_pp.HashJoin):
            return n
        stack.extend(n.children())
    raise AssertionError("no HashJoin in the reference's plan")


def _port_batch(plan):
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        parts = list(ex.execute_plan(plan))
    return ex._concat_parts(parts, plan.schema)


def _ref_batch(plan):
    from daft_tpu.config import execution_config_ctx as ref_ctx
    from daft_tpu.execution.executor import _concat_parts, execute_plan

    with ref_ctx(device_mode="off"):
        parts = list(execute_plan(plan))
    return _concat_parts(parts, plan.schema)


def _old_join(node, left: RecordBatch, right: RecordBatch) -> RecordBatch:
    """The port's per-batch host join before the probe table: both sides'
    keys coded together for every left batch."""
    li, ri = join_indices(ex._keys(left, node.left_on), ex._keys(right, node.right_on),
                          node.how)
    cols = [s.take(li) for s in left.columns()]
    if node.how not in ("semi", "anti"):
        cols += [s.take_or_null(ri).rename(node.right_rename.get(s.name, s.name))
                 for s in right.columns() if s.name not in node.merged_keys]
    return RecordBatch(node.schema, cols, len(li))


CUTS = (0, 1, 777, 2500, 2501, N_LEFT)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("kind", ["int", "sparse", "float", "string", "date", "pair",
                                  "int32_left"])
def test_probe_equals_reference_and_old_join(kind, how):
    key_kind = "int" if kind == "int32_left" else kind
    ref_l, ref_r, port_l, port_r = _tables(key_kind, left_int32=kind == "int32_left")
    node = _port_node(port_l, port_r, how, key_kind)
    ref_node = _ref_node(ref_l, ref_r, how, key_kind)
    left, right = _port_batch(node.left), _port_batch(node.right)
    rleft, rright = _ref_batch(ref_node.left), _ref_batch(ref_node.right)
    probe = JoinProbe(node, right)
    ref_probe = rel.JoinProbe(rright, ref_node.left_on, ref_node.right_on, how,
                              ref_node.schema, ref_node.merged_keys, ref_node.right_rename,
                              ref_node.null_equals_null, ref_node.left.schema)
    for lo, hi in zip(CUTS, CUTS[1:]):
        got = probe.probe(left.slice(lo, hi))
        assert got.to_pydict() == ref_probe.probe(rleft.slice(lo, hi)).to_pydict()
        assert got.to_pydict() == _old_join(node, left.slice(lo, hi), right).to_pydict()
    assert probe.probe(left).num_rows > 0 or how == "anti"


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("kind", ["int", "string", "pair"])
def test_probe_filtered_equals_probe_of_the_filtered_batch(kind, how):
    _ref_l, _ref_r, port_l, port_r = _tables(kind)
    node = _port_node(port_l, port_r, how, kind)
    left, right = _port_batch(node.left), _port_batch(node.right)
    probe = JoinProbe(node, right)
    rng = np.random.default_rng(SEED + 7)
    for keep in (rng.random(left.num_rows) < 0.4, np.zeros(left.num_rows, dtype=bool),
                 np.ones(left.num_rows, dtype=bool)):
        sel = np.flatnonzero(keep)
        want = probe.probe(left.take(sel)).to_pydict()
        assert probe.probe_filtered(left, sel).to_pydict() == want


def test_string_probe_through_dictionary_codes():
    """A left string column whose dictionary codes are known (as a Parquet
    read gives them) looks each distinct value up once; the rows are the
    per-row lookup's."""
    _ref_l, _ref_r, port_l, port_r = _tables("string")
    node = _port_node(port_l, port_r, "inner", "string")
    left, right = _port_batch(node.left), _port_batch(node.right)
    plain = JoinProbe(node, right).probe(left).to_pydict()
    left.get_column("k").dict_codes()
    coded = left.slice(0, left.num_rows)
    assert coded.get_column("k")._raw_codes() is not None
    assert JoinProbe(node, right).probe(coded).to_pydict() == plain


def test_probe_table_edges():
    """An empty right side, an all-null right key, a right side with unique
    keys (one gather a row) and a left key outside a dense range."""
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.datatype import DataType

    i64 = DataType.int64()
    left = [Series.from_pylist([5, None, 7, 9000, -3], "k", dtype=i64)]
    empty = ProbeTable([Series.from_pylist([], "r", dtype=i64)], [i64])
    for how in HOWS:
        li, ri = empty.probe(left, how)
        want_l, want_r = join_indices(left, [Series.from_pylist([], "r", dtype=i64)], how)
        assert li.tolist() == want_l.tolist() and ri.tolist() == want_r.tolist()
    for right in ([None, None, None], [7, 5, 1], [7, 7, 5, None, 9000]):
        rs = [Series.from_pylist(right, "r", dtype=i64)]
        table = ProbeTable(rs, [i64])
        for how in HOWS:
            li, ri = table.probe(left, how)
            want_l, want_r = join_indices(left, rs, how)
            assert li.tolist() == want_l.tolist(), (right, how)
            assert ri.tolist() == want_r.tolist(), (right, how)


def test_host_join_query_equals_reference_in_every_pipeline_mode():
    """A join under a filter (fused into the probe) and a left join, each
    in every pipeline mode, equal to the reference."""
    from daft_tpu.config import execution_config_ctx as ref_ctx

    ref_l, ref_r, port_l, port_r = _tables("pair")

    def q(dt, left, right):
        c = dt.col
        inner = (left.where((c("v") > 1000) & (c("v") < 5000))
                 .join(right, left_on=["k", "k2"], right_on=["rk", "rk2"])
                 .select(c("v"), c("k2"), c("w")).sort("v"))
        outer = (left.join(right, left_on=["k", "k2"], right_on=["rk", "rk2"], how="left")
                 .where(c("v") < 3000).sort("v"))
        return inner.to_pydict(), outer.to_pydict()

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, ref_l, ref_r)
    for mode in ("off", "on", "force"):
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off",
                                                 pipeline_mode=mode, morsel_size_rows=1024):
            assert q(daft_tpu_torch, port_l, port_r) == want, mode


def test_selection_vector_follows_filter_semantics():
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.datatype import DataType

    batch = RecordBatch.from_pydict({"a": np.arange(5)})
    mask = Series.from_pylist([True, None, False, True, True], "m", dtype=DataType.bool())
    assert ex._selection_vector(batch, mask).tolist() == [0, 3, 4]
    one = Series.from_pylist([True], "m", dtype=DataType.bool())
    assert ex._selection_vector(batch, one).tolist() == [0, 1, 2, 3, 4]
    null = Series.from_pylist([None], "m", dtype=DataType.bool())
    assert ex._selection_vector(batch, null).tolist() == []


def test_concurrent_probes_equal_sequential():
    """One table probed from 16 threads at once, with a short switch
    interval (the pipeline probes morsels on the pool): every probe equals
    the sequential one. The table and the right side's lazily coded string
    columns are shared."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _ref_l, _ref_r, port_l, port_r = _tables("pair")
    node = _port_node(port_l, port_r, "left", "pair")
    left, right = _port_batch(node.left), _port_batch(node.right)
    probe = JoinProbe(node, right)
    pieces = [left.slice(lo, lo + 250) for lo in range(0, left.num_rows, 250)]
    want = [probe.probe(p).to_pydict() for p in pieces]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            for _ in range(3):
                fresh = JoinProbe(node, right)
                got = list(pool.map(lambda p: fresh.probe(p).to_pydict(), pieces * 2,
                                    timeout=60))
                assert got == want * 2
    finally:
        sys.setswitchinterval(prev)
