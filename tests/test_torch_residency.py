"""The port's device residency manager (daft_tpu_torch/device/residency.py):
reuse, least-recently-used eviction past the budget, pinning inside a query
scope, and release when the anchor dies. Tensors on the ``meta`` device
stand in for card memory: they count toward the budget without allocating.
"""

import gc

import torch

from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.device.residency import ResidencyManager, device_nbytes


class _Anchor:
    pass


def _plane(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes // 4, dtype=torch.float32, device="meta")


def test_device_nbytes_counts_only_device_tensors():
    value = {"a": (_plane(4096), torch.zeros(100)), "b": [_plane(1024)]}
    assert device_nbytes(value) == 4096 + 1024


def test_get_or_build_reuses_and_evicts_least_recently_used():
    m = ResidencyManager()
    anchors = [_Anchor() for _ in range(3)]
    builds = []

    def build(i):
        builds.append(i)
        return _plane(1000)

    with execution_config_ctx(hbm_budget_bytes=2500):
        a = m.get_or_build(anchors[0], ("col",), lambda: build(0))
        assert m.get_or_build(anchors[0], ("col",), lambda: build(9)) is a
        m.get_or_build(anchors[1], ("col",), lambda: build(1))
        m.get_or_build(anchors[0], ("col",), lambda: build(9))  # 0 is now newest
        m.get_or_build(anchors[2], ("col",), lambda: build(2))  # evicts 1
        assert builds == [0, 1, 2]
        assert m.stats() == {"bytes_resident": 2000, "entries": 2}
        m.get_or_build(anchors[1], ("col",), lambda: build(1))
        assert builds == [0, 1, 2, 1]


def test_pinned_entries_survive_until_the_scope_ends():
    m = ResidencyManager()
    anchors = [_Anchor() for _ in range(3)]
    with execution_config_ctx(hbm_budget_bytes=1500):
        with m.pin_scope():
            for a in anchors:
                m.get_or_build(a, ("col",), lambda: _plane(1000))
            # all pinned by the running query: over budget, nothing evicted
            assert m.entry_count() == 3
        assert m.bytes_resident() <= 1500 and m.entry_count() == 1


def test_entries_die_with_their_anchor():
    m = ResidencyManager()
    with execution_config_ctx(hbm_budget_bytes=-1):
        a = _Anchor()
        m.get_or_build(a, ("col",), lambda: _plane(4000))
        assert m.bytes_resident() == 4000
        del a
        gc.collect()
        assert m.bytes_resident() == 0 and m.entry_count() == 0


def test_deps_and_literals_rebuild_one_slot_in_place():
    """A hit needs identical deps and equal literals; a miss rebuilds the
    same slot, so a query shape keeps one entry whatever its literals."""
    from daft_tpu_torch import col, lit
    from daft_tpu_torch.device.residency import expr_structure

    m = ResidencyManager()
    anchor, dep_a, dep_b = _Anchor(), _Anchor(), _Anchor()
    builds = []

    def build(tag):
        builds.append(tag)
        return _plane(1000)

    with execution_config_ctx(hbm_budget_bytes=-1):
        first = m.get_or_build(anchor, ("vis",), lambda: build("a"), (dep_a,), (1,))
        assert m.get_or_build(anchor, ("vis",), lambda: build("x"), (dep_a,), (1,)) is first
        m.get_or_build(anchor, ("vis",), lambda: build("b"), (dep_b,), (1,))
        m.get_or_build(anchor, ("vis",), lambda: build("c"), (dep_b,), (2,))
        assert builds == ["a", "b", "c"]
        assert m.stats() == {"bytes_resident": 1000, "entries": 1}
        m.clear()
        assert m.stats() == {"bytes_resident": 0, "entries": 0}
    skel_1, lits_1 = expr_structure((col("x") < lit(3)) & col("y").is_in([1, 2]))
    skel_2, lits_2 = expr_structure((col("x") < lit(5)) & col("y").is_in([1, 4]))
    assert skel_1 == skel_2 and lits_1 != lits_2
    assert [v for _dt, v in lits_2] == [5, 1, 4]
