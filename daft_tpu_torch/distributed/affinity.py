"""Plan residency fingerprints (counterpart of daft_tpu/distributed/
affinity.py).

A fingerprint is the set of content-derived slot keys a plan's device
stages would probe in the residency manager, each with its estimated device
bytes. The distributed planner stamps each sub-plan task with one, and the
scheduler (scheduler.py) steers a task to the worker whose heartbeat digest
(device/residency.py ``digest``) holds the most of those bytes; the serving
tier sums the bytes into a query's pin-scope estimate (serving/prepared.py
``estimate_pin_bytes``). Mirrored slot shapes (the registration sites):

- ``("col", bucket, f32, device)``: ``Series.to_device_cached`` column
  planes fed by the grouped and the ungrouped stages (ops/grouped_stage.py,
  ops/stage.py), a value plane of 4 or 8 bytes a row and a validity plane
  of one;
- ``("dictcodes", bucket, device)``: ``grouped_stage.cached_dict_code_plane``
  group-key code planes, 4 bytes a row;
- ``("udf_params", device)``: a device UDF's weights (ops/udf_stage.py).

A key is a hash of the column's ``content_fingerprint`` (SHA-256 based,
core/series.py) and the slot shape, so equal content gives one key in any
process. Unlike the reference, which keys only slots its residency manager
keys by content, a column of a table the caller holds is fingerprinted too:
the estimate needs its bytes either way. The join stages' slots depend on
their dims' identity and are left out, as in the reference.

Everything here is advisory: a failure gives an empty fingerprint.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

from ..plan import physical as pp

# fingerprint length cap: a plan probing more slots is scored on its first
MAX_FINGERPRINT_SLOTS = 128


def plan_fingerprint(plan) -> Tuple[Tuple[int, int], ...]:
    """(slot_key, estimated_bytes) pairs for one physical plan, or () when
    nothing in it can be device-resident (a host plan, file scans under the
    stages, columns with no content fingerprint)."""
    try:
        device_nodes = [n for n in plan.walk()
                        if isinstance(n, (pp.DeviceGroupedAgg, pp.DeviceFilterAgg,
                                          pp.DeviceUdfProject))]
        if not device_nodes:
            return ()
        slots: Dict[int, int] = {}
        for node in device_nodes:
            if isinstance(node, pp.DeviceUdfProject):
                _udf_slots(node, slots)
            else:
                _node_slots(node, slots)
            if len(slots) >= MAX_FINGERPRINT_SLOTS:
                break
        return tuple(list(slots.items())[:MAX_FINGERPRINT_SLOTS])
    except Exception:  # noqa: BLE001 -- advisory: an estimate never fails a query
        return ()


def _slot_key(fp: int, key: tuple) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(int(fp).to_bytes(8, "little"))
    h.update(repr(key).encode())
    return int.from_bytes(h.digest(), "little")


def _device_name() -> str:
    from ..config import execution_config

    return execution_config().device


def _udf_slots(node, slots: Dict[int, int]) -> None:
    """The weight slots of a DeviceUdfProject (loading the weights is the
    once-a-process cost any run of it pays)."""
    call = pp.device_udf_call(node.udf_expr)
    if call is None:
        return
    from ..ops.udf_stage import func_anchors

    anchors = func_anchors(call.func)
    for anchor in (anchors or {}).values():
        key = _slot_key(anchor.content_fingerprint(), ("udf_params", _device_name()))
        slots[key] = anchor.nbytes


def _node_slots(node, slots: Dict[int, int]) -> None:
    from ..expressions.expressions import Alias, ColumnRef
    from ..ops.stage import pad_bucket

    if isinstance(node, pp.DeviceGroupedAgg):
        from ..ops.grouped_stage import try_build_grouped_agg_stage

        stage = try_build_grouped_agg_stage(node.input.schema, node.predicate,
                                            node.groupby, node.aggregations)
    else:
        from ..ops.stage import try_build_filter_agg_stage

        stage = try_build_filter_agg_stage(node.input.schema, node.predicate,
                                           node.aggregations)
    if stage is None:
        return
    f32 = not stage._use_f64
    device = _device_name()
    key_cols: List[str] = []
    if isinstance(node, pp.DeviceGroupedAgg):
        for g in node.groupby:
            ref = g.child if isinstance(g, Alias) else g
            if isinstance(ref, ColumnRef):
                key_cols.append(ref.name())
    for scan in (n for n in node.walk() if isinstance(n, pp.InMemoryScan)):
        for part in scan.partitions:
            for b in part.batches:
                if b.num_rows == 0:
                    continue
                bucket = pad_bucket(b.num_rows)
                for cname in stage._input_cols:
                    _add_slot(slots, b, cname, ("col", bucket, f32, device),
                              bucket * ((4 if f32 else 8) + 1))
                for cname in key_cols:
                    _add_slot(slots, b, cname, ("dictcodes", bucket, device), bucket * 4)
                if len(slots) >= MAX_FINGERPRINT_SLOTS:
                    return


def _add_slot(slots: Dict[int, int], batch, cname: str, key: tuple, est_bytes: int) -> None:
    try:
        fp = batch.get_column(cname).content_fingerprint()
    except (KeyError, ValueError, TypeError):
        # a column made above the scan, or one with no content fingerprint
        return
    slots[_slot_key(fp, key)] = est_bytes
