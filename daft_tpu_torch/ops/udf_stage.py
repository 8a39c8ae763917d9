"""The device-UDF tier: device UDFs as device stages (counterpart of
daft_tpu/ops/udf_stage.py).

- **Contract.** A ``Func`` with ``on_device=True`` wraps
  ``fn(params, *tensors) -> tensor``, a batch function on torch tensors whose
  output rows align with its input rows. Its weights come from
  ``Func.device_params()``, called at the start of each run; host
  tokenization and decoding ride the optional ``device_prepare`` /
  ``device_finish`` hooks.
  Without a prepare hook the arguments' own columns are the tensors, taken
  through the residency manager (a warm run over a resident table uploads
  nothing).
- **Stage.** ``DeviceUdfStage`` / ``DeviceUdfRun`` keep the device stages'
  ``start_run`` / ``feed_batch`` / ``finalize`` contract, so the executor's
  dispatch coalescer feeds them super-batches: one dispatch per chunk of
  at most ``Func.batch_size`` rows, each prepared on the host just before
  its dispatch (the next chunk's preprocessing overlaps this one's device
  work), padded
  to a power of two of at least 8 rows (``udf_pad_bucket``), under
  ``torch.inference_mode()`` (no autograd graph; a chunk's intermediates are
  freed before the next). Outputs stay on the device, and ``finalize``
  copies them all back at once.
- **Residency.** Weights are entries of the process-wide residency manager
  (device/residency.py) under a content fingerprint of their names and
  bytes (``_WeightAnchor``): budgeted, pinned while a query runs, and a repeat
  query uploads nothing (``device_udf_weight_h2d_bytes`` stays flat). With
  ``device_params_split`` each top-level part is its own entry, so the
  encoder under embed and under every classify label set is one entry.
- **Fusion.** ``FusedUdfAggFeeder`` hands the UDF's output plane straight
  into an ungrouped aggregate's stage (ops/stage.py ``FilterAggRun._run``)
  in the same dispatch: nothing is copied back in between.

``host_eval_device_func`` runs the same function through the same prepare,
padding and finish with no stage, coalescer or pin scope, chunk by chunk, on
the device that ``host_path_device`` names: the configured one, or the CPU
under ``device_mode="off"`` and in the host arm of an "auto" verdict
(``host_arm``). It serves a device UDF that the planner could
not make a stage of (one inside a larger expression, a filter or an
aggregation). On the CPU it gives the tier's results bit for bit wherever
the dispatch shapes match (a one-batch input).

A prepare hook whose output is not row-aligned raises ``PrepareMisaligned``
(a ValueError naming the contract) on the stage and on the host path
alike: nothing reruns elsewhere.

Counters: ``device_udf_dispatches`` and ``device_udf_rows`` (per chunk),
``device_udf_runs`` (per finalize), and ``device_udf_weight_h2d_bytes``
(weight bytes put on a stage's device; on a CPU device, made into its
tensors).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.metrics import registry
from ..observability.runtime_stats import profile_span
from . import counters

# model batches pad from 8, so small batches do not balloon to the
# relational stages' 512-row floor
_MIN_UDF_BUCKET = 8


def udf_pad_bucket(n: int) -> int:
    """Smallest power of two >= n (and >= 8): the tier's padding."""
    b = _MIN_UDF_BUCKET
    while b < n:
        b <<= 1
    return b


class PrepareMisaligned(ValueError):
    """A device UDF's prepared inputs do not have one row per input row."""


# ---- weight residency ---------------------------------------------------------------


class _WeightAnchor:
    """The long-lived anchor of one model's weights in the residency
    manager: its content fingerprint (a hash of the weight bytes) gives the
    entry a stable key, so equal weights share one entry."""

    def __init__(self, fp: int, host_params, nbytes: int):
        self._fp = fp
        self.host_params = host_params
        self.nbytes = nbytes

    def content_fingerprint(self) -> int:
        return self._fp


# id(host weights) -> (weights, anchor): providers hand out one weights object
# per process, so a repeat query finds its anchor without hashing the bytes
# again; the memo holds its object, so a reused id cannot alias another model.
# A miss builds a new anchor, and the residency manager's content key
# (device/residency.py ``stable_slot_key``) rebinds it to a resident entry of
# equal bytes. Serving threads may run queries at once: it changes under a lock.
_ANCHOR_LOCK = threading.Lock()
_ANCHOR_BY_ID: Dict[int, Tuple[Any, _WeightAnchor]] = {}
_ANCHOR_MEMO_CAP = 32


def _leaves(params, path: tuple = ()) -> List[Tuple[tuple, np.ndarray]]:
    """(path, array) of each array of a weights tree, dicts in sorted key
    order and lists in order; a path names each container's type and the
    key or index taken in it."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _leaves(params[k], path + (("dict", k),))]
    if isinstance(params, (list, tuple)):
        kind = type(params).__name__
        return [x for i, p in enumerate(params) for x in _leaves(p, path + ((kind, i),))]
    return [(path, np.asarray(params))]


def _to_tensors(params, device):
    """The weights tree with every array a tensor on ``device``."""
    import torch

    if isinstance(params, dict):
        return {k: _to_tensors(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_to_tensors(p, device) for p in params)
    return torch.as_tensor(np.asarray(params)).to(device)


def weight_fingerprint(params) -> int:
    """64-bit content hash of a weights tree: each array's path, dtype,
    shape and bytes, in ``_leaves`` order (equal arrays under other names
    are other weights)."""
    h = hashlib.blake2b(digest_size=8)
    for path, leaf in _leaves(params):
        h.update(repr(path).encode())
        h.update(str(leaf.dtype).encode())
        h.update(str(leaf.shape).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return int.from_bytes(h.digest(), "little")


def anchor_for(host) -> _WeightAnchor:
    """The anchor of one host weights tree: the memo's by identity, else a
    new one over the bytes' fingerprint."""
    with _ANCHOR_LOCK:
        hit = _ANCHOR_BY_ID.get(id(host))
        if hit is not None and hit[0] is host:
            return hit[1]
    fp = weight_fingerprint(host)  # outside the lock: hashing is the slow part
    a = _WeightAnchor(fp, host, sum(x.nbytes for _p, x in _leaves(host)))
    with _ANCHOR_LOCK:
        if len(_ANCHOR_BY_ID) >= _ANCHOR_MEMO_CAP:
            _ANCHOR_BY_ID.clear()
        _ANCHOR_BY_ID[id(host)] = (host, a)
    return a


def func_anchors(func) -> Optional[Dict[Optional[str], _WeightAnchor]]:
    """The weight anchors of a device Func (None: stateless): one under the
    part name None, or with ``device_params_split`` one per top-level key."""
    if func.device_params is None:
        return None
    host = func.device_params()
    if host is None:
        return None
    if func.device_params_split:
        return {name: anchor_for(sub) for name, sub in host.items()}
    return {None: anchor_for(host)}


def func_weight_nbytes(func) -> int:
    """Total host bytes of the Func's weight parts (0 = stateless)."""
    anchors = func_anchors(func)
    return sum(a.nbytes for a in anchors.values()) if anchors else 0


def func_fingerprint(func) -> str:
    """Stable identity of one device Func's program for the cost model's
    decision cache: the declared ``device_key`` when present, else
    module.qualname and a hash over the code object and its closure cells
    (bytecode alone collides for identical-source closures over different
    constants)."""
    if func.device_key:
        return func.device_key
    fn = func.fn
    code = getattr(fn, "__code__", None)
    tail = ""
    if code is not None:
        h = hashlib.blake2b(digest_size=6)
        h.update(code.co_code)
        h.update(repr(code.co_consts).encode())
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                h.update(repr(cell.cell_contents)[:4096].encode())
            except Exception:  # noqa: BLE001 -- an unreprable cell still feeds the hash
                h.update(b"?")
        tail = h.hexdigest()
    return f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', func.name)}:{tail}"


def resident_params(anchor: _WeightAnchor, device):
    """One anchor's weights as tensors on ``device``, through the residency
    manager: uploaded at most once per process and device, pinned inside a
    query's pin scope."""
    from ..device.residency import manager

    def upload():
        with profile_span("device.udf_h2d", "device", op="weights", bytes=anchor.nbytes):
            out = _to_tensors(anchor.host_params, device)
        registry().inc("hbm_h2d_bytes", anchor.nbytes)
        counters.bump("device_udf_weight_h2d_bytes", anchor.nbytes)
        return out

    return manager().get_or_build(anchor, ("udf_params", str(device)), upload)


def resident_weights(func, device):
    """A Func's weights on ``device`` (None: stateless); split parts as a
    dict of their own."""
    anchors = func_anchors(func)
    if anchors is None:
        return None
    if set(anchors) == {None}:
        return resident_params(anchors[None], device)
    return {name: resident_params(a, device) for name, a in anchors.items()}


# ---- host prepare / finish (the stage and the host path share them) -----------------


def _prepare_arrays(func, arg_series: Sequence) -> Tuple[list, np.ndarray, int]:
    """(inputs, validity, n) of one batch. With a prepare hook the inputs
    are the numpy arrays it makes of the arguments' Python lists (null rows
    included: they tokenize as empty), else the argument Series themselves.
    A row is null when its first argument is. Raises PrepareMisaligned when
    an input does not have one row per input row."""
    n = len(arg_series[0])
    valid = arg_series[0].validity_numpy()
    if func.device_prepare is not None:
        out = func.device_prepare(*[s.to_pylist() for s in arg_series])
        inputs = [np.asarray(a) for a in (out if isinstance(out, (tuple, list)) else (out,))]
    else:
        inputs = list(arg_series)
    for a in inputs:
        rows = len(a) if not isinstance(a, np.ndarray) or a.ndim else 0
        if rows != n:
            raise PrepareMisaligned(
                f"device UDF {func.name!r}: an input has {rows} rows for {n} input rows; the "
                "contract is fn(params, *tensors) over row-aligned inputs")
    return inputs, valid, n


def _pad_rows(a: np.ndarray, bucket: int) -> np.ndarray:
    if a.shape[0] >= bucket:
        return a
    pad = np.zeros((bucket - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad])


def _upload(a: np.ndarray, bucket: int, device):
    """``a`` zero-padded to ``bucket`` rows, copied to ``device``."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(_pad_rows(a, bucket))).to(device)


def _upload_nbytes(inputs: list, bucket: int) -> int:
    """The bytes ``_chunk_tensors`` uploads for a chunk's prepared arrays
    (a stage run counts them in ``hbm_h2d_bytes``)."""
    return sum(a.itemsize * bucket * (a.size // max(a.shape[0], 1))
               for a in inputs if isinstance(a, np.ndarray))


def _chunk_tensors(inputs: list, bucket: int, device, cached: bool) -> list:
    """Each input of one chunk as (values, validity) tensors of ``bucket``
    rows on ``device``, zero-padded: a prepared array uploaded (validity
    None), an argument Series through ``to_device`` (``to_device_cached``
    when ``cached``)."""
    return [(_upload(a, bucket, device), None) if isinstance(a, np.ndarray)
            else (a.to_device_cached if cached else a.to_device)(bucket, device=device)
            for a in inputs]


def _chunk_series(series: list, start: int, end: int) -> list:
    """Rows [start, end) of each argument Series (the Series themselves
    when that is all of them)."""
    if start == 0 and end == len(series[0]):
        return series
    return [s.slice(start, end) for s in series]


def finish_series(func, out: np.ndarray, valid: np.ndarray, name: str):
    """One run's output rows as a Series of the UDF's return dtype, null
    where the input row was: ``device_finish``'s values, or the output rows
    as they are (a 2-D output of a numeric list dtype goes straight to its
    lists, the values already of the element type; an output of a
    fixed-shape dtype, such as an embedding, to its dense rows)."""
    from ..core.series import Series, _lengths_to_offsets

    dtype = func.return_dtype
    if func.device_finish is None and out.ndim >= 2 and dtype.is_fixed_shape():
        # a fixed-shape dtype (an embedding, a tensor): the rows as they are
        return Series.from_numpy(out, name, dtype, validity=np.asarray(valid, dtype=bool))
    if func.device_finish is None and out.ndim == 2 and dtype.kind == "list" \
            and dtype.inner.is_numeric():
        valid = np.asarray(valid, dtype=bool).copy()
        flat = out[valid].astype(dtype.inner.to_numpy(), copy=False).reshape(-1)
        lens = np.where(valid, out.shape[1], 0)
        return Series.nested(name, dtype, _lengths_to_offsets(lens),
                             [Series.from_numpy(flat, "item", dtype.inner)], valid)
    if func.device_finish is not None:
        vals = func.device_finish(out)
    elif out.ndim == 1:
        vals = out.tolist()
    else:
        vals = out.astype(np.float64).tolist()
    return Series.from_pylist([v if ok else None for v, ok in zip(vals, valid.tolist())],
                              name, dtype)


def _chunks(n: int, cap: Optional[int]):
    """(start, end) of each chunk: the whole batch, or slices of at most
    ``cap`` rows (``Func.batch_size``)."""
    step = n if not cap or cap <= 0 else min(cap, n)
    for s in range(0, n, max(step, 1)):
        yield s, min(s + step, n)


def _call(func, params, tensors: list, bucket: int):
    """One call of the UDF's function over padded inputs; its output must be
    a tensor of ``bucket`` rows."""
    import torch

    with torch.inference_mode():
        out = func.fn(params, *tensors)
    if not isinstance(out, torch.Tensor) or out.ndim < 1 or out.shape[0] != bucket:
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else type(out).__name__
        raise ValueError(f"device UDF {func.name!r} returned {shape} for {bucket} rows; the "
                         "contract is fn(params, *tensors) -> one output row per input row")
    return out


# ---- the stage ----------------------------------------------------------------------


class DeviceUdfStage:
    """One device UDF over its argument expressions (immutable; per-run state
    in ``DeviceUdfRun``)."""

    def __init__(self, func, arg_exprs: Sequence, out_name: str):
        self.func = func
        self.arg_exprs = list(arg_exprs)
        self.out_name = out_name

    def start_run(self, device) -> "DeviceUdfRun":
        return DeviceUdfRun(self, device)


class DeviceUdfRun:
    """One run: host batches in, dispatches out, outputs kept on the device
    until ``finalize``. Output rows follow the fed rows in order."""

    def __init__(self, stage: DeviceUdfStage, device):
        self.stage = stage
        self.device = device
        # resolved at run start, so the executor's pin scope pins the weights
        self._params = resident_weights(stage.func, device)
        self._outs: List[Tuple[Any, int]] = []  # (device output, real rows)
        self._valids: List[np.ndarray] = []

    def _arguments(self, batch) -> list:
        from ..expressions.eval import eval_expression

        return [eval_expression(batch, e) for e in self.stage.arg_exprs]

    def _dispatch(self, planes: list, rows: int, bucket: int, fused: bool = False):
        args = {"fused": True} if fused else {}
        with profile_span("device.udf_dispatch", "device", op=self.stage.func.name,
                          rows=rows, bucket=bucket, **args):
            out = _call(self.stage.func, self._params, [v for v, _m in planes], bucket)
        counters.bump("device_udf_dispatches")
        counters.bump("device_udf_rows", rows)
        return out

    def feed_batch(self, batch) -> None:
        """One host batch (a coalesced super-batch): one dispatch per chunk,
        each chunk prepared just before it, so the host's preprocessing of
        the next chunk overlaps the device's work on this one."""
        n = batch.num_rows
        if n == 0:
            return
        series = self._arguments(batch)
        for s, e in _chunks(n, self.stage.func.batch_size):
            inputs, valid, m = _prepare_arrays(self.stage.func, _chunk_series(series, s, e))
            bucket = udf_pad_bucket(m)
            with profile_span("device.udf_h2d", "device", rows=m, bucket=bucket):
                planes = _chunk_tensors(inputs, bucket, self.device, cached=True)
            registry().inc("hbm_h2d_bytes", _upload_nbytes(inputs, bucket))
            self._outs.append((self._dispatch(planes, m, bucket), m))
            self._valids.append(valid)

    def dispatch_plane(self, batch, bucket: int):
        """The UDF over one batch padded to an aggregate stage's ``bucket``:
        (values, validity) planes on the device, cast as ``Series.to_device``
        casts a column of the UDF's return dtype, for the aggregate's program
        to read directly. A null first argument and a padding row are invalid:
        the first argument's resident validity plane, or, after a prepare
        hook, the validity uploaded."""
        inputs, valid, n = _prepare_arrays(self.stage.func, self._arguments(batch))
        with profile_span("device.udf_h2d", "device", rows=n, bucket=bucket):
            planes = _chunk_tensors(inputs, bucket, self.device, cached=True)
        registry().inc("hbm_h2d_bytes", _upload_nbytes(inputs, bucket))
        out = self._dispatch(planes, n, bucket, fused=True)
        if out.ndim != 1:
            raise ValueError(f"fused device UDF {self.stage.func.name!r} returned "
                             f"{tuple(out.shape)}: an aggregate reads one value per row")
        vplane = planes[0][1]
        if vplane is None:
            vplane = _upload(valid.astype(bool), bucket, self.device)
        return out.to(self.stage.func.return_dtype.to_torch()), vplane

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(output rows, validity) of every fed row, in feed order: one copy
        to the host for the whole run."""
        import torch

        outs, self._outs = self._outs, []
        valids, self._valids = self._valids, []
        counters.bump("device_udf_runs")
        if not outs:
            return np.empty((0,), np.float32), np.empty((0,), bool)
        with torch.inference_mode(), profile_span("device.udf_d2h", "device",
                                                  batches=len(outs)):
            parts = [o[:m] for o, m in outs]
            host = (torch.cat(parts) if len(parts) > 1 else parts[0]).cpu().numpy()
        return host, np.concatenate(valids)


class FusedUdfAggFeeder:
    """Feeds an ungrouped aggregate's run with the UDF's output plane: per
    (coalesced) batch, the UDF's dispatch output goes into the aggregate's
    column dict beside its other columns (through the residency manager),
    and the aggregate runs on it in the same dispatch: the UDF's column
    never leaves the device."""

    def __init__(self, udf_run: DeviceUdfRun, agg_run, udf_cols: Sequence[str],
                 other_cols: Dict[str, str], f32: bool):
        self._udf_run = udf_run
        self._agg_run = agg_run
        # the names the aggregate reads the UDF plane under
        self._udf_cols = list(udf_cols)
        # the aggregate's name -> the column of the UDF node's input
        self._other_cols = dict(other_cols)
        self._f32 = f32

    def feed_batch(self, batch) -> None:
        import torch

        from .stage import pad_bucket

        n = batch.num_rows
        if n == 0:
            return
        device = self._agg_run.device
        for s, e in _chunks(n, self._udf_run.stage.func.batch_size):
            chunk = batch if (s == 0 and e == n) else batch.slice(s, e)
            m = chunk.num_rows
            bucket = pad_bucket(m)
            vals, valid = self._udf_run.dispatch_plane(chunk, bucket)
            if self._f32 and vals.dtype == torch.float64:
                vals = vals.to(torch.float32)
            dcols = {name: (vals, valid) for name in self._udf_cols}
            for name, src in self._other_cols.items():
                dcols[name] = chunk.get_column(src).to_device_cached(bucket, f32=self._f32,
                                                                     device=device)
            self._agg_run._run(dcols, m, bucket)


# ---- the host path ------------------------------------------------------------------


_HOST_ARM = threading.local()


@contextlib.contextmanager
def host_arm():
    """Scope in which ``host_path_device()`` is the CPU on this thread: the
    host arm of a device UDF that ``device_mode="auto"`` priced to the host
    runs its function where the host side was priced."""
    prev = getattr(_HOST_ARM, "on", False)
    _HOST_ARM.on = True
    try:
        yield
    finally:
        _HOST_ARM.on = prev


def host_path_device():
    """The device a device UDF's host path and the provider's eager calls run
    on: the configured device (resolved, so a missing card raises), or the
    CPU under ``device_mode="off"`` and inside ``host_arm()``."""
    import torch

    from ..config import execution_config
    from ..utils.torch_setup import resolve_device

    cfg = execution_config()
    if cfg.device_mode == "off" or getattr(_HOST_ARM, "on", False):
        return torch.device("cpu")
    return resolve_device(cfg.device)


def host_eval_device_func(func, arg_series: Sequence, num_rows: int, name: str):
    """A device Func run as a plain batch UDF on ``host_path_device()``:
    prepare, pad each chunk to its bucket, the same function, unpad, finish
    into a Series named ``name``."""
    from ..core.series import Series

    series = list(arg_series)
    n = len(series[0])
    if n == 0:
        return Series.empty(name, func.return_dtype)
    device = host_path_device()
    params = resident_weights(func, device)
    outs, valids = [], []
    for s, e in _chunks(n, func.batch_size):
        inputs, valid, m = _prepare_arrays(func, _chunk_series(series, s, e))
        bucket = udf_pad_bucket(m)
        planes = _chunk_tensors(inputs, bucket, device, cached=False)
        outs.append(_call(func, params, [v for v, _m in planes], bucket)[:m].cpu().numpy())
        valids.append(valid)
    return finish_series(func, np.concatenate(outs), np.concatenate(valids), name)
