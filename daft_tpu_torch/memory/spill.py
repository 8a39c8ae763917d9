"""Disk spill for out-of-core operators (counterpart of
daft_tpu/memory/spill.py): spill files in the port's own format, their
lifecycle, and IO overlapped on a small pool.

Format (the reference writes Arrow IPC streams; the port has no Arrow): a
file is a sequence of frames, one per appended batch. A frame is

    b"DTSF" | u32 header length | header (JSON) | u64 body length | body

The header holds the row count, the body's codec and raw length, and per
column its name, dtype, how its values are stored and whether it has a
validity plane. The body, compressed by the codec
(``ExecutionConfig.spill_compression``: "snappy", the default, through
io/codecs.py, or "none"), holds each plane at an 8-byte boundary: numeric
and date values as their bytes, booleans bit-packed, a string column as
int64 offsets plus UTF-8 bytes (or, where the column carries dictionary
codes, as int32 codes plus its dictionary in that form), binary as int64
offsets plus its bytes, a nested column as its layout (a list's or a map's
int64 offsets, then each child column in this form, recursively), a
``python`` column pickled, then the validity bit-packed where the column
has a null. A read gives back the batch that was written, bit for bit:
nulls and the values under them, NaN, -0.0, dates, and empty batches
(``encode_batch`` / ``decode_batch``).

IO overlap (``spill_io_threads``, 2): ``SpillFile.append`` queues the batch
and returns; encoding, compression and the disk write run on a
process-wide IO pool, in append order. The queue is capped in bytes, and
its pending bytes are on the host ledger while a budget is in force, so an
asynchronous spill cannot park batches beyond the budget. ``finish()``
waits for the queue and raises a deferred write error; ``finish_async()``
publishes behind the queued writes without waiting. ``read(prefetch=N)``
decodes up to N batches ahead on the same pool (``prefetch_iter``,
``spill_prefetch_batches``; extra depth beyond one batch a reader is capped
process-wide). ``spill_io_threads=0`` writes and reads every batch on the
caller's thread and touches neither pool nor overlap counters.

Lifecycle: every artifact carries its owner's pid (``s<pid>_<hex>.spill``
files, ``g<pid>_<hex>`` Grace directories) under ``spill_root()``
(``spill_dir``, or ``<tmp>/daft_tpu_torch_spill``: a root of its own, so the
reference's sweep and this one never meet). A writer appends to a ``.tmp``
name and renames it on finish; operators delete their files in
``finally``; ``gc_stale_spills`` removes the artifacts of dead processes,
their ``.tmp`` names included, once per process at the first spill. A
failed write or read raises; nothing retries in memory.

Counters (ops/counters.py, the reference's names): ``spill_batches``,
``spill_bytes``, ``spill_wire_bytes``, ``spill_files``, ``spill_dirs_gced``,
the pool's ``spill_write_seconds`` / ``spill_read_seconds`` and the
caller's ``spill_write_wall_seconds`` / ``spill_read_wall_seconds``, and
``spill_prefetch_inflight``.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import struct
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..observability.metrics import registry
from ..ops import counters
from ..schema import Schema

_MAGIC = b"DTSF"
_ALIGN = 8


def reset_counters() -> None:
    """Zero the spill and memory counters (ops/counters.py)."""
    counters.reset(counters.SPILL_COUNTER_NAMES + counters.MEMORY_COUNTER_NAMES)


def spill_root() -> str:
    """The directory spill artifacts go under."""
    from ..config import execution_config

    d = execution_config().spill_dir
    return d or os.path.join(tempfile.gettempdir(), "daft_tpu_torch_spill")


# ---- the frame format ----------------------------------------------------------------


def _dtype_of(spec) -> DataType:
    kind, params = spec
    out = []
    for p in params or ():
        if isinstance(p, dict) and "t" in p:
            out.append(_dtype_of(p["t"]))
        elif isinstance(p, dict) and "f" in p:
            out.append((p["f"][0], _dtype_of(p["f"][1])))
        elif isinstance(p, dict) and "s" in p:
            out.append(tuple(p["s"]))
        else:
            out.append(p)
    return DataType(kind, tuple(out))


def _dtype_spec(dtype: DataType):
    """A dtype as JSON: [kind, params], a nested type's element types and
    a struct's (name, type) fields recursively."""
    params = []
    for p in dtype.params:
        if isinstance(p, DataType):
            params.append({"t": _dtype_spec(p)})
        elif isinstance(p, tuple) and all(isinstance(x, int) for x in p):
            params.append({"s": list(p)})  # a tensor's shape
        elif isinstance(p, tuple):
            params.append({"f": [p[0], _dtype_spec(p[1])]})
        else:
            params.append(p)
    return [dtype.kind, params]


def _encode_strings(items: list):
    """(int64 offsets, UTF-8 bytes) of a list of str."""
    joined = "".join(items)
    data = joined.encode("utf-8", "surrogatepass")
    if len(data) == len(joined):
        lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    else:
        lens = np.fromiter((len(x.encode("utf-8", "surrogatepass")) for x in items),
                           dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return offsets, data


def _decode_strings(offsets: np.ndarray, data: bytes) -> np.ndarray:
    out = np.empty(len(offsets) - 1, dtype=object)
    if len(out) == 0:
        return out
    text = data.decode("utf-8", "surrogatepass")
    if len(text) == len(data):
        bounds = offsets.tolist()
        out[:] = [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    else:
        bounds = offsets.tolist()
        out[:] = [data[a:b].decode("utf-8", "surrogatepass")
                  for a, b in zip(bounds[:-1], bounds[1:])]
    return out


def _encode_column(s: Series, planes: List[bytes]) -> dict:
    """One column's entry, its planes appended to ``planes``."""
    values, valid = (None if s.is_nested else s.to_numpy()), s.validity_numpy()
    kind = s.dtype.kind
    entry = {"name": s.name, "dtype": _dtype_spec(s.dtype), "planes": []}
    if kind == "null":
        entry["form"] = "null"
    elif s.is_nested:
        entry["form"] = "nested"
        lay = s.layout
        if lay.offsets is not None:
            entry["planes"].append(len(planes))
            planes.append(np.ascontiguousarray(lay.offsets, dtype=np.int64).tobytes())
        entry["children"] = [_encode_column(c, planes) for c in lay.children]
    elif kind == "python":
        entry["form"] = "pickle"
        entry["planes"].append(len(planes))
        planes.append(pickle.dumps(values.tolist(), protocol=pickle.HIGHEST_PROTOCOL))
    elif s.dtype.is_binary():
        entry["form"] = "bytes"
        items = [v if ok else b"" for v, ok in zip(values.tolist(), valid.tolist())]
        lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        entry["planes"] += [len(planes), len(planes) + 1]
        planes += [offsets.tobytes(), b"".join(items)]
    elif kind == "string":
        raw = s._raw_codes()
        if raw is not None and len(raw[1]) <= len(s):
            codes, dictionary = raw
            entry["form"] = "dict"
            offsets, data = _encode_strings(["" if v is None else v for v in dictionary])
            entry["dict_none"] = [i for i, v in enumerate(dictionary) if v is None]
            arrays = [np.ascontiguousarray(codes, dtype=np.int32), offsets]
            for a in arrays:
                entry["planes"].append(len(planes))
                planes.append(a.tobytes())
            entry["planes"].append(len(planes))
            planes.append(data)
        else:
            entry["form"] = "utf8"
            nones = np.flatnonzero(np.equal(values, None))
            items = values.tolist()
            for i in nones.tolist():
                items[i] = ""
            entry["none_rows"] = len(nones) > 0
            offsets, data = _encode_strings(items)
            entry["planes"] += [len(planes), len(planes) + 1]
            planes += [offsets.tobytes(), data]
            if len(nones):
                entry["planes"].append(len(planes))
                planes.append(nones.astype(np.int64).tobytes())
    elif kind == "bool":
        entry["form"] = "bits"
        entry["planes"].append(len(planes))
        planes.append(np.packbits(values.astype(bool)).tobytes())
    else:
        entry["form"] = "raw"
        entry["np"] = values.dtype.str
        entry["planes"].append(len(planes))
        planes.append(np.ascontiguousarray(values).tobytes())
    if not valid.all():
        entry["validity"] = len(planes)
        planes.append(np.packbits(valid).tobytes())
    return entry


def encode_batch(batch: RecordBatch, codec: str) -> bytes:
    """One frame holding ``batch``."""
    planes: List[bytes] = []
    cols = [_encode_column(s, planes) for s in batch.columns()]
    sizes = [len(p) for p in planes]
    body = bytearray()
    for p in planes:
        body += p
        body += b"\0" * (-len(body) % _ALIGN)
    raw_len = len(body)
    if codec == "snappy":
        from ..io.codecs import snappy_compress

        body = snappy_compress(bytes(body))
    header = json.dumps({"rows": batch.num_rows, "codec": codec, "raw": raw_len,
                         "sizes": sizes, "cols": cols}).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header,
                     struct.pack("<Q", len(body)), bytes(body)])


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise IOError(f"spill file {getattr(f, 'name', '?')} is truncated")
    return data


def read_frame(f) -> Optional[RecordBatch]:
    """The next frame's batch from an open file, or None at its end."""
    magic = f.read(4)
    if not magic:
        return None
    if magic != _MAGIC:
        raise IOError(f"spill file {getattr(f, 'name', '?')}: bad frame magic {magic!r}")
    (hlen,) = struct.unpack("<I", _read_exact(f, 4))
    header = json.loads(_read_exact(f, hlen))
    (blen,) = struct.unpack("<Q", _read_exact(f, 8))
    return decode_batch(header, _read_exact(f, blen))


def decode_batch(header: dict, body: bytes) -> RecordBatch:
    """The batch a frame's header and body hold."""
    if header["codec"] == "snappy":
        from ..io.codecs import snappy_decompress

        body = snappy_decompress(body, header["raw"])
    buf = bytearray(body)
    starts, pos = [], 0
    for size in header["sizes"]:
        starts.append(pos)
        pos += size + (-(pos + size) % _ALIGN)
    n = header["rows"]

    def plane(i: int, dtype=np.uint8, count: int = -1) -> np.ndarray:
        nbytes = header["sizes"][i]
        if count < 0:
            count = nbytes // np.dtype(dtype).itemsize
        return np.frombuffer(buf, dtype=dtype, count=count, offset=starts[i])

    def raw_bytes(i: int) -> bytes:
        return bytes(buf[starts[i]:starts[i] + header["sizes"][i]])

    def column(e: dict, n: int) -> Series:
        dtype = _dtype_of(e["dtype"])
        valid = np.unpackbits(plane(e["validity"]), count=n).astype(bool) \
            if "validity" in e else np.ones(n, dtype=bool)
        form = e["form"]
        if form == "null":
            values = np.empty(n, dtype=object)
        elif form == "nested":
            offsets = plane(e["planes"][0], np.int64, n + 1).copy() if e["planes"] else None
            kind = dtype.storage.kind
            if kind == "struct":
                counts = [n] * len(e["children"])
            elif kind == "fixed_size_list":
                counts = [n * dtype.storage.size]
            else:
                counts = [int(offsets[-1])]
            kids = [column(c, k) for c, k in zip(e["children"], counts)]
            return Series.nested(e["name"], dtype, offsets, kids, valid)
        elif form == "pickle":
            from ..core.series import _object_array

            values = _object_array(pickle.loads(raw_bytes(e["planes"][0])))
        elif form == "bytes":
            offsets = plane(e["planes"][0], np.int64, n + 1).tolist()
            data = raw_bytes(e["planes"][1])
            values = np.empty(n, dtype=object)
            values[:] = [data[a:b] if ok else None
                         for a, b, ok in zip(offsets[:-1], offsets[1:], valid.tolist())]
        elif form == "dict":
            codes = plane(e["planes"][0], np.int32, n).copy()
            offsets = plane(e["planes"][1], np.int64)
            dictionary = _decode_strings(offsets, raw_bytes(e["planes"][2]))
            for i in e["dict_none"]:
                dictionary[i] = None
            values = dictionary[codes] if len(dictionary) else np.empty(n, dtype=object)
            values[~valid] = None
            s = Series(e["name"], dtype, values, valid)
            s._dict_codes = ("raw", codes, dictionary.tolist())
            return s
        elif form == "utf8":
            values = _decode_strings(plane(e["planes"][0], np.int64), raw_bytes(e["planes"][1]))
            if e["none_rows"]:
                values[plane(e["planes"][2], np.int64)] = None
        elif form == "bits":
            values = np.unpackbits(plane(e["planes"][0]), count=n).astype(bool)
        else:
            values = plane(e["planes"][0], np.dtype(e["np"]), n)
        return Series(e["name"], dtype, values, valid)

    cols = [column(e, n) for e in header["cols"]]
    schema = Schema([Field(s.name, s.dtype) for s in cols])
    return RecordBatch(schema, cols, n)


# ---- stale-artifact GC ---------------------------------------------------------------

_GC_LOCK = threading.Lock()
_GC_DONE = False

# s<pid>_<hex>.spill files, g<pid>_<hex> Grace directories and their .tmp
# names; fully anchored, so no other name parses into a pid
_ARTIFACT_RE = re.compile(r"^[sg](\d+)_[0-9a-f]+(?:\.spill(?:\.tmp)?)?$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # another owner's, or unknowable: never sweep it
    return True


def gc_stale_spills(root: Optional[str] = None) -> int:
    """Remove the spill artifacts of dead processes (the pid in the name),
    ``.tmp`` names included; a live process's are never touched. Returns
    how many were removed (also counted in ``spill_dirs_gced``)."""
    root = root or spill_root()
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    removed = 0
    for name in names:
        m = _ARTIFACT_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(root, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
            removed += 1
        except OSError:
            continue
    if removed:
        counters.bump("spill_dirs_gced", removed)
    return removed


def _gc_stale_once() -> None:
    global _GC_DONE
    with _GC_LOCK:
        if _GC_DONE:
            return
        _GC_DONE = True
    gc_stale_spills()


# ---- the spill IO pool ---------------------------------------------------------------

_POOL_LOCK = threading.Lock()
_POOLS: dict = {}  # width -> ThreadPoolExecutor


def _io_pool(n: int):
    """The process-wide spill IO pool of ``n`` threads, made at first use."""
    with _POOL_LOCK:
        pool = _POOLS.get(n)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="daft-spill-io")
            _POOLS[n] = pool
        return pool


def _queue_cap_bytes() -> int:
    """One file's pending-write cap: enough to keep the IO threads busy,
    small beside the host budget."""
    from .manager import manager

    limit = manager().limit_bytes()
    cap = 64 << 20
    if limit > 0:
        cap = min(cap, max(limit // 8, 1 << 20))
    return cap


# ---- the prefetching reader ----------------------------------------------------------

# read-ahead batches beyond each reader's first, shared process-wide, so a
# wide merge cannot hold fan-in x depth decoded batches
_PF_LOCK = threading.Lock()
_PF_EXTRA = 0
_PF_EXTRA_CAP = 64


def _pf_take_extra() -> bool:
    global _PF_EXTRA
    with _PF_LOCK:
        if _PF_EXTRA >= _PF_EXTRA_CAP:
            return False
        _PF_EXTRA += 1
        return True


def _pf_give_extra() -> None:
    global _PF_EXTRA
    with _PF_LOCK:
        _PF_EXTRA = max(_PF_EXTRA - 1, 0)


_EOF = object()


class _Prefetcher:
    """One iterator pumped on the spill IO pool into a bounded queue. The
    pump decodes while the queue has room and returns otherwise (the
    consumer reschedules it), so many readers share a small pool without
    blocking its threads."""

    def __init__(self, factory: Callable[[], Iterator], depth: int, pool,
                 count: bool = True):
        self._factory = factory
        self._depth = max(int(depth), 1)
        self._pool = pool
        self._count = count
        self._cond = threading.Condition(threading.Lock())
        self._q: deque = deque()  # (item, holds an extra token)
        self._eof = False
        self._err: Optional[BaseException] = None
        self._closed = False
        self._running = False
        self._it: Optional[Iterator] = None
        self._hw = 0

    def _pump(self) -> None:
        try:
            if self._it is None:
                self._it = self._factory()
            while True:
                token = False
                with self._cond:
                    if (self._closed or self._eof or self._err is not None
                            or len(self._q) >= self._depth):
                        return
                    if self._q:
                        token = _pf_take_extra()
                        if not token:
                            return  # the process-wide read-ahead is spent
                t0 = time.perf_counter()
                try:
                    item = next(self._it, _EOF)
                except BaseException as e:  # noqa: BLE001 -- raised again on the consumer
                    if token:
                        _pf_give_extra()
                    with self._cond:
                        self._err = e
                    return
                if self._count:
                    counters.bump("spill_read_seconds", time.perf_counter() - t0)
                with self._cond:
                    if item is _EOF or self._closed:
                        if token:
                            _pf_give_extra()
                        self._eof = self._eof or item is _EOF
                        return
                    self._q.append((item, token))
                    if len(self._q) > self._hw:
                        self._hw = len(self._q)
                        if self._count:
                            registry().set_gauge_max("spill_prefetch_inflight", self._hw)
        finally:
            with self._cond:
                self._running = False
                self._cond.notify_all()

    def _schedule_locked(self) -> None:
        if (not self._running and not self._eof and self._err is None
                and not self._closed and len(self._q) < self._depth):
            self._running = True
            self._pool.submit(self._pump)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = None
        with self._cond:
            while True:
                if self._q:
                    item, token = self._q.popleft()
                    break
                if self._err is not None:
                    raise self._err
                if self._eof:
                    raise StopIteration
                self._schedule_locked()
                if t0 is None:
                    t0 = time.perf_counter()
                self._cond.wait(0.05)
            self._schedule_locked()  # top the queue up again
        if token:
            _pf_give_extra()
        if t0 is not None and self._count:
            counters.bump("spill_read_wall_seconds", time.perf_counter() - t0)
        return item

    def close(self) -> None:
        with self._cond:
            self._closed = True
            for _item, token in self._q:
                if token:
                    _pf_give_extra()
            self._q.clear()
            self._cond.notify_all()
            while self._running:
                self._cond.wait(0.05)
        it, self._it = self._it, None
        if it is not None and hasattr(it, "close"):
            it.close()


def prefetch_iter(factory: Callable[[], Iterator], depth: int,
                  io_threads: Optional[int] = None, count: bool = True) -> Iterator:
    """``factory()``'s items with up to ``depth`` decoded ahead on the spill
    IO pool; plain iteration when ``depth`` or the pool's width is 0. Spill
    reads and budgeted Parquet scans (io/parquet.py) share it."""
    if io_threads is None:
        from ..config import execution_config

        io_threads = execution_config().spill_io_threads
    if depth <= 0 or io_threads <= 0:
        yield from factory()
        return
    pf = _Prefetcher(factory, depth, _io_pool(io_threads), count=count)
    try:
        yield from pf
    finally:
        pf.close()


# ---- spill files ---------------------------------------------------------------------

_FINISH = object()  # queue marker: close and publish behind the pending writes


class SpillFile:
    """One append-only spill file: frames written in append order, on the
    spill IO pool when ``spill_io_threads`` > 0, published by renaming its
    ``.tmp`` name, read back as a stream."""

    def __init__(self, schema: Schema, spill_dir: Optional[str] = None,
                 compression: Optional[str] = None):
        from ..config import execution_config

        _gc_stale_once()
        cfg = execution_config()
        self.schema = schema
        d = spill_dir or spill_root()
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"s{os.getpid()}_{uuid.uuid4().hex[:10]}.spill")
        self._tmp = self.path + ".tmp"
        self._codec = compression or cfg.spill_compression
        if self._codec not in ("none", "snappy"):
            raise ValueError(f"spill compression must be 'none' or 'snappy', got "
                             f"{self._codec!r}")
        self._file = None
        self._published = False
        self.rows = 0
        self.bytes_written = 0  # size_bytes of what was appended
        # fixed at construction: one file never mixes the two write paths
        self._io_threads = cfg.spill_io_threads
        self._prefetch = cfg.spill_prefetch_batches
        # the asynchronous path's state, made at the first queued append
        self._cond: Optional[threading.Condition] = None
        self._q: Optional[deque] = None  # (batch | _FINISH, nbytes, ledgered)
        self._pending_bytes = 0
        self._draining = False
        self._io_err: Optional[BaseException] = None

    # ---- writing ------------------------------------------------------------------
    def _write(self, batch: RecordBatch) -> None:
        if self._file is None:
            counters.bump("spill_files")
            self._file = open(self._tmp, "wb")
        self._file.write(encode_batch(batch, self._codec))

    def append(self, batch: RecordBatch) -> None:
        if batch.num_rows == 0:
            return
        if self._io_threads <= 0:
            self._write(batch)
            self.rows += batch.num_rows
            nb = batch.size_bytes()
            self.bytes_written += nb
            counters.bump("spill_batches")
            counters.bump("spill_bytes", nb)
            return
        self._append_async(batch)

    def _append_async(self, batch: RecordBatch) -> None:
        from .manager import manager

        nb = batch.size_bytes()
        if self._cond is None:
            self._cond = threading.Condition(threading.Lock())
            self._q = deque()
        cap = _queue_cap_bytes()
        stalled = 0.0
        with self._cond:
            t0 = time.perf_counter() if self._pending_bytes >= cap else 0.0
            while self._pending_bytes >= cap and self._q and self._io_err is None:
                self._cond.wait(0.05)
            if t0:
                stalled = time.perf_counter() - t0
            if self._io_err is not None:
                raise RuntimeError(f"deferred spill write failed: {self._io_err}") \
                    from self._io_err
            ledgered = 0
            mgr = manager()
            if mgr.limit_bytes() > 0:
                # a queued batch is still host memory: it stays on the
                # ledger until the IO thread has written it
                mgr.track(nb)
                ledgered = nb
            self._q.append((batch, nb, ledgered))
            self._pending_bytes += nb
            if not self._draining:
                self._draining = True
                _io_pool(self._io_threads).submit(self._drain)
        self.rows += batch.num_rows
        self.bytes_written += nb
        counters.bump("spill_batches")
        counters.bump("spill_bytes", nb)
        if stalled:
            counters.bump("spill_write_wall_seconds", stalled)

    def _drain(self) -> None:
        """The IO pool's task: write the queued batches in append order (one
        drainer a file); the head leaves the queue only once written. Each
        write is a "spill.write" span while a span recorder is active."""
        from ..observability.runtime_stats import profile_span
        from .manager import manager

        while True:
            with self._cond:
                if self._io_err is not None or not self._q:
                    self._draining = False
                    self._cond.notify_all()
                    return
                item, nb, ledgered = self._q[0]
            t0 = time.perf_counter()
            try:
                if item is _FINISH:
                    self._close_and_publish()
                else:
                    with profile_span("spill.write", "spill", rows=item.num_rows):
                        self._write(item)
            except BaseException as e:  # noqa: BLE001 -- raised again on the producer
                with self._cond:
                    self._io_err = e
                    release = ledgered
                    while self._q:
                        i, _nb, led = self._q.popleft()
                        release += led if i is not item else 0
                    self._pending_bytes = 0
                    self._draining = False
                    self._cond.notify_all()
                if release:
                    manager().release(release)
                return
            if item is not _FINISH:
                counters.bump("spill_write_seconds", time.perf_counter() - t0)
            with self._cond:
                if self._q and self._q[0][0] is item:
                    self._q.popleft()
                    self._pending_bytes -= nb
                else:
                    ledgered = 0  # delete() took the queue and released it
                self._cond.notify_all()
            if ledgered:
                manager().release(ledgered)

    def _join_queue(self) -> None:
        """Wait for the queue to drain; raise a deferred write error."""
        if self._cond is None:
            return
        t0 = time.perf_counter()
        with self._cond:
            while self._draining or self._q:
                self._cond.wait(0.05)
            err = self._io_err
        waited = time.perf_counter() - t0
        if waited > 0.0005:
            counters.bump("spill_write_wall_seconds", waited)
        if err is not None:
            raise RuntimeError(f"deferred spill write failed: {err}") from err

    def _close_and_publish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if not self._published and os.path.exists(self._tmp):
            os.replace(self._tmp, self.path)
            self._published = True
            try:
                counters.bump("spill_wire_bytes", os.path.getsize(self.path))
            except OSError:
                pass  # deleted meanwhile: the wire bytes are advisory

    def finish(self) -> None:
        """Wait for the queued writes, close, and publish the file."""
        self._join_queue()
        self._close_and_publish()

    def finish_async(self) -> None:
        """Publish behind the queued writes without waiting; a later
        ``finish()`` or ``read()`` waits and raises a deferred error."""
        if self._cond is None:
            self.finish()
            return
        with self._cond:
            if self._io_err is None:
                self._q.append((_FINISH, 0, 0))
                if not self._draining:
                    self._draining = True
                    _io_pool(self._io_threads).submit(self._drain)

    # ---- reading ------------------------------------------------------------------
    def _decode_iter(self) -> Iterator[RecordBatch]:
        with open(self.path, "rb") as f:
            while True:
                b = read_frame(f)
                if b is None:
                    return
                yield RecordBatch(self.schema, b.columns(), b.num_rows) \
                    if b.schema == self.schema else b.cast_to_schema(self.schema)

    def read(self, prefetch: Optional[int] = None) -> Iterator[RecordBatch]:
        """The batches in append order; with ``prefetch`` > 0 (default: the
        config's when the IO pool is on) decoded ahead on the pool, the read
        one "spill.read" span while a span recorder is active."""
        self.finish()
        if prefetch is None:
            prefetch = self._prefetch if self._io_threads > 0 else 0
        if self.rows == 0 or not os.path.exists(self.path):
            return
        if prefetch > 0 and self._io_threads > 0:
            from ..observability.runtime_stats import span_iter

            yield from span_iter("spill.read", "spill",
                                 prefetch_iter(self._decode_iter, prefetch, self._io_threads))
        else:
            yield from self._decode_iter()

    # ---- lifecycle ----------------------------------------------------------------
    def delete(self) -> None:
        """Drop the queued writes (their ledger bytes released), close and
        remove the file."""
        from .manager import manager

        if self._cond is not None:
            release = 0
            with self._cond:
                # keep the head while a drainer writes it; it then finds the
                # queue empty and stops
                while len(self._q) > (1 if self._draining else 0):
                    _item, nb, led = self._q.pop()
                    self._pending_bytes -= nb
                    release += led
                while self._draining:
                    self._cond.wait(0.05)
                while self._q:
                    _item, nb, led = self._q.popleft()
                    self._pending_bytes = max(self._pending_bytes - nb, 0)
                    release += led
                self._cond.notify_all()
            if release:
                manager().release(release)
        if self._file is not None:
            self._file.close()
            self._file = None
        for p in (self._tmp, self.path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass


class SpillPartitions:
    """K hash-partitioned spill files (the Grace partitions of the
    aggregation, join and window) in one directory of their own, so a
    failure's cleanup and the dead-pid sweep are one removal."""

    def __init__(self, schema: Schema, k: int, spill_dir: Optional[str] = None):
        _gc_stale_once()
        base = spill_dir or spill_root()
        self.dir = os.path.join(base, f"g{os.getpid()}_{uuid.uuid4().hex[:10]}")
        os.makedirs(self.dir, exist_ok=True)
        self.k = k
        self.files: List[SpillFile] = [SpillFile(schema, self.dir) for _ in range(k)]

    @property
    def bytes_written(self) -> int:
        return sum(f.bytes_written for f in self.files)

    def append_partitioned(self, batch: RecordBatch, key_exprs) -> None:
        """Split ``batch`` over the K files by the keys' row hash
        (``RecordBatch.partition_by_hash``, the reference's partitioning)."""
        from ..expressions.eval import eval_expression

        n = batch.num_rows
        keys = []
        for e in key_exprs:
            s = eval_expression(batch, e)
            keys.append(s.broadcast(n) if len(s) == 1 and n != 1 else s)
        for j, piece in enumerate(batch.partition_by_hash(keys, self.k)):
            if piece.num_rows:
                self.files[j].append(piece)

    def delete(self) -> None:
        for f in self.files:
            f.delete()
        shutil.rmtree(self.dir, ignore_errors=True)
