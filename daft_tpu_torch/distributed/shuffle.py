"""The disk-backed shuffle in Arrow IPC files (counterpart of
daft_tpu/distributed/shuffle.py, written and read by the port's own
io/arrow_ipc.py where the reference uses pyarrow). Layout:

    {base}/{shuffle_id}/p{partition}/m{map_id}.arrow

Each map task writes one file per partition it produced rows for; a reduce
task for partition p streams every m*.arrow under p{p}/. On one host the
fetch is a file read; fetch_server.py serves the same files over a socket.

Files are IPC streams with per-buffer body compression
(ExecutionConfig.shuffle_compression: "lz4" by default or "none"; "zstd"
raises, as io/arrow_ipc.py does: ROADMAP Queue 1, entry 8). The reader
takes the stream and the file container alike and decodes one batch at a
time, so a reduce holds a few batches, never a whole map file.

Two byte measures feed the counters: ``shuffle_logical_bytes`` (the
batches' own bytes) and ``shuffle_wire_bytes`` (the bytes on disk).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Iterator, List, Optional

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..io import arrow_ipc
from ..observability.metrics import registry
from ..schema import Schema
from . import faults


class ShuffleDataLost(RuntimeError):
    """A reduce task found shuffle map outputs MISSING that the map stage is
    known to have produced (`ShuffleRead.expected_maps`): the worker/host that
    wrote them is gone along with its files. Carries the precise lost map ids
    so the coordinator can re-execute exactly those map tasks from lineage
    (planner._regenerate_maps) instead of failing — or hanging on — the query.
    """

    def __init__(self, shuffle_id: str, map_ids, message: Optional[str] = None):
        self.shuffle_id = shuffle_id
        self.map_ids = tuple(map_ids)
        super().__init__(message or (
            f"shuffle {shuffle_id}: map outputs {sorted(self.map_ids)} "
            f"missing (worker storage lost)"))


class ShufflePeerUnreachable(RuntimeError):
    """A fetch peer refused/reset connections past the transient-retry budget
    (DAFT_TPU_FETCH_RETRIES): the host serving part of this shuffle is dead.
    Which map outputs it held is unknown to the client, so the coordinator's
    recovery path regenerates every map of the shuffle (bounded rounds)."""

    def __init__(self, shuffle_id: str, message: Optional[str] = None):
        self.shuffle_id = shuffle_id
        super().__init__(message or f"shuffle {shuffle_id}: peer unreachable")


def partition_dir(base: str, shuffle_id: str, partition_idx: int) -> str:
    return os.path.join(base, shuffle_id, f"p{partition_idx}")


class ShuffleRecorder:
    """Accumulates one task's shuffle volume: bytes/rows/partitions written by
    map tasks, bytes/rows/latency fetched by reduce tasks. Installed by the
    worker loop around each task (workers execute one task at a time, but the
    executor may drive shuffle reads from stage/pool threads — hence the lock).
    The snapshot ships back with the TaskResult for per-stage aggregation.

    Fetch timing is recorded on two axes because fetches overlap (pipelined
    requests, multi-peer fan-in): `fetch_seconds` is the CUMULATIVE in-flight
    time summed over requests (it over-counts wall time by design once
    requests run concurrently), `fetch_wall_seconds` is the union transfer
    window. Their difference is the transfer overlap the pipelined transport
    bought.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.bytes_written = 0          # logical (uncompressed Arrow) bytes
        self.wire_bytes_written = 0     # bytes that hit disk/the socket
        self.rows_written = 0
        self.partitions_written: set = set()
        self.bytes_fetched = 0          # wire bytes received
        self.rows_fetched = 0
        self.fetch_seconds = 0.0        # cumulative per-request in-flight time
        self.fetch_wall_seconds = 0.0   # union transfer window
        self.overlap_seconds = 0.0      # cumulative - window, per fetch call
        self.fetch_requests = 0
        self.fetch_fanin = 0            # max concurrent fetch connections

    def record_write(self, shuffle_id: str, partition_idx: int,
                     rows: int, nbytes: int) -> None:
        with self._lock:
            self.bytes_written += nbytes
            self.rows_written += rows
            self.partitions_written.add((shuffle_id, partition_idx))

    def record_write_wire(self, nbytes: int) -> None:
        with self._lock:
            self.wire_bytes_written += nbytes

    def record_fetch(self, rows: int, nbytes: int, seconds: float,
                     requests: int = 1) -> None:
        with self._lock:
            self.bytes_fetched += nbytes
            self.rows_fetched += rows
            self.fetch_seconds += seconds
            self.fetch_requests += requests

    def record_fetch_wall(self, wall_seconds: float, fanin: int,
                          overlap_seconds: float) -> None:
        with self._lock:
            self.fetch_wall_seconds += wall_seconds
            self.overlap_seconds += overlap_seconds
            self.fetch_fanin = max(self.fetch_fanin, fanin)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "bytes_written": self.bytes_written,
                "wire_bytes_written": self.wire_bytes_written,
                "rows_written": self.rows_written,
                "partitions_written": len(self.partitions_written),
                "bytes_fetched": self.bytes_fetched,
                "rows_fetched": self.rows_fetched,
                "fetch_seconds": self.fetch_seconds,
                "fetch_wall_seconds": self.fetch_wall_seconds,
                "overlap_seconds": self.overlap_seconds,
                "fetch_requests": self.fetch_requests,
                "fetch_fanin": self.fetch_fanin,
            }


# process-global active recorder: workers run one task at a time, so a single
# slot suffices; None (the default everywhere else) costs one attribute read
_ACTIVE_RECORDER: Optional[ShuffleRecorder] = None


def set_recorder(r: Optional[ShuffleRecorder]) -> None:
    global _ACTIVE_RECORDER
    _ACTIVE_RECORDER = r


def current_recorder() -> Optional[ShuffleRecorder]:
    return _ACTIVE_RECORDER


# Map-output lineage sink: the worker loop installs a fresh list per task
# (ALWAYS, independent of stats collection — this is correctness-bearing, not
# telemetry); MapOutputWriter.close() records one entry per map task
# ({shuffle_id, map_id, rows-per-partition, published paths}) and the entry
# ships back in TaskResult.map_outputs. The coordinator derives each reduce
# partition's expected_maps from these rows, which is what lets a reduce
# DETECT silently-missing files instead of producing wrong results.
_ACTIVE_MAP_OUTPUTS: Optional[list] = None


def set_map_outputs(sink: Optional[list]) -> None:
    global _ACTIVE_MAP_OUTPUTS
    _ACTIVE_MAP_OUTPUTS = sink


def _note_map_output(entry: dict) -> None:
    sink = _ACTIVE_MAP_OUTPUTS
    if sink is not None:
        sink.append(entry)


def _note_write(shuffle_id: str, partition_idx: int, rows: int, nbytes: int) -> None:
    registry().inc("shuffle_bytes_written", nbytes)
    registry().inc("shuffle_logical_bytes", nbytes)
    registry().inc("shuffle_rows_written", rows)
    r = _ACTIVE_RECORDER
    if r is not None:
        r.record_write(shuffle_id, partition_idx, rows, nbytes)


def _note_write_wire(nbytes: int) -> None:
    registry().inc("shuffle_wire_bytes", nbytes)
    r = _ACTIVE_RECORDER
    if r is not None:
        r.record_write_wire(nbytes)


def _note_fetch(rows: int, nbytes: int, seconds: float) -> None:
    registry().inc("shuffle_bytes_fetched", nbytes)
    registry().inc("shuffle_rows_fetched", rows)
    registry().inc("shuffle_fetch_seconds", seconds)
    r = _ACTIVE_RECORDER
    if r is not None:
        r.record_fetch(rows, nbytes, seconds)


def _note_fetch_wall(wall_seconds: float, fanin: int,
                     overlap_seconds: float) -> None:
    registry().inc("shuffle_fetch_wall_seconds", wall_seconds)
    if overlap_seconds > 0:
        registry().inc("shuffle_overlap_seconds", overlap_seconds)
    r = _ACTIVE_RECORDER
    if r is not None:
        r.record_fetch_wall(wall_seconds, fanin, overlap_seconds)


def iter_ipc_batches(source) -> Iterator[RecordBatch]:
    """The batches of an IPC stream or file container in ``source`` (bytes
    or a readable binary file object), decoded one at a time."""
    return arrow_ipc.iter_ipc_batches(source)


class MapOutputWriter:
    """One map task's writer: a file per partition, opened at its first
    batch and appended batch by batch (the map task never holds its whole
    output). Each file is written under a per-attempt temporary name and
    renamed into place on close, so two attempts of one deterministic map
    task (a speculative duplicate, a retry) publish whole files."""

    def __init__(self, base: str, shuffle_id: str, map_id: int,
                 num_partitions: int, compression: Optional[str] = None):
        if compression is None:
            from ..config import execution_config

            compression = execution_config().shuffle_compression
        if compression == "zstd":
            raise arrow_ipc._refuse_zstd()
        self.base = base
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.compression = compression
        self.rows = [0] * num_partitions
        self._writers: dict = {}
        self._files: dict = {}
        self._paths: dict = {}

    def append(self, partition_idx: int, batch: RecordBatch) -> None:
        if batch.num_rows == 0:
            return
        if faults.ENABLED and not self._writers:
            faults.maybe_trip("shuffle_map")
        self.rows[partition_idx] += batch.num_rows
        w = self._writers.get(partition_idx)
        if w is None:
            d = partition_dir(self.base, self.shuffle_id, partition_idx)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"m{self.map_id}.arrow")
            tmp = f"{path}.inprogress-{uuid.uuid4().hex[:8]}"
            f = open(tmp, "wb")
            w = arrow_ipc.StreamWriter(f, batch.schema, self.compression)
            self._writers[partition_idx] = w
            self._files[partition_idx] = f
            self._paths[partition_idx] = (tmp, path)
        w.write(batch)
        _note_write(self.shuffle_id, partition_idx, batch.num_rows, batch.size_bytes())

    def close(self) -> List[int]:
        wire = 0
        published: List[str] = []
        for p, w in self._writers.items():
            w.close()
            self._files[p].close()
            tmp, path = self._paths[p]
            try:
                os.replace(tmp, path)
                wire += os.path.getsize(path)
                published.append(path)
            except OSError:
                pass
        self._writers.clear()
        self._files.clear()
        self._paths.clear()
        if wire:
            _note_write_wire(wire)
        # the lineage record, also for an all-empty map output: no reduce
        # partition then waits for a file that will never exist
        _note_map_output({"shuffle_id": self.shuffle_id, "map_id": self.map_id,
                          "rows": list(self.rows), "paths": published})
        return self.rows


def write_map_output(base: str, shuffle_id: str, map_id: int,
                     partitioned: List[List[RecordBatch]],
                     compression: Optional[str] = None) -> List[int]:
    """Persist one map task's per-partition batches; returns rows per partition."""
    out = MapOutputWriter(base, shuffle_id, map_id, len(partitioned),
                          compression=compression)
    for p, batches in enumerate(partitioned):
        for b in batches:
            out.append(p, b)
    return out.close()


def check_expected_maps(shuffle_id: str, expected_maps, present) -> None:
    """Raise ShuffleDataLost naming exactly the map ids whose files are
    missing from `present` (an iterable of file names). The completeness
    gate that turns silent data loss — a dead worker's shuffle files gone —
    into a recoverable, attributable error."""
    if not expected_maps:
        return
    have = set(present)
    missing = [m for m in expected_maps if f"m{m}.arrow" not in have]
    if missing:
        raise ShuffleDataLost(shuffle_id, missing)


def read_partition(base: str, shuffle_id: str, partition_idx: int,
                   schema: Schema, expected_maps=None) -> Iterator[MicroPartition]:
    """Stream every map's output for one shuffle partition, one IPC batch at a
    time (peak memory is a batch, not a map file). Fetch time excludes the
    consumer's processing between yields (segmented timing).

    `expected_maps` (ShuffleRead.expected_maps — the map ids the coordinator's
    lineage says wrote rows for this partition) arms the completeness check:
    a missing file raises ShuffleDataLost instead of silently yielding a
    partial reduce input. None/() preserves the legacy read-what-exists
    behavior (direct callers, pre-lineage shuffle dirs)."""
    d = partition_dir(base, shuffle_id, partition_idx)
    if expected_maps:
        present = os.listdir(d) if os.path.isdir(d) else ()
        check_expected_maps(shuffle_id, expected_maps, present)
    if not os.path.isdir(d):
        return
    # timeline profiling: one "shuffle.read" slice per partition (local
    # shared-dir transport), covering the whole consumption window
    from ..observability.runtime_stats import span_iter

    inner = _read_partition_inner(d, schema)
    from ..memory.manager import manager

    if manager().limit_bytes() > 0:
        # budgeted reduce: decode ahead on the spill IO pool so decompress
        # overlaps the consumer's reduce compute (depth-bounded, and gated
        # on the budget so unbudgeted queries never touch the pool)
        from ..config import execution_config
        from ..memory.spill import prefetch_iter

        cfg = execution_config()
        if cfg.spill_io_threads > 0 and cfg.spill_prefetch_batches > 0:
            inner = prefetch_iter(lambda: _read_partition_inner(d, schema),
                                  cfg.spill_prefetch_batches,
                                  cfg.spill_io_threads, count=False)
    yield from span_iter("shuffle.read", "io", inner,
                         shuffle_id=shuffle_id, partition=partition_idx)


def _read_partition_inner(d: str, schema: Schema) -> Iterator[MicroPartition]:
    for name in sorted(os.listdir(d)):
        if not name.endswith(".arrow"):
            continue
        path = os.path.join(d, name)
        rows = 0
        spent = 0.0
        nbytes = 0
        with open(path, "rb") as f:
            t0 = time.perf_counter()
            try:
                for rb in iter_ipc_batches(f):
                    batch = arrow_ipc.onto_schema(rb, schema)
                    rows += batch.num_rows
                    spent += time.perf_counter() - t0
                    yield MicroPartition(schema, [batch])
                    t0 = time.perf_counter()
                spent += time.perf_counter() - t0
                nbytes = os.path.getsize(path)
            except BaseException:
                # consumer closed the generator (or decode failed) mid-file:
                # account what was actually read off disk so far
                nbytes = f.tell()
                raise
            finally:
                if rows or nbytes:
                    _note_fetch(rows, nbytes, spent)


def cleanup(base: str, shuffle_id: str) -> None:
    import shutil

    shutil.rmtree(os.path.join(base, shuffle_id), ignore_errors=True)
