"""Stage-boundary checkpoints (counterpart of daft_tpu/checkpoint/stages.py).

The write pipelines' ``staged -> checkpointed -> committed`` lifecycle
(checkpoint/__init__.py) at a coarser grain: the unit is a query's stage
boundary (a shuffle stage's partition files, or a result's partitions),
keyed under the plan's content fingerprint. The gateway checkpoints each
executed query's result here, so a relaunched gateway serves committed
results from disk (gateway/server.py).

Layout under ``DAFT_TPU_CHECKPOINT_DIR``::

    {root}/{query_fp}/shuffle-0/                # payload: copied map files
    {root}/{query_fp}/shuffle-0/MANIFEST.json
    {root}/{query_fp}/shuffle-0.committed       # the commit marker
    {root}/{query_fp}/result/part0.arrow        # the result's IPC files
    {root}/{query_fp}/result.committed

A payload is staged in a ``.staging-{uuid}`` directory no reader looks at,
sealed by an atomic ``os.replace`` into place and committed by renaming an
empty marker beside it: a crash leaves nothing, an unread staging
directory, or a whole committed stage, never a torn one. Result partitions
are Arrow IPC stream files (io/arrow_ipc.py) in
``ExecutionConfig.shuffle_compression``'s codec.

Keys (``query_fingerprint``) are the port's own: SHA-256 over the plan's
structure and its in-memory columns' content fingerprints (core/series.py,
SHA-256 based), so they differ from the reference's, and a device star join
is keyed by its host translation (``host_plan``, the same computation),
where the reference leaves such a plan unkeyed (ROADMAP Queue 3).

Zero-overhead contract: this module is imported only where
``DAFT_TPU_CHECKPOINT_DIR`` is set or a caller asks for a fingerprint (the
gateway's result cache); otherwise no checkpoint code runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import uuid
from typing import Dict, List, Optional, Tuple

from ..observability.metrics import registry
from ..utils.env import env_float

_MANIFEST = "MANIFEST.json"


# ---- garbage collection (age-based sweep) --------------------------------------------


def _ttl_seconds() -> float:
    """DAFT_TPU_CHECKPOINT_TTL_S: the age past which a query's checkpoint
    tree is swept; <= 0 or unset = no sweep."""
    return env_float("DAFT_TPU_CHECKPOINT_TTL_S", 0.0)


def sweep_expired(root: str, ttl_s: Optional[float] = None, now: Optional[float] = None,
                  skip: Optional[str] = None) -> int:
    """Remove the query checkpoint trees older than the TTL; returns the
    committed stages removed (``checkpoint_stages_gced``). The age is the
    query directory's mtime, which every commit refreshes, so a query still
    checkpointing is never swept; ``skip`` spares the opening query's own
    tree. Errors are swallowed: a sweep never fails a query."""
    ttl = _ttl_seconds() if ttl_s is None else ttl_s
    if ttl <= 0 or not os.path.isdir(root):
        return 0
    import time

    now = time.time() if now is None else now
    gced = 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    for name in names:
        if name == skip:
            continue
        path = os.path.join(root, name)
        try:
            if not os.path.isdir(path) or now - os.path.getmtime(path) <= ttl:
                continue
            stages = 0
            for _dirpath, _dirnames, filenames in os.walk(path):
                stages += sum(1 for f in filenames if f.endswith(".committed"))
            shutil.rmtree(path, ignore_errors=True)
            gced += stages
        except OSError:
            continue
    if gced:
        registry().inc("checkpoint_stages_gced", gced)
    return gced


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:  # another device, or a file system without hard links
        shutil.copy2(src, dst)


# ---- query fingerprint --------------------------------------------------------------


def query_fingerprint(phys) -> Optional[str]:
    """A content-derived checkpoint id of a physical plan, stable across
    processes: SHA-256 over the plan's structural walk (node types,
    expression reprs, schemas, primitive fields) and the content
    fingerprints of every in-memory source column. None (no checkpoint, no
    result caching) when a node holds state that cannot be keyed by content
    (file scan tasks, write sinks, UDF handles, a binary or nested column):
    resuming on a guessed identity could serve a stale result."""
    from ..expressions.expressions import Expression
    from ..plan import physical as pp
    from ..schema import Schema

    h = hashlib.sha256()

    def feed(val) -> bool:
        if isinstance(val, pp.PhysicalPlan):
            return True  # the subtree arrives through the walk
        if isinstance(val, Expression):
            h.update(b"e")
            h.update(repr(val).encode())
            return True
        if isinstance(val, Schema):
            for f in val:
                h.update(f.name.encode())
                h.update(repr(f.dtype).encode())
            return True
        if isinstance(val, (set, frozenset)):
            return feed(sorted(val, key=repr))
        if isinstance(val, (list, tuple)):
            h.update(b"[")
            if not all(feed(v) for v in val):
                return False
            h.update(b"]")
            return True
        if isinstance(val, dict):
            for k in sorted(val, key=str):
                h.update(str(k).encode())
                if not feed(val[k]):
                    return False
            return True
        if isinstance(val, (str, int, float, bool, bytes, type(None))):
            h.update(repr(val).encode())
            return True
        return False  # an opaque object: no stable identity

    def plan(root) -> bool:
        for node in root.walk():
            h.update(b"\x00")
            h.update(type(node).__name__.encode())
            if isinstance(node, pp.InMemoryScan):
                names = node.schema.column_names()
                for part in node.partitions:
                    for b in part.batches:
                        h.update(struct.pack("<q", b.num_rows))
                        for name in names:
                            fp = b.get_column(name).content_fingerprint()
                            h.update(struct.pack("<Q", fp & ((1 << 64) - 1)))
                continue
            if isinstance(node, (pp.DeviceJoinAgg, pp.DeviceJoinTopN)):
                # the host translation of the same subtree says what it computes
                h.update(b"host")
                if not plan(node.host_plan):
                    return False
                continue
            for fname in sorted(vars(node)):
                if fname.startswith("_") or fname in ("input", "left", "right", "inputs"):
                    continue
                h.update(fname.encode())
                if not feed(vars(node)[fname]):
                    return False
        return True

    try:
        if not plan(phys):
            return None
    except (TypeError, ValueError, KeyError):
        # a column with no content fingerprint (binary, nested, python)
        return None
    return h.hexdigest()[:24]


# ---- the stage checkpointer ---------------------------------------------------------


class StageCheckpointer:
    """One query fingerprint's stage checkpoints (see the module doc). Safe
    against concurrent writers of the same stage (atomic staging, the last
    committer wins over equal content)."""

    def __init__(self, root: str, query_fp: str):
        self.root = os.path.join(root, query_fp)
        self.query_fp = query_fp
        self._gc_root = root
        # opening sweeps expired sibling trees, never this query's own
        sweep_expired(root, skip=query_fp)

    def _payload(self, key: str) -> str:
        return os.path.join(self.root, key)

    def _marker(self, key: str) -> str:
        return self._payload(key) + ".committed"

    def committed(self, key: str) -> bool:
        return os.path.exists(self._marker(key)) and os.path.isdir(self._payload(key))

    def _seal(self, staging: str, key: str) -> None:
        """Publish a staged payload directory and its commit marker."""
        payload = self._payload(key)
        if os.path.isdir(payload):
            # a stale payload of a crashed run (no marker), or a racing
            # duplicate of equal content: replace it
            shutil.rmtree(payload, ignore_errors=True)
        os.replace(staging, payload)
        tmp = self._marker(key) + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w"):
            pass
        os.replace(tmp, self._marker(key))
        try:
            # the sweep reads the query directory's age: refresh it
            os.utime(self.root)
        except OSError:
            pass
        sweep_expired(self._gc_root, skip=self.query_fp)

    # ---- shuffle stages ------------------------------------------------------------
    def commit_shuffle(self, key: str, shuffle_dir: str, shuffle_id: str,
                       expected: Dict[int, Tuple[int, ...]]) -> None:
        """Checkpoint a finished shuffle stage: its partition files (hard
        links where the file system allows) and the per-partition map
        manifest. Advisory: an I/O error skips the checkpoint and never
        fails the query."""
        staging = self._payload(key) + f".staging-{uuid.uuid4().hex[:8]}"
        try:
            src = os.path.join(shuffle_dir, shuffle_id)
            os.makedirs(os.path.dirname(staging) or ".", exist_ok=True)
            if os.path.isdir(src):
                shutil.copytree(src, staging, copy_function=_link_or_copy)
            else:
                os.makedirs(staging)
            with open(os.path.join(staging, _MANIFEST), "w") as f:
                json.dump({"kind": "shuffle",
                           "expected": {str(p): list(v) for p, v in expected.items()}}, f)
            self._seal(staging, key)
        except OSError:
            shutil.rmtree(staging, ignore_errors=True)
            registry().inc("checkpoint_commit_failures")
            return
        registry().inc("checkpoint_stages_committed")

    def restore_shuffle(self, key: str,
                        shuffle_dir: str) -> Optional[Tuple[str, Dict[int, tuple]]]:
        """A committed shuffle stage put back into ``shuffle_dir`` under a
        fresh shuffle id: (shuffle_id, expected maps per partition), or None
        when it is not committed or not readable."""
        if not self.committed(key):
            return None
        payload = self._payload(key)
        try:
            with open(os.path.join(payload, _MANIFEST)) as f:
                man = json.load(f)
            expected = {int(p): tuple(v) for p, v in man.get("expected", {}).items()}
            sid = f"ckpt{uuid.uuid4().hex[:12]}"
            dst_root = os.path.join(shuffle_dir, sid)
            for dirpath, _dirnames, filenames in os.walk(payload):
                rel = os.path.relpath(dirpath, payload)
                for name in filenames:
                    if name == _MANIFEST:
                        continue
                    dst_dir = os.path.join(dst_root, rel) if rel != "." else dst_root
                    os.makedirs(dst_dir, exist_ok=True)
                    _link_or_copy(os.path.join(dirpath, name), os.path.join(dst_dir, name))
            registry().inc("checkpoint_stages_skipped")
            return sid, expected
        except (OSError, ValueError, KeyError):
            registry().inc("checkpoint_restore_failures")
            return None

    # ---- results -------------------------------------------------------------------
    def commit_result(self, key: str, parts: List) -> None:
        """Checkpoint a result's partitions as Arrow IPC stream files, one a
        MicroPartition, batch boundaries kept. Advisory: an I/O error skips
        the checkpoint and never fails the query; the codec's own refusal
        ("zstd") is a configuration error and raises."""
        from ..config import execution_config
        from ..io.arrow_ipc import StreamWriter

        compression = execution_config().shuffle_compression
        staging = self._payload(key) + f".staging-{uuid.uuid4().hex[:8]}"
        try:
            os.makedirs(staging)
            rows = []
            for i, part in enumerate(parts):
                rows.append(part.num_rows)
                batches = [b for b in part.batches if b.num_rows > 0]
                if not batches:
                    continue
                with open(os.path.join(staging, f"part{i}.arrow"), "wb") as f, \
                        StreamWriter(f, part.schema, compression) as w:
                    for b in batches:
                        w.write(b)
            with open(os.path.join(staging, _MANIFEST), "w") as f:
                json.dump({"kind": "result", "parts": len(parts), "rows": rows}, f)
            self._seal(staging, key)
        except OSError:
            shutil.rmtree(staging, ignore_errors=True)
            registry().inc("checkpoint_commit_failures")
            return
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        registry().inc("checkpoint_stages_committed")

    def restore_result(self, key: str, schema) -> Optional[List]:
        """A committed result's partitions (cast onto ``schema``, the live
        plan's), or None when it is not committed or not readable."""
        if not self.committed(key):
            return None
        from ..core.micropartition import MicroPartition
        from ..io.arrow_ipc import decode_stream

        payload = self._payload(key)
        try:
            with open(os.path.join(payload, _MANIFEST)) as f:
                man = json.load(f)
            out: List = []
            for i in range(int(man["parts"])):
                path = os.path.join(payload, f"part{i}.arrow")
                if not os.path.exists(path):
                    out.append(MicroPartition(schema, []))
                    continue
                with open(path, "rb") as f:
                    out.append(MicroPartition(schema, decode_stream(f, schema)))
            registry().inc("checkpoint_stages_skipped")
            return out
        except (OSError, ValueError, KeyError, IndexError, struct.error, NotImplementedError):
            # unreadable or corrupt: the stage runs again
            registry().inc("checkpoint_restore_failures")
            return None
