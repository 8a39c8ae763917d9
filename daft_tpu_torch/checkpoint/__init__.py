"""Checkpoint / resume for write pipelines (counterpart of
daft_tpu/checkpoint/__init__.py).

The reference's model (src/daft-checkpoint/src/store.rs:10-50): a CheckpointStore
tracks processed source keys and produced files through a
``staged -> checkpointed -> committed`` lifecycle:

- stage_keys/stage_files accumulate under a CheckpointId (invisible to readers)
- checkpoint() seals them atomically (keys drive skip-on-rerun; files drive
  2PC catalog commits)
- mark_committed() records the external commit; files drop out of
  get_checkpointed_files but keys stay visible for skip-on-rerun

Engine hook: DataFrame.write_parquet accepts checkpoint=(store, key_column)
(io/writers.py); the sink stages each batch's key values, seals on success,
and a rerun of the same pipeline filters rows whose keys were already
checkpointed (the reference's intermediate_ops/stage_checkpoint_keys.rs).
Stage checkpoints of whole query results are checkpoint/stages.py.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Sequence, Set


class CheckpointStore:
    """Store ABC. Implementations must be safe for concurrent staging."""

    def stage_keys(self, checkpoint_id: str, keys: Sequence) -> None:
        raise NotImplementedError

    def stage_files(self, checkpoint_id: str, files: Sequence[str]) -> None:
        raise NotImplementedError

    def checkpoint(self, checkpoint_id: str) -> None:
        """Seal: staged keys+files become visible atomically."""
        raise NotImplementedError

    def mark_committed(self, checkpoint_id: str) -> None:
        raise NotImplementedError

    def get_checkpointed_keys(self) -> Set:
        """Keys from every sealed checkpoint (committed or not)."""
        raise NotImplementedError

    def get_checkpointed_files(self) -> List[str]:
        """Files from sealed-but-uncommitted checkpoints (2PC recovery set)."""
        raise NotImplementedError


class MemoryCheckpointStore(CheckpointStore):
    """In-memory store (reference: impls/memory.rs)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._staged_keys: Dict[str, list] = {}
        self._staged_files: Dict[str, list] = {}
        self._sealed_keys: Dict[str, list] = {}
        self._sealed_files: Dict[str, list] = {}
        self._committed: Set[str] = set()

    def stage_keys(self, checkpoint_id: str, keys: Sequence) -> None:
        with self._lock:
            self._staged_keys.setdefault(checkpoint_id, []).extend(keys)

    def stage_files(self, checkpoint_id: str, files: Sequence[str]) -> None:
        with self._lock:
            self._staged_files.setdefault(checkpoint_id, []).extend(files)

    def checkpoint(self, checkpoint_id: str) -> None:
        with self._lock:
            self._sealed_keys[checkpoint_id] = self._staged_keys.pop(checkpoint_id, [])
            self._sealed_files[checkpoint_id] = self._staged_files.pop(checkpoint_id, [])

    def mark_committed(self, checkpoint_id: str) -> None:
        with self._lock:
            if checkpoint_id not in self._sealed_keys:
                raise ValueError(f"checkpoint {checkpoint_id!r} is not sealed")
            self._committed.add(checkpoint_id)

    def get_checkpointed_keys(self) -> Set:
        with self._lock:
            out: Set = set()
            for ks in self._sealed_keys.values():
                out.update(ks)
            return out

    def get_checkpointed_files(self) -> List[str]:
        with self._lock:
            return [f for cid, fs in self._sealed_files.items()
                    if cid not in self._committed for f in fs]


class FileCheckpointStore(CheckpointStore):
    """Durable JSONL-backed store: survives process restarts, so an
    interrupted write pipeline resumes where it sealed its last checkpoint."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._mem = MemoryCheckpointStore()
        self._lock = threading.Lock()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["op"] == "seal":
                        self._mem._sealed_keys[rec["id"]] = rec["keys"]
                        self._mem._sealed_files[rec["id"]] = rec["files"]
                    elif rec["op"] == "commit":
                        self._mem._committed.add(rec["id"])

    def stage_keys(self, checkpoint_id: str, keys: Sequence) -> None:
        self._mem.stage_keys(checkpoint_id, keys)

    def stage_files(self, checkpoint_id: str, files: Sequence[str]) -> None:
        self._mem.stage_files(checkpoint_id, files)

    def checkpoint(self, checkpoint_id: str) -> None:
        with self._lock:
            keys = self._mem._staged_keys.get(checkpoint_id, [])
            files = self._mem._staged_files.get(checkpoint_id, [])
            # the lock orders the log's appends with the in-memory state
            with open(self.path, "a") as f:
                f.write(json.dumps({"op": "seal", "id": checkpoint_id,
                                    "keys": list(keys), "files": list(files)}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._mem.checkpoint(checkpoint_id)

    def mark_committed(self, checkpoint_id: str) -> None:
        with self._lock:
            self._mem.mark_committed(checkpoint_id)
            # commit records serialize after seal records
            with open(self.path, "a") as f:
                f.write(json.dumps({"op": "commit", "id": checkpoint_id}) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def get_checkpointed_keys(self) -> Set:
        return self._mem.get_checkpointed_keys()

    def get_checkpointed_files(self) -> List[str]:
        return self._mem.get_checkpointed_files()
