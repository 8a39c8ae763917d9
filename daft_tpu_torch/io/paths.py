"""Path expansion: globs, directories, lists (counterpart of
daft_tpu/io/paths.py, the local-filesystem part; remote paths, which the
reference hands to its object store, are not ported yet and raise)."""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Sequence, Union

_REMOTE_SCHEMES = ("s3://", "s3a://", "gs://", "gcs://", "az://", "abfs://", "abfss://",
                   "http://", "https://", "hf://")


def expand_paths(path: Union[str, List[str]], extensions: Sequence[str] = ()) -> List[str]:
    """Every file ``path`` names, in the reference's order: a glob's matches
    sorted, a directory walked top-down with each directory's files sorted
    (those ending in ``extensions``), a plain path as given; duplicates
    dropped, first occurrence kept. Row order without a sort follows it."""
    paths = [path] if isinstance(path, str) else list(path)
    out: List[str] = []
    for p in paths:
        if p.startswith(_REMOTE_SCHEMES):
            raise NotImplementedError(f"remote path {p!r}: the object store is not ported "
                                      "yet")
        if p.startswith("file://"):
            p = p[len("file://"):]
        if any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p, recursive=True)))
        elif os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if not extensions or f.endswith(tuple(extensions)):
                        out.append(os.path.join(root, f))
        else:
            out.append(p)
    seen = set()
    uniq = []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq
