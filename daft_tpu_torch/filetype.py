"""The lazy File type (counterpart of daft_tpu/filetype.py): a file
reference whose bytes are read on demand, in ranges.

A ``File`` is only its path until opened; ``open()`` gives a seekable
read-only file object whose every read reads exactly the span asked for.
The port reads local files (a path or a ``file://`` URL); a remote URL,
which the reference hands to its object store, raises as the port's
``expand_paths`` does (io/paths.py), since the object store is not ported.
"""

from __future__ import annotations

import io
import mimetypes
import os
from typing import Optional

from .io.paths import _REMOTE_SCHEMES


def local_path(url: str) -> str:
    """The local path of ``url``: a ``file://`` URL's path, a plain path as
    it is; a remote URL raises ``NotImplementedError``."""
    if url.startswith(_REMOTE_SCHEMES):
        raise NotImplementedError(f"remote path {url!r}: the object store is not ported yet")
    return url[len("file://"):] if url.startswith("file://") else url


class DaftFile(io.RawIOBase):
    """Seekable read-only file over a local path: each read reads exactly
    the requested span (filetype.py:19-79)."""

    def __init__(self, url: str, io_config=None):
        super().__init__()
        self._url = url
        self._path = local_path(url)
        self._pos = 0
        self._size: Optional[int] = None

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self.size() + offset
        else:
            raise ValueError(f"invalid whence {whence}")
        if self._pos < 0:
            raise ValueError("negative seek position")
        return self._pos

    def size(self) -> int:
        if self._size is None:
            self._size = os.path.getsize(self._path)
        return self._size

    def read(self, n: int = -1) -> bytes:
        size = self.size()
        if self._pos >= size:
            return b""
        end = size if n is None or n < 0 else min(self._pos + n, size)
        if end <= self._pos:
            return b""
        with open(self._path, "rb") as f:
            f.seek(self._pos)
            data = f.read(end - self._pos)
        self._pos = end
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class File:
    """A lazy file reference (filetype.py:82-139): carries only (url,
    io_config); bytes move when ``open()`` / ``read()`` ask for them."""

    __slots__ = ("_url", "_io_config")

    def __init__(self, url: str, io_config=None):
        self._url = url
        self._io_config = io_config

    def open(self) -> DaftFile:
        return DaftFile(self._url, self._io_config)

    @property
    def path(self) -> str:
        return self._url

    @property
    def name(self) -> str:
        return os.path.basename(self._url.rstrip("/"))

    def size(self) -> int:
        return self.open().size()

    def mime_type(self) -> str:
        guess, _ = mimetypes.guess_type(self._url)
        return guess or "application/octet-stream"

    def read(self, n: int = -1) -> bytes:
        with self.open() as f:
            return f.read(n)

    def to_tempfile(self):
        """A NamedTemporaryFile holding the contents (for libraries that
        need a real path)."""
        import shutil
        import tempfile

        tmp = tempfile.NamedTemporaryFile(suffix=os.path.splitext(self.name)[1])
        with self.open() as src:
            shutil.copyfileobj(src, tmp)
        tmp.flush()
        tmp.seek(0)
        return tmp

    def __repr__(self) -> str:
        return f"File({self._url!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, File) and other._url == self._url

    def __hash__(self) -> int:
        return hash(self._url)
