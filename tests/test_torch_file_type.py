"""The lazy File type (daft_tpu_torch/filetype.py) against the reference's
(daft_tpu/filetype.py) over local files: ranged reads, seeks, size, name,
mime type, to_tempfile, equality; a remote URL raises NotImplementedError
(the object store is not ported)."""

import os

import numpy as np
import pytest

from daft_tpu import filetype as ref_ft
from daft_tpu_torch import filetype as port_ft
from daft_tpu_torch.functions import DaftFile, File


def _file(tmp_path, n=5000, name="blob.png"):
    p = os.path.join(tmp_path, name)
    with open(p, "wb") as f:
        f.write(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes())
    return p


@pytest.mark.parametrize("url_form", ["path", "file_url"])
def test_ranged_reads_and_seeks_equal_reference(tmp_path, url_form):
    p = _file(tmp_path)
    url = p if url_form == "path" else "file://" + p
    outs = []
    for ft in (ref_ft, port_ft):
        f = ft.File(url).open()
        got = [f.read(10), f.tell(), f.seek(100), f.read(7), f.seek(-5, os.SEEK_END),
               f.read(), f.read(), f.seek(3, os.SEEK_CUR), f.size(), f.readable(),
               f.seekable(), f.writable()]
        buf = bytearray(16)
        f.seek(1)
        got += [f.readinto(buf), bytes(buf)]
        outs.append(got)
    assert outs[0] == outs[1]


def test_file_surface_equals_reference(tmp_path):
    p = _file(tmp_path, 123, "a.wav")
    r, q = ref_ft.File(p), port_ft.File(p)
    assert (q.path, q.name, q.size(), q.mime_type(), q.read(), q.read(4), repr(q)) == \
        (r.path, r.name, r.size(), r.mime_type(), r.read(), r.read(4), repr(r))
    assert q == port_ft.File(p) and hash(q) == hash(port_ft.File(p)) and q != File(p + "x")
    with q.to_tempfile() as tmp:
        assert tmp.read() == r.read() and tmp.name.endswith(".wav")
    assert isinstance(q.open(), DaftFile)


def test_negative_seek_and_bad_whence_raise(tmp_path):
    f = File(_file(tmp_path)).open()
    with pytest.raises(ValueError):
        f.seek(-1)
    with pytest.raises(ValueError):
        f.seek(0, 7)


@pytest.mark.parametrize("url", ["s3://bucket/key", "https://example.com/x", "gs://b/k"])
def test_remote_files_raise_not_implemented(url):
    with pytest.raises(NotImplementedError, match="object store"):
        File(url).open()
