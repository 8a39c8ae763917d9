"""The ingest formats at a small size on the card: a JSONL manifest of
JPEG files (the port's JPEG codec), a gzipped WARC file tokenized with
the committed BPE file (the tokenizer-file reader) and a text file, each
scan feeding the grouped stage on the card. Marked ``cuda``: skipped where
no card is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ingest.py

Each query launches the grouped stage's kernels and equals its host path:
keys and counts bit for bit, float aggregates within rtol 1e-5.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.core.kernels import jpeg
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.ops import counters

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "tests", "data", "w1_tokenizer.json")


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


def _on_and_off(query):
    manager().clear()
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        counters.reset()
        on = query().to_pydict()
        assert counters.device_grouped_batches >= 1
        assert counters.launches_segment_sum_planes >= 1
    with dt.execution_config_ctx(device="cuda", device_mode="off"):
        off = query().to_pydict()
    return on, off


def _same(on, off, floats=()):
    assert list(on) == list(off)
    for k in on:
        if k in floats:
            for a, b in zip(on[k], off[k]):
                assert (a is None and b is None) or a == pytest.approx(b, rel=1e-5)
        else:
            assert on[k] == off[k], k


def test_jpeg_manifest_on_the_card(tmp_path):
    rng = np.random.default_rng(25)
    rows = []
    for i in range(64):
        h, w = (int(v) for v in rng.integers(16, 96, 2))
        px = rng.integers(0, 256, (h, w, 3 if i % 5 else 1), dtype=np.uint8)
        data = jpeg.encode_jpeg(px, quality=(75, 85, 95)[i % 3])
        p = os.path.join(tmp_path, f"{i}.jpg")
        with open(p, "wb") as f:
            f.write(data if i % 13 else data[:40])
        rows.append({"path": p, "label": i % 7})
    with open(os.path.join(tmp_path, "m.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)

    def query():
        df = dt.read_json(os.path.join(tmp_path, "m.jsonl"))
        df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
        df = df.with_column("m", col("img").image.to_fixed_shape("L", 8, 8)
                            .cast(dt.DataType.list(dt.DataType.uint8())).list.mean())
        return df.groupby("label").agg(col("m").count().alias("n"),
                                       col("m").mean().alias("mean")).sort("label")

    on, off = _on_and_off(query)
    _same(on, off, ("mean",))
    assert sum(on["n"]) == 64 - 5


def test_warc_tokens_on_the_card(tmp_path):
    path = os.path.join(tmp_path, "a.warc.gz")
    with open(path, "wb") as f:
        for i in range(40):
            body = ("пример text %d 中文 " % i).encode() * (1 + i % 9)
            f.write(gzip.compress(
                b"WARC/1.0\r\nWARC-Type: response\r\nWARC-Target-URI: http://h%d.org/x\r\n"
                b"Content-Length: %d\r\n\r\n" % (i % 6, len(body)) + body + b"\r\n\r\n"))

    def query():
        df = dt.read_warc(path)
        df = df.with_column("host", col("warc_target_uri").str.extract(r"^https?://([^/]+)", 1))
        df = df.with_column("n", col("content").tokenize_encode(TOKENIZER).list.length()
                            .cast(dt.DataType.int64()))
        return df.groupby("host").agg(col("n").sum().alias("tokens"),
                                      col("content_length").mean().alias("len")).sort("host")

    on, off = _on_and_off(query)
    _same(on, off, ("len",))
    assert len(on["host"]) == 6


def test_text_lines_on_the_card(tmp_path):
    path = os.path.join(tmp_path, "a.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("\n".join("w" * (i % 11) for i in range(5000)))

    def query():
        df = dt.read_text(path).with_column("k", col("text").str.length()
                                            .cast(dt.DataType.int64()))
        return df.groupby("k").agg(col("k").count().alias("n")).sort("k")

    on, off = _on_and_off(query)
    _same(on, off)
