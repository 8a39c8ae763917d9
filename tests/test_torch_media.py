"""Audio, video and process functions (daft_tpu_torch/functions/media.py)
against the reference's (daft_tpu/functions/media.py), on the same seeded
WAV files written with ``wave``: ``audio_metadata`` bit for bit (as bytes,
paths and file structs), ``audio_resample`` at rtol 1e-12, non-WAV audio
raising the reference's ImportError naming soundfile (neither machine has
it), ``video_metadata`` gated on av as the reference gates it, and
``run_process``."""

import io
import os
import sys
import wave

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import col
from daft_tpu_torch.functions import run_process

SEED = 3131


def _wav(width, channels, rate, frames, seed):
    rng = np.random.default_rng(seed)
    b = io.BytesIO()
    with wave.open(b, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(rng.integers(0, 256, frames * channels * width, dtype=np.uint8)
                      .tobytes())
    return b.getvalue()


WAVS = [_wav(w, c, r, f, i) for i, (w, c, r, f) in enumerate(
    [(1, 1, 8000, 400), (2, 2, 44100, 1000), (3, 1, 22050, 333), (4, 2, 16000, 250),
     (2, 1, 48000, 0)])]


def _both(query, data):
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, daft_tpu.col, daft_tpu.from_pydict(data)).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = query(daft_tpu_torch, col, daft_tpu_torch.from_pydict(data)).to_pydict()
    return got, want


def test_audio_metadata_of_bytes_equals_reference():
    got, want = _both(lambda m, c, df: df.select(c("a")._fn("audio_metadata").alias("m")),
                      {"a": WAVS + [None]})
    assert got == want
    assert got["m"][1]["subtype"] == "PCM_16" and got["m"][-1] is None


def test_audio_metadata_of_paths_and_files_equals_reference(tmp_path):
    paths = []
    for i, data in enumerate(WAVS):
        p = os.path.join(tmp_path, f"{i}.wav")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    got, want = _both(lambda m, c, df: df.select(
        c("p")._fn("audio_metadata").alias("a"),
        c("p")._fn("file")._fn("audio_metadata").alias("b")), {"p": paths})
    assert got == want


@pytest.mark.parametrize("rate", [8000, 16000, 44100])
def test_audio_resample_equals_reference(rate):
    with ref_ctx(device_mode="off"):
        want = daft_tpu.from_pydict({"a": WAVS + [None]}).select(
            daft_tpu.col("a")._fn("audio_resample", sample_rate=rate).alias("r")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict({"a": WAVS + [None]}).select(
            col("a")._fn("audio_resample", sample_rate=rate).alias("r")).to_pydict()
    for g, w in zip(got["r"], want["r"]):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_non_wav_audio_needs_soundfile():
    pytest.importorskip("daft_tpu")
    try:
        import soundfile  # noqa: F401
        pytest.skip("soundfile is installed: the reference decodes non-WAV audio")
    except ImportError:
        pass
    for fn, kw in (("audio_metadata", {}), ("audio_resample", {"sample_rate": 8000})):
        with daft_tpu_torch.execution_config_ctx(device="cpu"), \
                pytest.raises(ImportError, match="soundfile"):
            daft_tpu_torch.from_pydict({"a": [b"fLaC not wav"]}).select(
                col("a")._fn(fn, **kw)).to_pydict()


def test_video_metadata_is_gated_on_av():
    try:
        import av  # noqa: F401
        pytest.skip("av is installed")
    except ImportError:
        pass
    with daft_tpu_torch.execution_config_ctx(device="cpu"), \
            pytest.raises(ImportError, match="'av'"):
        daft_tpu_torch.from_pydict({"v": [b"\x00\x00"]}).select(
            col("v")._fn("video_metadata")).to_pydict()


def test_run_process_equals_reference():
    data = {"x": ["a", "bb", None]}
    py = sys.executable

    def q(m, c, df):
        rp = daft_tpu.functions.run_process if m is daft_tpu else run_process
        return df.select(
            rp([py, "-c", "import sys; print(len(sys.argv[1]))", c("x")],
               return_dtype=m.DataType.int64()).alias("n"),
            rp(["echo", c("x")], shell=True).alias("e"),
            rp([py, "-c", "import sys; sys.exit(3)"], on_error="null").alias("f"))
    got, want = _both(q, data)
    assert got == want
    assert got["n"] == [1, 2, 4]
