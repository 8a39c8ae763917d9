"""Audio, video and process functions (counterpart of
daft_tpu/functions/media.py): ``audio_metadata`` and ``audio_resample`` on
WAV through the standard library's ``wave`` and numpy (other codecs need
``soundfile``, as in the reference), ``video_metadata`` gated on ``av``
(PyAV) as the reference gates it, and ``run_process``.
"""

from __future__ import annotations

import io
import subprocess
from typing import Any, List, Optional

import numpy as np

from ..core.series import Series
from ..datatype import DataType
from .registry import _rt_const, register

AUDIO_META_STRUCT = DataType.struct({
    "sample_rate": DataType.int64(), "channels": DataType.int64(),
    "frames": DataType.float64(), "format": DataType.string(),
    "subtype": DataType.string(),
})


def _file_bytes(v, io_config=None) -> Optional[bytes]:
    """One file-column value's bytes: bytes, a file struct's data or its
    path read, a path read (media.py:30-46)."""
    from ..filetype import File

    if v is None:
        return None
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, dict):
        if v.get("data") is not None:
            return v["data"]
        return File(v["path"], io_config).read()
    if isinstance(v, str):
        return File(v, io_config).read()
    raise ValueError(f"cannot read audio from value of type {type(v).__name__}")


_WAV_SUBTYPES = {1: "PCM_8", 2: "PCM_16", 3: "PCM_24", 4: "PCM_32"}


def _wav_decode(data: bytes):
    """(samples float64 [frames, channels], sample rate, subtype)."""
    import wave

    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
    elif width == 2:
        arr = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        arr = vals.astype(np.float64) / float(1 << 23)
    elif width == 4:
        arr = np.frombuffer(raw, "<i4").astype(np.float64) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return arr.reshape(-1, nch), sr, _WAV_SUBTYPES.get(width, f"PCM_{8 * width}")


def _is_wav(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE"


def _soundfile():
    try:
        import soundfile as sf
    except ImportError as e:
        raise ImportError("non-WAV audio requires the 'soundfile' package "
                          "(WAV is handled natively)") from e
    return sf


def _audio_meta_one(data: bytes) -> dict:
    if _is_wav(data):
        samples, sr, subtype = _wav_decode(data)
        return {"sample_rate": sr, "channels": samples.shape[1],
                "frames": float(samples.shape[0]), "format": "WAV", "subtype": subtype}
    info = _soundfile().info(io.BytesIO(data))
    return {"sample_rate": int(info.samplerate), "channels": int(info.channels),
            "frames": float(info.frames), "format": info.format, "subtype": info.subtype}


def _audio_metadata_host(args: List[Series], kwargs) -> Series:
    io_config = kwargs.get("io_config")
    out = []
    for v in args[0].to_pylist():
        data = _file_bytes(v, io_config)
        out.append(None if data is None else _audio_meta_one(data))
    return Series.from_pylist(out, args[0].name, dtype=AUDIO_META_STRUCT)


register("audio_metadata", _rt_const(AUDIO_META_STRUCT), _audio_metadata_host)


def _linear_resample(samples: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target or samples.shape[0] == 0:
        return samples
    n_out = max(int(round(samples.shape[0] * target / sr)), 1)
    x_old = np.linspace(0.0, 1.0, samples.shape[0], endpoint=False)
    x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
    return np.stack([np.interp(x_new, x_old, samples[:, c])
                     for c in range(samples.shape[1])], axis=1)


def _audio_resample_host(args: List[Series], kwargs) -> Series:
    target = kwargs["sample_rate"]
    io_config = kwargs.get("io_config")
    out = []
    for v in args[0].to_pylist():
        data = _file_bytes(v, io_config)
        if data is None:
            out.append(None)
            continue
        if _is_wav(data):
            samples, sr, _sub = _wav_decode(data)
        else:
            samples, sr = _soundfile().read(io.BytesIO(data), always_2d=True)
        out.append(_linear_resample(samples, sr, target))
    return Series.from_pylist(out, args[0].name, dtype=DataType.python())


register("audio_resample", lambda f, k: DataType.python(), _audio_resample_host)


VIDEO_META_STRUCT = DataType.struct({
    "width": DataType.int64(), "height": DataType.int64(),
    "fps": DataType.float64(), "frames": DataType.int64(),
    "duration_s": DataType.float64(), "codec": DataType.string(),
})


def _video_gate():
    try:
        import av  # noqa: F401
    except ImportError as e:
        raise ImportError("video functions require the 'av' package (PyAV)") from e


def _video_metadata_host(args: List[Series], kwargs) -> Series:
    _video_gate()
    import av

    io_config = kwargs.get("io_config")
    out = []
    for v in args[0].to_pylist():
        data = _file_bytes(v, io_config)
        if data is None:
            out.append(None)
            continue
        with av.open(io.BytesIO(data)) as c:
            vs = c.streams.video[0]
            out.append({"width": vs.width, "height": vs.height,
                        "fps": float(vs.average_rate or 0), "frames": vs.frames,
                        "duration_s": float((vs.duration or 0) * vs.time_base),
                        "codec": vs.codec_context.name})
    return Series.from_pylist(out, args[0].name, dtype=VIDEO_META_STRUCT)


register("video_metadata", _rt_const(VIDEO_META_STRUCT), _video_metadata_host)


def run_process(args, *, shell: bool = False, on_error: str = "log",
                return_dtype: Optional[DataType] = None):
    """Run an external process per row; its stdout is the row's value
    (media.py:192-238). Bare values are literals; only Expressions read
    columns."""
    from ..expressions.expressions import Expression, Literal
    from ..udf import udf

    dt = return_dtype or DataType.string()
    if not isinstance(args, (list, tuple)):
        args = [args]
    exprs = [a if isinstance(a, Expression) else Literal(a) for a in args]

    @udf(return_dtype=dt)
    def _run(*cols):
        n = max(len(c) for c in cols)
        pycols = [c.to_pylist() for c in cols]
        pycols = [c * n if len(c) == 1 and n != 1 else c for c in pycols]
        out: List[Any] = []
        for row in zip(*pycols):
            argv = [str(a) for a in row]
            try:
                if shell:
                    res = subprocess.run(" ".join(argv), shell=True, capture_output=True,
                                         text=True, check=True)
                else:
                    res = subprocess.run(argv, capture_output=True, text=True, check=True)
                val = res.stdout
                if dt.is_integer():
                    val = int(val.strip())
                elif dt.is_floating():
                    val = float(val.strip())
                out.append(val)
            except Exception as e:
                if on_error == "raise":
                    raise
                if on_error == "log":
                    import logging

                    logging.getLogger(__name__).warning("run_process failed: %s", e)
                out.append(None)
        return out

    return _run(*exprs)
