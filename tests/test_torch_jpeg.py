"""The port's JPEG codec (core/kernels/jpeg.py, the host library's JPEG
exports) against PIL, which the reference's image kernels ask
(daft_tpu/core/kernels/image.py:82-128), on the same bytes:

- decode, by the library and by the plain versions
  (``DAFT_TPU_DISABLE_NATIVE``), bit for bit to PIL's pixels: baseline
  4:4:4, 4:2:2, 4:2:0, 4:1:1 and gray, progressive, restart intervals, odd
  sizes (1 x 1, 17 x 9, 641 x 479), quality 95 and 16-bit tables, CMYK
  with the Adobe marker; a JPEG cut short or bytes of no JPEG raise an
  OSError as PIL's do, and give null under on_error="null";
- arithmetic-coded, 12-bit and lossless frames raise NotImplementedError
  under either on_error;
- encode: PIL's decode of the port's bytes equals PIL's decode of PIL's
  own bytes for the same pixels, RGB and L, 8 x 8 to 333 x 217, at
  qualities 75, 85, 95 and 4:2:0, 4:2:2, 4:4:4 (the bytes themselves
  equal PIL's for RGB);
- each JPEG export of the host library equal to its plain version;
- ``image.decode`` (every target mode, a CMYK source) and ``encode``
  through a DataFrame equal to the reference's;
- the committed fixtures of tests/data/jpeg are still PIL's.

The JPEGs are written at test time from numpy seeds: by PIL, and, for
4:1:1, which PIL does not write, by the port's encoder (its pixels are
then held to PIL's decode of the same bytes).
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.core.kernels import image as ref_image
from daft_tpu_torch import col, native
from daft_tpu_torch.core.kernels import image as port_image
from daft_tpu_torch.core.kernels import jpeg
from daft_tpu_torch.core.kernels.png import ImageDecodeError

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

SEED = 2025
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def _pixels(h, w, c, seed=SEED):
    """A smooth seeded image with noise: what a photo's blocks look like."""
    rng = np.random.default_rng([seed, h, w, c])
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / (6.0 + k)) * 60 + np.cos(y / (5.0 + k)) * 55 + 128
                    for k in range(c)], axis=2) + rng.normal(0, 14, (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def _pil_jpeg(px, mode=None, **opts) -> bytes:
    b = io.BytesIO()
    Image.fromarray(px, mode).save(b, "JPEG", **opts)
    return b.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _decode(data: bytes, plain: bool, monkeypatch):
    if plain:
        monkeypatch.setenv(native.DISABLE_ENV, "1")
    try:
        return jpeg.decode_jpeg(data)
    finally:
        monkeypatch.delenv(native.DISABLE_ENV, raising=False)


# (height, width) x (name, channels, options)
SIZES = [(1, 1), (17, 9), (48, 64), (641, 479)]
KINDS = [
    ("baseline_420", 3, {}),
    ("baseline_422", 3, {"subsampling": 1}),
    ("baseline_444", 3, {"subsampling": 0}),
    ("gray", 1, {}),
    ("progressive_420", 3, {"progressive": True}),
    ("progressive_444", 3, {"progressive": True, "subsampling": 0}),
    ("progressive_gray", 1, {"progressive": True}),
    ("restart_blocks", 3, {"restart_marker_blocks": 3}),
    ("progressive_restart_rows", 3, {"progressive": True, "restart_marker_rows": 1}),
    ("quality95", 3, {"quality": 95}),
]


@pytest.mark.parametrize("plain", [False, True], ids=["library", "plain"])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_equals_pil(size, kind, plain, monkeypatch):
    h, w = size
    if plain and h * w > 100_000 and kind[0] not in ("baseline_420", "progressive_420"):
        size = (h // 4, w // 4)  # the plain Huffman loop: the large size once a family
        h, w = size
    _name, c, opts = kind
    data = _pil_jpeg(_pixels(h, w, c), **opts)
    got = _decode(data, plain, monkeypatch)
    want = _pil_pixels(data)
    assert got.mode == Image.open(io.BytesIO(data)).mode
    assert got.pixels.shape == want.shape
    assert np.array_equal(got.pixels, want)


@pytest.mark.parametrize("plain", [False, True], ids=["library", "plain"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (33, 70), (96, 200)])
def test_decode_411_equals_pil(size, plain, monkeypatch):
    """4:1:1 (h4v1 luma: jdsample.c replicates the chroma 4 times across),
    written by the port's encoder since PIL does not write it."""
    data = jpeg.encode_jpeg(_pixels(*size, 3), subsampling="4:1:1")
    assert Image.open(io.BytesIO(data)).layer[0][1:3] == (4, 1)
    assert np.array_equal(_decode(data, plain, monkeypatch).pixels, _pil_pixels(data))


@pytest.mark.parametrize("plain", [False, True], ids=["library", "plain"])
@pytest.mark.parametrize("size", [(1, 1), (19, 33), (64, 48)])
def test_decode_cmyk_adobe_equals_pil(size, plain, monkeypatch):
    data = _pil_jpeg(_pixels(*size, 4), "CMYK")
    assert b"Adobe" in data
    got = _decode(data, plain, monkeypatch)
    assert got.mode == "CMYK"
    assert np.array_equal(got.pixels, _pil_pixels(data))


def test_decode_16bit_tables_equals_pil():
    """Quality 1 past force_baseline: tables above 255 are written 16-bit."""
    px = _pixels(40, 56, 3)
    tables = [list(range(200, 264)), [300] * 64]
    data = _pil_jpeg(px, qtables=tables)
    assert np.array_equal(jpeg.decode_jpeg(data).pixels, _pil_pixels(data))


def _mutate_sof(data: bytes, marker: bytes, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i] + marker + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


@pytest.mark.parametrize("on_error", ["raise", "null"])
@pytest.mark.parametrize("variant,match", [
    (b"\xff\xc9", "arithmetic"), (b"\xff\xca", "arithmetic"), (b"\xff\xc3", "lossless"),
    (b"\xff\xc5", "hierarchical"), (b"12bit", "12-bit")])
def test_deferred_variants_raise_under_either_on_error(variant, match, on_error):
    data = _pil_jpeg(_pixels(16, 16, 3))
    data = _mutate_sof(data, b"\xff\xc0", 12) if variant == b"12bit" \
        else _mutate_sof(data, variant)
    series = daft_tpu_torch.Series.from_pylist([data], "b", daft_tpu_torch.DataType.binary())
    with pytest.raises(NotImplementedError, match=match):
        port_image.decode(series, on_error=on_error)


def _bad_blobs():
    data = _pil_jpeg(_pixels(40, 50, 3))
    rng = np.random.default_rng(SEED)
    return {
        "cut_in_scan": data[:len(data) // 2],
        "cut_before_eoi": data[:-2],
        "cut_in_header": data[:100],
        "soi_then_noise": b"\xff\xd8\xff" + rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
        "noise": rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", list(_bad_blobs()))
def test_bad_bytes_raise_oserror_as_pil_and_null_under_null(name):
    blob = _bad_blobs()[name]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(blob)).load()
    port = daft_tpu_torch.Series.from_pylist([blob, None], "b",
                                             daft_tpu_torch.DataType.binary())
    ref = daft_tpu.Series.from_pylist([blob, None], "b", daft_tpu.DataType.binary())
    with pytest.raises(OSError):
        ref_image.decode(ref, on_error="raise")
    with pytest.raises(OSError) as err:
        port_image.decode(port, on_error="raise")
    assert isinstance(err.value, (ImageDecodeError, ValueError))
    assert port_image.decode(port, on_error="null").to_pylist() == \
        ref_image.decode(ref, on_error="null").to_pylist() == [None, None]


ENCODE_SIZES = [(8, 8), (1, 1), (17, 9), (9, 17), (64, 64), (333, 217), (217, 333)]


@pytest.mark.parametrize("quality,subsampling", [(75, "4:2:0"), (85, "4:4:4"),
                                                 (95, "4:2:0"), (75, "4:2:2")])
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("size", ENCODE_SIZES, ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
def test_encode_decodes_as_pils_own(size, channels, quality, subsampling):
    px = _pixels(*size, channels)
    ours = jpeg.encode_jpeg(px, quality=quality, subsampling=subsampling)
    theirs = _pil_jpeg(px, quality=quality, subsampling=subsampling)
    assert np.array_equal(_pil_pixels(ours), _pil_pixels(theirs))
    if channels == 3:
        assert ours == theirs


def test_encode_plain_equals_library(monkeypatch):
    px = _pixels(45, 61, 3)
    lib = jpeg.encode_jpeg(px)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert jpeg.encode_jpeg(px) == lib


def test_encode_noise_and_defaults_equal_pils_bytes():
    px = np.random.default_rng(SEED).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    assert jpeg.encode_jpeg(px) == _pil_jpeg(px)


def test_standard_tables_are_pils():
    """The DQT and DHT segments the writer emits are those of PIL's file."""
    data = _pil_jpeg(_pixels(16, 16, 3))
    assert jpeg._headers(16, 16, [(2, 2), (1, 1), (1, 1)],
                         [jpeg.quant_table(jpeg.STD_LUMA_Q, 75),
                          jpeg.quant_table(jpeg.STD_CHROMA_Q, 75)]) in data


@pytest.mark.parametrize("seed", range(3))
def test_jpeg_exports_equal_their_plain_versions(seed, monkeypatch):
    rng = np.random.default_rng([SEED, seed])
    coefs = np.zeros((5 * 7, 64), dtype=np.int16)
    coefs[:, :10] = rng.integers(-60, 60, (35, 10))
    coefs[:, 0] = rng.integers(-900, 900, 35)
    qt = rng.integers(1, 80, 64).astype(np.uint16)
    plane = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    planes = [rng.integers(0, 256, (9, 11), dtype=np.uint8) for _ in range(4)]
    cases = [("idct", lambda: native.jpeg_idct(coefs, 7, 6, 5, qt))]
    for dw, dh, hf, vf in ((21, 17, 2, 2), (2, 9, 2, 2), (13, 8, 2, 1), (2, 5, 2, 1),
                           (13, 8, 1, 2), (5, 9, 4, 1), (7, 3, 1, 1)):
        cases.append((f"upsample{dw}x{dh}/{hf}{vf}",
                      lambda a=(dw, dh, hf, vf): native.jpeg_upsample(
                          plane, a[0], a[1], a[2], a[3], a[0] * a[2] - 1, a[1] * a[3] - 1)))
    for space in (0, 1, 2, 3):
        cases.append((f"color{space}", lambda s=space: native.jpeg_color(
            planes[:native.JPEG_SPACE_CHANNELS[s]], s)))
    samples = rng.integers(0, 256, (24, 40), dtype=np.uint8)
    samples[:8] = 255 * (np.arange(40) % 2)  # the extremes
    for quality in (1, 50, 75, 95, 100):
        q = jpeg.quantizer(jpeg.quant_table(jpeg.STD_LUMA_Q, quality))
        cases.append((f"fdct_quant{quality}",
                      lambda q=q: native.jpeg_fdct_quant(samples, q)))
    rgb = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    for comp, hf, vf, max_v in ((0, 1, 1, 2), (1, 2, 2, 2), (2, 2, 2, 2), (1, 2, 1, 1),
                                (2, 4, 1, 1), (0, 1, 1, 1)):
        bw = -(-21 // (8 * hf))
        cases.append((f"plane{comp}/{hf}{vf}", lambda a=(comp, hf, vf, max_v, bw):
                      native.jpeg_component_plane(rgb, a[0], a[1], a[2], a[3], a[4], 3)))
    cases.append(("plane_gray", lambda: native.jpeg_component_plane(rgb[:, :, 0], 0, 1, 1, 1,
                                                                    3, 2)))
    blocks = rng.integers(-40, 40, (6, 64)).astype(np.int16)
    blocks[:, 20:] = 0
    params = np.array([1, 2, 3, 0, 2, 1, 1, 0, 0], np.int32)
    cases.append(("encode_scan", lambda: native.jpeg_encode_scan(blocks, params, jpeg._EHUF)))
    for name, fn in cases:
        lib = fn()
        monkeypatch.setenv(native.DISABLE_ENV, "1")
        plain = fn()
        monkeypatch.delenv(native.DISABLE_ENV)
        if isinstance(lib, bytes):
            assert lib == plain, name
        else:
            assert lib.shape == plain.shape and np.array_equal(lib, plain), name


def test_decode_scan_export_counts_library_calls():
    before = native.CALLS["jpeg_decode_scan"]
    jpeg.decode_jpeg(_pil_jpeg(_pixels(16, 16, 3), progressive=True))
    assert native.CALLS["jpeg_decode_scan"] > before + 1  # one call a scan


def test_committed_fixtures_are_pils_and_decode_both_ways(monkeypatch):
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    assert len(expected) >= 6
    total = 0
    for name, want in sorted(expected.items()):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        px = _pil_pixels(data)
        assert [list(px.shape), Image.open(io.BytesIO(data)).mode,
                hashlib.sha256(px.tobytes()).hexdigest()] == \
            [want["shape"], want["mode"], want["sha256"]], name
        for plain in (False, True):
            got = _decode(data, plain, monkeypatch)
            assert got.mode == want["mode"] and np.array_equal(got.pixels, px), (name, plain)
    assert total < 300_000


def _blobs():
    rng = np.random.default_rng(SEED + 1)
    out = []
    for i, (h, w) in enumerate([(20, 30), (31, 17), (8, 8), (45, 40)]):
        c = (3, 1, 3, 4)[i]
        mode = {1: None, 3: None, 4: "CMYK"}[c]
        opts = {"progressive": True} if i == 2 else {}
        out.append(_pil_jpeg(_pixels(h, w, c, seed=int(rng.integers(1 << 30))), mode, **opts))
    out.append(None)
    out.append(b"garbage bytes of no image")
    return out


@pytest.mark.parametrize("mode", [None, "L", "LA", "RGB", "RGBA"])
def test_image_decode_through_a_frame_equals_reference(mode):
    blobs = _blobs()
    want = daft_tpu.from_pydict({"b": blobs}).select(
        daft_tpu.col("b").image.decode(mode=mode, on_error="null").alias("i")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict({"b": blobs}).select(
            col("b").image.decode(mode=mode, on_error="null").alias("i")).to_pydict()
    assert got == want


def test_image_encode_jpeg_through_a_frame_equals_reference():
    """The reference's JPEG bytes are PIL's; the port's decode back to
    PIL's pixels of them (and are the same bytes for RGB)."""
    imgs = [_pixels(20, 30, 3), _pixels(9, 13, 1), None]
    want = daft_tpu.from_pydict({"b": [None if x is None else _pil_jpeg(x) for x in imgs]}) \
        .select(daft_tpu.col("b").image.decode().image.encode("JPEG").alias("j")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict(
            {"b": [None if x is None else _pil_jpeg(x) for x in imgs]}).select(
            col("b").image.decode().image.encode("JPG").alias("j")).to_pydict()
    assert [g is None for g in got["j"]] == [w is None for w in want["j"]]
    for g, w in zip(got["j"], want["j"]):
        if g is not None:
            assert np.array_equal(_pil_pixels(g), _pil_pixels(w))
    assert got["j"][0] == want["j"][0]
