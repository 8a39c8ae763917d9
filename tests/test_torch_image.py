"""The image kernels against the reference (daft_tpu/core/kernels/image.py,
which asks PIL and cv2), on the same seeded inputs:

- PNG decode bit for bit for every colour type and bit depth, a palette
  with tRNS, every row filter and Adam7 interlacing, with the default
  target mode and each explicit one (L, LA, RGB, RGBA);
- PNG encode: a round trip through both decoders, bit for bit;
- resize bit for bit on downscales (cv2's INTER_LINEAR, uint8), within 1
  on upscales with under 2 % of the values unequal (the share stated);
- crop, the mode conversions among L, LA, RGB and RGBA, to_fixed_shape,
  the accessors and image_hash bit for bit;
- bytes of no image are null under on_error="null" and raise under
  "raise"; GIF, BMP, TIFF and WebP bytes, and an arithmetic-coded JPEG,
  raise NotImplementedError under both; encode to JPEG refuses the modes
  PIL refuses (tests/test_torch_jpeg.py holds the JPEG codec itself);
- the PNG unfiltering export equals its plain version.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.core.kernels import image as ref_image
from daft_tpu_torch import col, native
from daft_tpu_torch.core.kernels import image as port_image
from daft_tpu_torch.core.kernels import png

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

SEED = 2024


def _png(samples, depth, ctype, interlace=False, palette=None, trns=None, filters=None):
    """PNG bytes of (h, w, c) ``samples`` written apart from the port's
    encoder: any depth and colour type, each row's filter taken in turn
    from ``filters`` (all five by default), optionally Adam7-interlaced."""
    samples = np.asarray(samples)
    h, w, c = samples.shape
    filters = filters or (0, 1, 2, 3, 4)
    bpp = max(1, c * depth // 8)
    k = [0]

    def pack(sub):
        sh, sw = sub.shape[:2]
        if depth == 16:
            lines = sub.astype(">u2").reshape(sh, sw * c).view(np.uint8)
        elif depth == 8:
            lines = sub.astype(np.uint8).reshape(sh, sw * c)
        else:
            per = 8 // depth
            vals = np.zeros((sh, -(-sw // per) * per), dtype=np.uint8)
            vals[:, :sw] = sub[:, :, 0]
            vals = vals.reshape(sh, -1, per)
            shifts = np.arange(per - 1, -1, -1) * depth
            lines = (vals << shifts).sum(axis=2).astype(np.uint8)
        out = bytearray()
        prev = np.zeros(lines.shape[1], dtype=np.int64)
        for row in lines.astype(np.int64):
            ft = filters[k[0] % len(filters)]
            k[0] += 1
            left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            if ft == 0:
                f = row
            elif ft == 1:
                f = row - left
            elif ft == 2:
                f = row - prev
            elif ft == 3:
                f = row - (left + prev) // 2
            else:
                pa_, pb, pc = (np.abs(prev - upleft), np.abs(left - upleft),
                               np.abs(left + prev - 2 * upleft))
                pred = np.where((pa_ <= pb) & (pa_ <= pc), left, np.where(pb <= pc, prev, upleft))
                f = row - pred
            out += bytes([ft]) + (f % 256).astype(np.uint8).tobytes()
            prev = row
        return bytes(out)

    if interlace:
        raw = b""
        for xs, ys, dx, dy in png._ADAM7:
            sub = samples[ys::dy, xs::dx]
            if sub.size:
                raw += pack(sub)
    else:
        raw = pack(samples)

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))
    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    return data + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _cases():
    rng = np.random.default_rng(SEED)
    h, w = 13, 19
    pal = rng.integers(0, 256, (16, 3))
    cases = {}
    for depth in (1, 2, 4, 8, 16):
        cases[f"gray{depth}"] = (rng.integers(0, 1 << depth, (h, w, 1)), depth, 0, {})
    cases["gray8_trns"] = (rng.integers(0, 4, (h, w, 1)) * 60, 8, 0,
                           {"trns": struct.pack(">H", 60)})
    for depth in (8, 16):
        cases[f"rgb{depth}"] = (rng.integers(0, 1 << depth, (h, w, 3)), depth, 2, {})
        cases[f"gray_alpha{depth}"] = (rng.integers(0, 1 << depth, (h, w, 2)), depth, 4, {})
        cases[f"rgba{depth}"] = (rng.integers(0, 1 << depth, (h, w, 4)), depth, 6, {})
    cases["rgb8_trns"] = ((rng.integers(0, 2, (h, w, 3)) * 200), 8, 2,
                          {"trns": struct.pack(">HHH", 200, 0, 200)})
    for depth in (1, 2, 4, 8):
        cases[f"palette{depth}"] = (rng.integers(0, min(16, 1 << depth), (h, w, 1)), depth, 3,
                                    {"palette": pal})
    cases["palette8_trns"] = (rng.integers(0, 16, (h, w, 1)), 8, 3,
                              {"palette": pal, "trns": bytes(rng.integers(0, 256, 11)
                                                             .astype(np.uint8))})
    for name in ("gray2", "rgb8", "rgba16", "palette4", "gray_alpha8"):
        s, d, t, kw = cases[name]
        cases[name + "_interlaced"] = (s, d, t, dict(kw, interlace=True))
    return {k: _png(s, d, t, **kw) for k, (s, d, t, kw) in cases.items()}


CASES = _cases()


def _ref_series(values, name="b"):
    return daft_tpu.Series.from_pylist(values, name, daft_tpu.DataType.binary())


def _port_series(values, name="b"):
    return daft_tpu_torch.Series.from_pylist(values, name, daft_tpu_torch.DataType.binary())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", [None, "L", "LA", "RGB", "RGBA"])
def test_png_decode_equals_pil(name, mode):
    data = CASES[name]
    ref = ref_image.decode(_ref_series([data, None]), mode)
    port = port_image.decode(_port_series([data, None]), mode)
    assert port.dtype == daft_tpu_torch.DataType.image()
    assert port.to_pylist() == ref.to_pylist()


def test_png_decode_of_pil_written_files():
    """Files PIL writes (its adaptive filters, its palette quantizer)."""
    rng = np.random.default_rng(SEED + 1)
    rgb = rng.integers(0, 256, (21, 17, 3), dtype=np.uint8)
    ims = [Image.fromarray(rgb), Image.fromarray(rgb).convert("RGBA"),
           Image.fromarray(rgb).convert("L"), Image.fromarray(rgb).convert("LA"),
           Image.fromarray(rgb).quantize(12), Image.fromarray(rgb[:, :, 0] > 128),
           Image.fromarray(rng.integers(0, 65536, (9, 11), dtype=np.uint16))]
    blobs = []
    for im in ims:
        b = io.BytesIO()
        im.save(b, "PNG")
        blobs.append(b.getvalue())
    ref = ref_image.decode(_ref_series(blobs))
    port = port_image.decode(_port_series(blobs))
    assert port.to_pylist() == ref.to_pylist()


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_encode_round_trips_through_both_decoders(channels):
    rng = np.random.default_rng(SEED + channels)
    imgs = [rng.integers(0, 256, (int(rng.integers(1, 40)), int(rng.integers(1, 40)),
                                  channels), dtype=np.uint8) for _ in range(6)]
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    col_ = port_image.build_image_series("i", imgs + [None], [mode] * 6 + [None])
    enc = port_image.encode(col_)
    assert enc.validity_numpy().tolist() == [True] * 6 + [False]
    for img, data in zip(imgs, enc.to_pylist()):
        pil = np.asarray(Image.open(io.BytesIO(data)))
        assert np.array_equal(pil.reshape(img.shape), img)
    again = port_image.decode(enc)
    ref_again = ref_image.decode(_ref_series(enc.to_pylist()))
    assert again.to_pylist() == ref_again.to_pylist()
    assert again.to_pylist()[:6] == col_.to_pylist()[:6]


def _images(channels=3, n=6, seed=SEED, sides=(9, 80)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(sides[0], sides[1], 2))
        y = np.linspace(0, 200, h)[:, None, None]
        x = np.linspace(0, 50, w)[None, :, None]
        out.append(np.clip(y + x + rng.integers(-20, 20, (h, w, channels)), 0, 255)
                   .astype(np.uint8))
    return out


def _pair(imgs, mode):
    """The same images as an image column of each package."""
    blobs = [png.encode_png(i) for i in imgs]
    return (ref_image.decode(_ref_series(blobs + [None]), mode),
            port_image.decode(_port_series(blobs + [None]), mode))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("size", [(7, 9), (33, 21), (64, 48)])
def test_resize_downscales_bit_for_bit(channels, size):
    imgs = _images(channels, seed=SEED + channels, sides=(80, 200))
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    ref, port = _pair(imgs, mode)
    w, h = size
    assert port_image.resize(port, w, h).to_pylist() == ref_image.resize(ref, w, h).to_pylist()


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_exact_halving_is_cv2s_area_average(channels):
    imgs = [np.random.default_rng(5).integers(0, 256, (64, 48, channels), dtype=np.uint8)]
    mode = {1: "L", 3: "RGB"}[channels]
    ref, port = _pair(imgs, mode)
    assert port_image.resize(port, 24, 32).to_pylist() == \
        ref_image.resize(ref, 24, 32).to_pylist()


def test_resize_upscales_within_one_on_under_two_percent():
    """cv2's upscale rounds a few values its own way: the port is within 1
    of it, and 0.1-1 % of the values differ (under 2 %)."""
    imgs = _images(3, n=8, seed=SEED + 9, sides=(10, 60))
    ref, port = _pair(imgs, "RGB")
    unequal = total = 0
    for a, b in zip(port_image.unpack_images(port_image.resize(port, 96, 80)),
                    ref_image.unpack_images(ref_image.resize(ref, 96, 80))):
        if a[0] is None:
            assert b[0] is None
            continue
        d = np.abs(a[0].astype(int) - b[0].astype(int))
        assert d.max() <= 1
        unequal += int((d > 0).sum())
        total += d.size
    assert unequal / total < 0.02


@pytest.mark.parametrize("bbox", [(0, 0, 5, 5), (3, 2, 10, 7), (8, 8, 100, 100)])
def test_crop_equals_reference(bbox):
    ref, port = _pair(_images(3, seed=SEED + 3), "RGB")
    assert port_image.crop(port, bbox).to_pylist() == ref_image.crop(ref, bbox).to_pylist()


@pytest.mark.parametrize("src", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("dst", ["L", "LA", "RGB", "RGBA"])
def test_mode_conversions_equal_pil(src, dst):
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[src]
    ref, port = _pair(_images(channels, seed=SEED + channels), src)
    assert port_image.to_mode(port, dst).to_pylist() == ref_image.to_mode(ref, dst).to_pylist()


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_to_fixed_shape_equals_reference_on_valid_rows(mode):
    imgs = _images(3, n=5, seed=SEED + 11, sides=(40, 120)) + \
        _images(1, n=3, seed=SEED + 12, sides=(40, 120))
    blobs = [png.encode_png(i) for i in imgs]
    ref = ref_image.to_fixed_shape(ref_image.decode(_ref_series(blobs + [None])), mode, 24, 32)
    port = port_image.to_fixed_shape(port_image.decode(_port_series(blobs + [None])), mode,
                                     24, 32)
    assert port.dtype == daft_tpu_torch.DataType.fixed_shape_image(mode, 24, 32)
    valid = ref.validity_numpy()
    assert port.validity_numpy().tolist() == valid.tolist()
    assert np.array_equal(port.to_numpy()[valid], ref.to_numpy()[valid])
    assert port.to_numpy().shape == ref.to_numpy().shape
    assert not port.to_numpy()[~valid].any()


@pytest.mark.parametrize("fn", ["image_height", "image_width", "image_channel", "image_hash",
                                "image_mode"])
def test_accessors_equal_reference(fn):
    imgs = _images(3, seed=SEED + 4) + _images(1, n=2, seed=SEED + 5)
    blobs = [png.encode_png(i) for i in imgs] + [None, b"no image"]
    with ref_ctx(device_mode="off"):
        want = daft_tpu.from_pydict({"b": blobs}).select(
            getattr(daft_tpu.col("b").image.decode(on_error="null"), fn)()
            if fn != "image_mode" else daft_tpu.col("b").image.decode(on_error="null")
            ._fn("image_mode")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict({"b": blobs}).select(
            getattr(col("b").image.decode(on_error="null"), fn)()
            if fn != "image_mode" else col("b").image.decode(on_error="null")
            ._fn("image_mode")).to_pydict()
    assert got == want


def test_decode_errors_follow_on_error():
    blobs = [png.encode_png(np.zeros((3, 4, 3), np.uint8)), b"not an image at all", None]
    out = port_image.decode(_port_series(blobs), on_error="null")
    ref = ref_image.decode(_ref_series(blobs), on_error="null")
    assert out.to_pylist() == ref.to_pylist()
    assert out.validity_numpy().tolist() == [True, False, False]
    with pytest.raises(ValueError):
        port_image.decode(_port_series(blobs), on_error="raise")


@pytest.mark.parametrize("fmt", ["JPEG", "GIF", "BMP", "TIFF", "WebP"])
@pytest.mark.parametrize("on_error", ["raise", "null"])
def test_deferred_formats_raise_not_implemented(fmt, on_error):
    b = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(b, fmt.upper())
    data = b.getvalue()
    if fmt == "JPEG":
        # the port decodes baseline and progressive JPEG; an arithmetic-coded
        # frame (SOF9) is a variant that still raises
        data = data.replace(b"\xff\xc0", b"\xff\xc9", 1)
    with pytest.raises(NotImplementedError, match=fmt):
        port_image.decode(_port_series([data]), on_error=on_error)


def test_encode_to_jpeg_raises_not_implemented():
    """JPEG encoding is ported: an RGB image encodes; an RGBA one raises as
    PIL's save raises (OSError), and so does the reference."""
    rgb = port_image.build_image_series("i", [np.zeros((2, 2, 3), np.uint8)], ["RGB"])
    assert Image.open(io.BytesIO(port_image.encode(rgb, "jpg").to_pylist()[0])).mode == "RGB"
    rgba = port_image.build_image_series("i", [np.zeros((2, 2, 4), np.uint8)], ["RGBA"])
    with pytest.raises(OSError, match="JPEG"):
        port_image.encode(rgba, "jpg")
    ref_rgba = ref_image.build_image_series("i", [np.zeros((2, 2, 4), np.uint8)], ["RGBA"])
    with pytest.raises(OSError, match="JPEG"):
        ref_image.encode(ref_rgba, "jpg")


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_library_equals_plain(bpp, monkeypatch):
    rng = np.random.default_rng(bpp)
    h, stride = 9, bpp * 7 + 3
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5
    lib = native.png_unfilter(raw.reshape(-1), h, stride, bpp)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    plain = native.png_unfilter(raw.reshape(-1), h, stride, bpp)
    assert np.array_equal(lib, plain)
    raw[3, 0] = 7
    with pytest.raises(ValueError, match="filter"):
        native.png_unfilter(raw.reshape(-1), h, stride, bpp)


def test_image_functions_in_a_query_equal_reference(tmp_path):
    """url.download -> image.decode -> resize -> encode -> decode as queries
    of both packages, over files on disk."""
    imgs = _images(3, n=5, seed=SEED + 21, sides=(20, 50))
    paths = []
    for i, img in enumerate(imgs):
        p = os.path.join(tmp_path, f"{i}.png")
        with open(p, "wb") as f:
            f.write(png.encode_png(img))
        paths.append(p)
    paths.append(None)

    def q(m, c):
        return m.from_pydict({"p": paths}).select(
            c("p").url.download().image.decode().image.resize(16, 12).image.encode()
            .image.decode().alias("i"))
    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, daft_tpu.col).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = q(daft_tpu_torch, col).to_pydict()
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_resize_library_equals_plain(seed, monkeypatch):
    """The host library's uint8 resize (native.py ``image_resize_u8``)
    equals its plain numpy version bit for bit, up and down, every channel
    count."""
    rng = np.random.default_rng([SEED, seed])
    cases = []
    for _ in range(12):
        h, w, c = int(rng.integers(1, 90)), int(rng.integers(1, 90)), int(rng.integers(1, 5))
        cases.append((rng.integers(0, 256, (h, w, c), dtype=np.uint8),
                      int(rng.integers(1, 120)), int(rng.integers(1, 120))))
    lib = [port_image.resize_image(img, w, h) for img, w, h in cases]
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    plain = [port_image.resize_image(img, w, h) for img, w, h in cases]
    for a, b in zip(lib, plain):
        assert a.shape == b.shape and np.array_equal(a, b)
