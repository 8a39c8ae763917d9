"""The multimodal wave against the reference, on the same seeded inputs:
the embedding distances and norm (rtol 1e-12), minhash and the "bytes"
tokenizer (bit for bit; a WordPiece tokenizer file raises NotImplementedError), url
download and upload and the file functions over local files (bit for bit;
a remote URL raises NotImplementedError), ``from_glob_path`` and
``from_files``, the namespaces and the flat API, the logical types' casts,
and a device UDF over a fixed-shape image column on the CPU equal to its
host path. Also chip_smoke.py's multimodal phase on the CPU at a small
size."""

import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import DataType as PD, col
from daft_tpu_torch.core.kernels import png
from daft_tpu_torch.functions import registry as port_reg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RD = daft_tpu.DataType
SEED = 2424


def _both(query, data):
    """``query(module, col)`` over ``data`` through each package's host."""
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, daft_tpu.col, daft_tpu.from_pydict(data)).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = query(daft_tpu_torch, col, daft_tpu_torch.from_pydict(data)).to_pydict()
    return got, want


def _close(got, want, rtol=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g == pytest.approx(w, rel=rtol, abs=0) or (np.isnan(g) and np.isnan(w))


def _vectors(n=40, d=8, seed=SEED):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n, d))
    a[3] = 0.0  # a zero vector: cosine is NaN in both
    rows_a = [list(map(float, r)) for r in a]
    rows_b = [list(map(float, r)) for r in b]
    rows_a[5] = None
    rows_b[7] = None
    return rows_a, rows_b


@pytest.mark.parametrize("fn", ["cosine_distance", "dot", "euclidean_distance"])
@pytest.mark.parametrize("kind", ["list", "embedding"])
def test_distances_equal_reference(fn, kind):
    a, b = _vectors()

    def q(m, c, df):
        x, y = c("a"), c("b")
        if kind == "embedding":
            x = x.cast(m.DataType.embedding(m.DataType.float64(), 8))
            y = y.cast(m.DataType.embedding(m.DataType.float64(), 8))
        return df.select(getattr(x.embedding, fn if fn != "dot" else "dot")(y).alias("d"))
    got, want = _both(q, {"a": a, "b": b})
    _close(got["d"], want["d"])


def test_distance_to_a_literal_vector_and_norm_equal_reference():
    a, _b = _vectors(seed=SEED + 1)
    q_vec = np.random.default_rng(3).standard_normal(8)

    def q(m, c, df):
        e = c("a").cast(m.DataType.embedding(m.DataType.float64(), 8))
        return df.select(e.embedding.cosine_distance(m.lit(q_vec)).alias("c"),
                         e.embedding.norm().alias("n"),
                         e.euclidean_distance(m.lit(q_vec)).alias("u"))
    got, want = _both(q, {"a": a})
    for k in ("c", "n", "u"):
        _close(got[k], want[k])


@pytest.mark.parametrize("args", [(16, 1, 1), (32, 3, 7), (8, 5, 2)])
def test_minhash_equals_reference(args):
    rng = np.random.default_rng(SEED + args[0])
    vocab = [f"w{i}" for i in range(300)]
    texts = [" ".join(rng.choice(vocab, int(rng.integers(0, 15)))) for _ in range(200)]
    texts += [None, "", "solo", "two words"]
    k, ng, seed = args
    got, want = _both(lambda m, c, df: df.select(
        c("t").minhash(num_hashes=k, ngram_size=ng, seed=seed).alias("m")), {"t": texts})
    assert got == want
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        dt_ = daft_tpu_torch.from_pydict({"t": texts}).select(col("t").minhash(k, ng, seed)) \
            .schema["t"].dtype
    assert dt_ == PD.fixed_size_list(PD.uint64(), k)


def test_tokenize_bytes_round_trip_equals_reference():
    texts = ["hello", "", None, "héllo wörld ✓", "a" * 300]
    got, want = _both(lambda m, c, df: df.select(
        c("t").tokenize_encode("bytes").alias("ids"),
        c("t").tokenize_encode("bytes").tokenize_decode("bytes").alias("back"),
        c("t").tokenize_encode("bytes").list.length().alias("n")), {"t": texts})
    assert got == want
    assert got["back"] == texts


def test_tokenizer_file_raises_not_implemented(tmp_path):
    """BPE tokenizer files are read (tests/test_torch_tokenizer_file.py);
    a model the port does not read yet (WordPiece) raises."""
    path = os.path.join(tmp_path, "tokenizer.json")
    with open(path, "w") as f:
        f.write('{"model": {"type": "WordPiece", "vocab": {"x": 0}}}')
    with daft_tpu_torch.execution_config_ctx(device="cpu"), \
            pytest.raises(NotImplementedError, match="tokenizer"):
        daft_tpu_torch.from_pydict({"t": ["x"]}).select(
            col("t").tokenize_encode(path)).to_pydict()


def _files(tmp_path, n=6):
    rng = np.random.default_rng(SEED)
    paths = []
    for i in range(n):
        p = os.path.join(tmp_path, f"f{i:02d}.bin")
        with open(p, "wb") as f:
            f.write(rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes())
        paths.append(p)
    return paths


def test_url_download_and_file_functions_equal_reference(tmp_path):
    paths = _files(tmp_path)
    data = {"p": paths + ["file://" + paths[0], None]}

    def q(m, c, df):
        f = c("p")._fn("file")
        return df.select(c("p").url.download().alias("d"), f.file_path().alias("fp"),
                         f.file_size().alias("sz"),
                         f.file_read(offset=3, length=10).alias("rd"),
                         f.file_read().alias("all"))
    got, want = _both(q, data)
    assert got == want
    missing = {"p": [os.path.join(tmp_path, "missing.bin")]}
    got, want = _both(lambda m, c, df: df.select(
        c("p").url.download(on_error="null").alias("d")), missing)
    assert got == want == {"d": [None]}
    with daft_tpu_torch.execution_config_ctx(device="cpu"), pytest.raises(FileNotFoundError):
        daft_tpu_torch.from_pydict(missing).select(col("p").url.download()).to_pydict()


@pytest.mark.parametrize("url", ["https://example.com/a.png", "s3://bucket/a.png"])
def test_remote_urls_raise_not_implemented(url):
    with daft_tpu_torch.execution_config_ctx(device="cpu"), \
            pytest.raises(NotImplementedError, match="object store"):
        daft_tpu_torch.from_pydict({"p": [url]}).select(
            col("p").url.download(on_error="null")).to_pydict()


def test_url_upload_writes_the_bytes(tmp_path):
    blobs = [b"abc", None, b"", bytes(range(256))]
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        out = daft_tpu_torch.from_pydict({"b": blobs}).select(
            col("b").url.upload(str(tmp_path / "up")).alias("p")).to_pydict()["p"]
    assert out[1] is None
    for p, b in zip(out, blobs):
        if b is not None:
            with open(p, "rb") as f:
                assert f.read() == b
    with ref_ctx(device_mode="off"):
        ref = daft_tpu.from_pydict({"b": blobs}).select(
            daft_tpu.col("b").url.upload(str(tmp_path / "up_ref")).alias("p")).to_pydict()["p"]
    assert [p is None for p in ref] == [p is None for p in out]


def test_from_glob_path_and_from_files_equal_reference(tmp_path):
    _files(tmp_path)
    pattern = os.path.join(tmp_path, "*.bin")
    with ref_ctx(device_mode="off"):
        want = daft_tpu.from_glob_path(pattern).to_pydict()
        want_files = daft_tpu.from_files(pattern).select(
            "path", "size", daft_tpu.col("file").file_size().alias("fs")).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_glob_path(pattern).to_pydict()
        got_files = daft_tpu_torch.from_files(pattern).select(
            "path", "size", col("file").file_size().alias("fs")).to_pydict()
        pruned = daft_tpu_torch.from_glob_path(pattern).select("size").to_pydict()
    assert got == want and got_files == want_files
    assert pruned == {"size": want["size"]}
    assert daft_tpu_torch.from_files(pattern).schema["file"].dtype == PD.file()


def test_namespaces_and_flat_api_build():
    c = col("x")
    assert c.image.decode()._fn is not None
    for name, fname in [("cosine_distance", "cosine_distance"), ("dot_product", "dot"),
                        ("decode_image", "image_decode"), ("resize", "image_resize"),
                        ("image_to_tensor", "image_to_fixed_shape"),
                        ("download", "url_download"), ("image_height", "image_height")]:
        args = {"cosine_distance": (c,), "dot_product": (c,), "resize": (4, 4),
                "image_to_tensor": ("RGB", 4, 4)}.get(name, ())
        e = getattr(c, name)(*args)
        assert e.fname == fname


def test_every_multimodal_name_is_registered_and_no_wave_is_left():
    names = ["image_decode", "image_encode", "image_resize", "image_crop", "image_to_mode",
             "image_to_fixed_shape", "image_height", "image_width", "image_channel",
             "image_mode", "image_hash", "url_download", "url_upload", "cosine_distance",
             "dot", "euclidean_distance", "embedding_norm", "minhash", "tokenize_encode",
             "tokenize_decode", "file", "file_path", "file_size", "file_read",
             "audio_metadata", "audio_resample", "video_metadata"]
    for n in names:
        assert port_reg.has_function(n) and port_reg.later_wave(n) is None, n
    assert port_reg._WAVES == {}


@pytest.mark.parametrize("kind", ["embedding", "fixed_shape_tensor"])
def test_logical_casts_equal_reference(kind):
    rows = [[1.0, 2.0, 3.0, 4.0], None, [0.5, -1.0, 2.5, 8.0]]

    def q(m, c, df):
        t = m.DataType.embedding(m.DataType.float32(), 4) if kind == "embedding" \
            else m.DataType.fixed_shape_tensor(m.DataType.float32(), (2, 2))
        x = c("a").cast(t)
        out = [x.cast(m.DataType.list(m.DataType.float64())).alias("back")]
        if kind == "embedding":
            out.append(x.embedding.norm().alias("n"))
        return df.select(*out)
    got, want = _both(q, {"a": rows})
    assert got == want


def test_embedding_from_numpy_and_pylist_equal_reference():
    arr = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    p = daft_tpu_torch.Series.from_numpy(arr, "e", PD.embedding(PD.float32(), 3))
    r = daft_tpu.Series.from_numpy(arr, "e", RD.embedding(RD.float32(), 3))
    assert p.dtype == PD.embedding(PD.float32(), 3)
    assert np.array_equal(p.to_numpy(), r.to_numpy())
    assert all(np.array_equal(a, b) for a, b in zip(p.to_pylist(), r.to_pylist()))
    back = daft_tpu_torch.Series.from_pylist(p.to_pylist(), "e", p.dtype)
    assert np.array_equal(back.to_numpy(), arr)


def _png_dir(tmp_path, n=14):
    rng = np.random.default_rng(SEED + 5)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(12, 40, 2))
        c = (3, 1, 4)[i % 3]
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        with open(os.path.join(tmp_path, f"{i:03d}.png"), "wb") as f:
            f.write(png.encode_png(img) if i != 4 else b"no image here")
    return os.path.join(tmp_path, "*.png")


def _udf(torch_mod):
    w = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    return daft_tpu_torch.func(
        lambda p, x: x.to(torch_mod.float32).mean(dim=(1, 2)) @ p["w"], on_device=True,
        return_dtype=PD.embedding(PD.float32(), 5), device_params=lambda: {"w": w},
        batch_size=4, device_key="test_mm_udf:v1")


def test_device_udf_over_fixed_shape_images_equals_host_path(tmp_path):
    """A device UDF over a fixed-shape image column on the CPU: one (rows,
    h, w, 3) uint8 tensor a dispatch, its output equal to the host path's
    (device_mode="off") and to the function over the dense array."""
    import torch

    from daft_tpu_torch.ops import counters

    pattern = _png_dir(tmp_path)
    f = _udf(torch)

    def q():
        df = daft_tpu_torch.from_glob_path(pattern)
        img = col("path").url.download().image.decode(on_error="null")
        return df.select(img.image.to_fixed_shape("RGB", 8, 10).alias("fx")) \
            .with_column("e", f(col("fx")))
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        counters.reset()
        on = q().to_pydict()
        assert counters.device_udf_dispatches >= 1
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        off = q().to_pydict()
    assert [v is None for v in on["e"]] == [v is None for v in off["e"]]
    assert sum(v is None for v in on["e"]) == 1
    dense = np.stack([np.zeros((8, 10, 3), np.uint8) if v is None else v for v in on["fx"]])
    want = (torch.from_numpy(dense).to(torch.float32).mean(dim=(1, 2))
            @ torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5))
                               .astype(np.float32))).numpy()
    for i, (a, b) in enumerate(zip(on["e"], off["e"])):
        if a is not None:
            assert np.array_equal(a, b)
            np.testing.assert_allclose(a, want[i], rtol=1e-6)


def test_multimodal_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's multimodal phase on the CPU at a small size: M1's
    chain plans a device UDF and a DeviceGroupedAgg, equal to "off" and
    the oracle, uploading nothing warm; M2's signatures and bands equal
    the oracle, the band count on the grouped stage; M3 within its
    bounds."""
    import contextlib

    from daft_tpu_torch.device.residency import manager

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    @contextlib.contextmanager
    def cpu_ctx():
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on") as cfg:
            yield cfg

    monkeypatch.setattr(cs, "dt_ctx", cpu_ctx)
    monkeypatch.setattr(cs, "CELL_KERNEL_PREFIX", "plain_")
    monkeypatch.setattr(cs, "phase_profile", lambda *a, **k: None)
    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    for name, v in (("MM_SIDES", (24, 64)), ("MM_SIZE", 28), ("MM_CHECK_ROWS", 40),
                    ("MM_BATCH", 32)):
        monkeypatch.setattr(cs, name, v)
    # the kernel cases need the card: here, what the cold runs' capture
    # hands them
    cases = {}

    def record(tag, label, calls, required, kernel_results, card):
        for wrapper in required:
            assert calls[wrapper], (label, wrapper)
        cases[tag] = {w: len(seen) for w, seen in calls.items()}

    monkeypatch.setattr(cs, "stage_kernel_cases", record)
    lineitem = cs.tpch_sf1(11, n_orders=3_000, n_parts=200, n_customers=400)[0]
    paths = cs.phase_multimodal(lineitem, "cpu", {}, images=100, docs=2000)
    assert set(cases) == {"m1", "m2"}
    for tag, path in (("m1", "multimodal_m1"), ("m2", "multimodal_m2")):
        for w, n in cases[tag].items():  # the cold run's calls, every one kept
            assert n == paths[path][w], (tag, w, n, paths[path])
    for k in cs.MM_KERNELS:
        assert paths["multimodal_m1"][k] >= 1, paths
    assert paths["multimodal_m2"]["segment_sum_planes"] >= 1
    out = capsys.readouterr().out
    assert "M1: 7 result rows, equal to the host path and the numpy oracle" in out or \
        "result rows, equal to the host path and the numpy oracle" in out
    assert "M1: the warm runs upload 0 bytes, 0 residency misses" in out
    assert "signatures and bands equal the oracle bit for bit" in out
    assert "registers and estimate equal the oracle" in out
    assert "phase seconds: multimodal" in out and "M1 host split of the cold run (s): download" in out


def test_logical_columns_write_parquet_as_their_storage(tmp_path):
    """An embedding and an image column written to Parquet read back as
    their storage types (a fixed-size list, a struct), as the reference's
    do, with the same values."""
    from daft_tpu.core.kernels import image as ref_image
    from daft_tpu_torch.core.kernels import image as port_image

    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    imgs = [np.full((2, 3, 3), 7, np.uint8), None, np.ones((1, 2, 1), np.uint8), None]
    modes = ["RGB", None, "L", None]
    outs = []
    for m, img_mod, ctx in ((daft_tpu, ref_image, ref_ctx(device_mode="off")),
                            (daft_tpu_torch, port_image,
                             daft_tpu_torch.execution_config_ctx(device="cpu"))):
        d = str(tmp_path / m.__name__)
        with ctx:
            e = m.Series.from_numpy(arr, "e", m.DataType.embedding(m.DataType.float32(), 3))
            df = m.from_pydict({"e": e, "img": img_mod.build_image_series("img", imgs, modes),
                                "k": [1, 2, 3, 4]})
            df.write_parquet(d)
            back = m.read_parquet(d).sort("k")
            outs.append((repr(back.schema["e"].dtype), back.schema["img"].dtype.kind,
                         back.to_pydict()))
    (pe, pk, pv), (re_, rk, rv) = outs[1], outs[0]
    assert pe == re_ == "FixedSizeList[Float32; 3]" and pk == rk == "struct"
    assert pv == rv


def test_logical_columns_spill_and_read_back(tmp_path):
    """A sort over a fixed-shape image column under a host memory budget
    spills it and reads it back unchanged."""
    from daft_tpu_torch.core.kernels import image as port_image

    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (4, 4, 3), dtype=np.uint8) for _ in range(300)]
    fx = port_image.to_fixed_shape(port_image.build_image_series(
        "img", imgs, ["RGB"] * 300), "RGB", 3, 3)
    keys = rng.permutation(300)
    with daft_tpu_torch.execution_config_ctx(device="cpu", memory_limit_bytes=4000,
                                             spill_dir=str(tmp_path), morsel_size_rows=50):
        out = daft_tpu_torch.from_pydict({"k": keys, "fx": fx}).sort("k").to_pydict()
    order = np.argsort(keys)
    assert out["k"] == keys[order].tolist()
    assert all(np.array_equal(a, fx.to_numpy()[i]) for a, i in zip(out["fx"], order))
