"""M1 at a small size on the card: PNG files written by the port's encoder,
downloaded, decoded, made fixed-shape, fed to a device UDF as one (rows,
h, w, 3) uint8 tensor a dispatch, their cosine distances grouped on the
card. Marked ``cuda``: skipped where no card is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_multimodal.py

The chain plans a device UDF stage and a DeviceGroupedAgg that launches
K1, K2 and K7; keys and counts equal the host path bit for bit, the float
aggregates within rtol 1e-5; the UDF's output equals the same function on
the CPU within rtol 1e-5; a warm run uploads no bytes.
"""

import os

import numpy as np
import pytest
import torch

import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.core.kernels import png
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.observability.metrics import registry
from daft_tpu_torch.ops import counters

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


N_IMAGES = 96
W = np.random.default_rng(5).standard_normal((3, 6)).astype(np.float32)
QUERY = np.random.default_rng(6).standard_normal(6)


def _fn(params, x):
    return x.to(torch.float32).mean(dim=(1, 2)) @ params["w"]


def _embed():
    return dt.func(_fn, on_device=True, batch_size=32,
                   return_dtype=dt.DataType.embedding(dt.DataType.float32(), 6),
                   device_params=lambda: {"w": W}, device_key="cuda_mm_test:v1")


def _files(root):
    rng = np.random.default_rng(24)
    for i in range(N_IMAGES):
        h, w = (int(v) for v in rng.integers(40, 160, 2))
        c = (3, 3, 1, 4)[i % 4]
        img = np.clip(np.arange(h)[:, None, None] + rng.integers(0, 60, (h, w, c)), 0, 255)
        with open(os.path.join(root, f"{i:03d}.png"), "wb") as f:
            f.write(png.encode_png(img.astype(np.uint8)) if i % 31 else b"no image")
    return os.path.join(root, "*.png")


def _query(pattern, embed, upto_e=False):
    df = dt.from_glob_path(pattern)
    df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
    df = df.with_column("fx", col("img").image.to_fixed_shape("RGB", 64, 64))
    df = df.with_column("e", embed(col("fx")))
    if upto_e:
        return df.select("fx", "e")
    df = df.with_column("dist", col("e").embedding.cosine_distance(dt.lit(QUERY)))
    d = col("dist")
    return df.groupby(col("img").image_channel().alias("c")).agg(
        d.count().alias("n"), d.sum().alias("s"), d.min().alias("lo"),
        d.max().alias("hi")).sort("c")


def test_m1_small_on_the_card(tmp_path):
    pattern = _files(tmp_path)
    embed = _embed()
    manager().clear()
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        counters.reset()
        got = _query(pattern, embed).to_pydict()
        for k in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes"):
            assert getattr(counters, f"launches_{k}") >= 1, k
        assert counters.device_udf_dispatches >= 1
        before = registry().snapshot()
        again = _query(pattern, embed).to_pydict()
        assert registry().diff(before).get("hbm_h2d_bytes", 0) == 0
        rows = _query(pattern, embed, upto_e=True).to_pydict()
    with dt.execution_config_ctx(device="cuda", device_mode="off"):
        host = _query(pattern, embed).to_pydict()
    assert got["c"] == host["c"] == again["c"] and got["n"] == host["n"]
    for k in ("s", "lo", "hi"):
        for a, b in zip(got[k], host[k]):
            assert (a is None and b is None) or a == pytest.approx(b, rel=1e-5)
    live = [i for i, v in enumerate(rows["e"]) if v is not None]
    fx = torch.from_numpy(np.stack([rows["fx"][i] for i in live]))
    cpu = _fn({"w": torch.from_numpy(W)}, fx).numpy()
    np.testing.assert_allclose(np.stack([rows["e"][i] for i in live]), cpu, rtol=1e-5,
                               atol=1e-5)
