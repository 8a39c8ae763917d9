"""Writes the JPEG fixtures of this directory with PIL, and expected.json:
each file's pixels as PIL decodes them (shape, mode, sha256 of the bytes),
which chip_smoke.py's J1 path holds the port's decoder to on a machine
without PIL. tests/test_torch_jpeg.py checks that the files and digests
are still PIL's.

    python tests/data/jpeg/make_fixtures.py
"""

import hashlib
import io
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (height, width, mode, save options)
FIXTURES = {
    "progressive_420.jpg": (93, 127, "RGB", {"progressive": True}),
    "progressive_444_q90.jpg": (64, 80, "RGB", {"progressive": True, "subsampling": 0,
                                                "quality": 90}),
    "progressive_gray.jpg": (57, 45, "L", {"progressive": True}),
    "progressive_restart.jpg": (120, 96, "RGB", {"progressive": True,
                                                 "restart_marker_blocks": 5}),
    "baseline_422_restart.jpg": (77, 131, "RGB", {"subsampling": 1,
                                                  "restart_marker_rows": 1}),
    "cmyk_adobe.jpg": (48, 66, "CMYK", {}),
}


def pixels(h: int, w: int, mode: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / (5.0 + k)) * 70 + np.cos(y / (4.0 + k)) * 50 + 128
                    for k in range(c)], axis=2) + rng.normal(0, 10, (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def digest(data: bytes) -> dict:
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    px = np.asarray(im)
    return {"shape": list(px.shape), "mode": im.mode,
            "sha256": hashlib.sha256(px.tobytes()).hexdigest()}


def main() -> None:
    from PIL import Image

    expected = {}
    for i, (name, (h, w, mode, opts)) in enumerate(sorted(FIXTURES.items())):
        buf = io.BytesIO()
        Image.fromarray(pixels(h, w, mode, i), mode).save(buf, "JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        expected[name] = digest(data)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(expected)} fixtures")


if __name__ == "__main__":
    main()
