"""The native extension ABI (daft_tpu_torch/ext.py) against the reference's
(daft_tpu/ext.py; counterpart of tests/test_ext_abi.py).

The example module (native/ext_example/example_ext.cpp, the contract
native/include/daft_tpu_ext.h) is built with g++ as the reference's test
builds it and loaded by both packages. The port fills the Arrow C Data
Interface structs from its numpy planes itself; the reference moves columns
through pyarrow's. The same seeded columns through both give equal
``to_pydict`` (exactly: the module doubles and adds in f64 and int64), and
the port refuses a bad module as the reference does.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch import col
from daft_tpu_torch.config import execution_config_ctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ext_path(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = str(tmp_path_factory.mktemp("ext") / "libexample_ext.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-I{REPO}/native/include",
                    f"{REPO}/native/ext_example/example_ext.cpp", "-o", out],
                   check=True, capture_output=True)
    return out


def _both(ext_path, data, select):
    daft_tpu.load_extension(ext_path)
    daft_tpu_torch.load_extension(ext_path)
    want = daft_tpu.from_pydict(data).select(*select(daft_tpu)).to_pydict()
    with execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict(data).select(*select(daft_tpu_torch)).to_pydict()
    return got, want


def test_load_and_call(ext_path):
    ext = daft_tpu_torch.load_extension(ext_path)
    assert ext.name == "example_ext"
    assert set(ext.functions) == {"ext_double", "ext_add"}
    got, want = _both(ext_path, {"x": [1.0, 2.0, None], "y": [10.0, 20.0, 30.0]},
                      lambda p: [p.call_function("ext_double", p.col("x")),
                                 p.call_function("ext_add", p.col("x"), p.col("y")).alias("s")])
    assert got == want == {"x": [2.0, 4.0, None], "s": [11.0, 22.0, None]}


def test_int_path_and_schema(ext_path):
    daft_tpu_torch.load_extension(ext_path)
    q = daft_tpu_torch.from_pydict({"i": [3, 4]}).select(
        daft_tpu_torch.call_function("ext_double", col("i")))
    assert q.schema["i"].dtype == daft_tpu_torch.DataType.int64()
    got, want = _both(ext_path, {"i": [3, 4]},
                      lambda p: [p.call_function("ext_double", p.col("i"))])
    assert got == want == {"i": [6, 8]}


def test_seeded_columns_with_nulls_match_reference(ext_path):
    """Seeded columns, nulls at every fifth row, through both packages."""
    rng = np.random.default_rng(0)
    n = 1000
    x = [None if i % 5 == 0 else float(v) for i, v in enumerate(rng.normal(size=n))]
    y = rng.normal(size=n).tolist()
    i64 = [None if i % 7 == 0 else int(v) for i, v in enumerate(rng.integers(-1 << 40, 1 << 40, n))]
    got, want = _both(ext_path, {"x": x, "y": y, "i": i64},
                      lambda p: [p.call_function("ext_add", p.col("x"), p.col("y")).alias("s"),
                                 p.call_function("ext_double", p.col("i")).alias("d")])
    assert got == want


def test_module_error_surface(ext_path):
    daft_tpu_torch.load_extension(ext_path)
    df = daft_tpu_torch.from_pydict({"s": ["a"]})
    with pytest.raises(ValueError, match="ext_double"):
        with execution_config_ctx(device="cpu"):
            df.select(daft_tpu_torch.call_function("ext_double", col("s"))).to_pydict()


def test_bad_library_rejected(tmp_path):
    p = tmp_path / "not_a_module.so"
    p.write_bytes(b"not elf")
    with pytest.raises((OSError, ValueError)):
        daft_tpu_torch.load_extension(str(p))


def test_library_without_the_magic_rejected(tmp_path):
    """A shared library that is not a module: refused with the reference's
    message."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    src = tmp_path / "plain.cpp"
    src.write_text("extern \"C\" int answer() { return 42; }\n")
    so = str(tmp_path / "libplain.so")
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", so], check=True,
                   capture_output=True)
    with pytest.raises(ValueError, match="missing daft_tpu_module_magic"):
        daft_tpu_torch.load_extension(so)


def test_bad_abi_version_rejected(tmp_path):
    """A module announcing another ABI version is refused."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    src = tmp_path / "v2.cpp"
    src.write_text(f'#include "{REPO}/native/include/daft_tpu_ext.h"\n'
                   "extern \"C\" DaftTpuModule daft_tpu_module_magic(void) {\n"
                   "  DaftTpuModule m = {}; m.abi_version = 99; m.name = \"v2\";\n"
                   "  return m; }\n")
    so = str(tmp_path / "libv2.so")
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", so], check=True,
                   capture_output=True)
    with pytest.raises(ValueError, match="ABI version 99"):
        daft_tpu_torch.load_extension(so)


@pytest.mark.parametrize("values,dtype", [
    ([1, None, 3], "int64"), ([1.5, None, -2.0], "float64"), ([True, None, False], "bool"),
    (["ab", None, "", "xyz"], "string"), ([7, 8, None], "int32"), ([1, 2, 3], "uint8")])
def test_c_data_interface_roundtrip(values, dtype):
    """The port's export and import of one column: the same values back,
    read through the structs alone (the exported side released first by
    its consumer, as a module would)."""
    from daft_tpu_torch import ext as pext
    from daft_tpu_torch.core.series import Series

    s = Series.from_pylist(values, "c", daft_tpu_torch.DataType(dtype))
    arr, sch = pext._ArrowArray(), pext._ArrowSchema()
    pext._export_array(arr, s)
    pext._export_schema(sch, s.field())
    back = pext._import_array(arr, sch, "c")
    pext._release_array(arr)
    pext._release_schema(sch)
    assert back.dtype == s.dtype and back.to_pylist() == values
    assert not arr.release and not sch.release
    assert ctypes.addressof(arr) not in pext._Exported.LIVE
