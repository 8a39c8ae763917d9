"""The native extension ABI: load C/C++ modules that register scalar functions
(counterpart of daft_tpu/ext.py).

The contract is native/include/daft_tpu_ext.h; a module's shared library
exports

    DaftTpuModule daft_tpu_module_magic(void);

``load_extension(path)`` loads it with ctypes, checks its ABI version, and
registers each function the module defines in the scalar function registry,
after which ``call_function("name", args...)`` and SQL call it like a
built-in. Columns cross the boundary through the Arrow C Data Interface.
The reference exports and imports them with pyarrow's ``_export_to_c`` /
``_import_from_c``; the port has no pyarrow, so it fills ``ArrowSchema`` and
``ArrowArray`` itself from a Series' numpy planes and validity mask (values
and a packed validity bitmap, int32 or int64 offsets for strings and
binary) and reads the module's result arrays back the same way. The
buffers and the ``release`` callbacks (ctypes ``CFUNCTYPE`` objects) of an
exported array stay alive until the module calls ``release``; the host
calls a result's ``release`` once it has copied the result out.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np

from .core.series import Series
from .datatype import DataType, Field

DAFT_TPU_ABI_VERSION = 1
ARROW_FLAG_NULLABLE = 2


class _ArrowSchema(ctypes.Structure):
    pass


class _ArrowArray(ctypes.Structure):
    pass


_ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(_ArrowSchema))),
    ("dictionary", ctypes.POINTER(_ArrowSchema)),
    ("release", ctypes.c_void_p),
    ("private_data", ctypes.c_void_p),
]

_ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(_ArrowArray))),
    ("dictionary", ctypes.POINTER(_ArrowArray)),
    ("release", ctypes.c_void_p),
    ("private_data", ctypes.c_void_p),
]

_RELEASE_SCHEMA = ctypes.CFUNCTYPE(None, ctypes.POINTER(_ArrowSchema))
_RELEASE_ARRAY = ctypes.CFUNCTYPE(None, ctypes.POINTER(_ArrowArray))
_NAME_FN = ctypes.CFUNCTYPE(ctypes.c_char_p, ctypes.c_void_p)
_RET_FIELD_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_ArrowSchema), ctypes.c_size_t,
    ctypes.POINTER(_ArrowSchema), ctypes.POINTER(ctypes.c_char_p))
_CALL_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_ArrowArray),
    ctypes.POINTER(_ArrowSchema), ctypes.c_size_t, ctypes.POINTER(_ArrowArray),
    ctypes.POINTER(_ArrowSchema), ctypes.POINTER(ctypes.c_char_p))
_FINI_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class _ScalarFunction(ctypes.Structure):
    _fields_ = [
        ("ctx", ctypes.c_void_p),
        ("name", _NAME_FN),
        ("get_return_field", _RET_FIELD_FN),
        ("call", _CALL_FN),
        ("fini", _FINI_FN),
    ]


_DEFINE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, _ScalarFunction)


class _SessionContext(ctypes.Structure):
    _fields_ = [
        ("ctx", ctypes.c_void_p),
        ("define_function", _DEFINE_FN),
    ]


_INIT_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_SessionContext))
_FREE_STRING_FN = ctypes.CFUNCTYPE(None, ctypes.c_char_p)


class _Module(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("name", ctypes.c_char_p),
        ("init", _INIT_FN),
        ("free_string", _FREE_STRING_FN),
    ]


# ---- the C Data Interface, filled from numpy planes ----------------------------------

# Arrow format strings of the primitive kinds the port exchanges
_FORMATS = {"bool": "b", "int8": "c", "uint8": "C", "int16": "s", "uint16": "S",
            "int32": "i", "uint32": "I", "int64": "l", "uint64": "L", "float32": "f",
            "float64": "g", "date": "tdD", "string": "U", "binary": "Z", "null": "n"}
_KINDS = {v: k for k, v in _FORMATS.items()}
_KINDS.update({"u": "string", "z": "binary"})  # 32-bit offsets, read only
_TIME_UNITS = {"s": "s", "m": "ms", "u": "us", "n": "ns"}


def arrow_format(dtype: DataType) -> str:
    """The Arrow C format string of ``dtype`` (the reference exports what
    pyarrow gives for ``dtype.to_arrow()``: strings and binary large)."""
    if dtype.kind in ("timestamp", "duration"):
        unit = {v: k for k, v in _TIME_UNITS.items()}[dtype.params[0]]
        if dtype.kind == "duration":
            return f"tD{unit}"
        return f"ts{unit}:{dtype.params[1] or ''}"
    fmt = _FORMATS.get(dtype.kind)
    if fmt is None:
        raise TypeError(f"{dtype} does not cross the extension ABI in the port "
                        f"(primitives, dates, timestamps, durations, strings, binary)")
    return fmt


def dtype_of_format(fmt: str) -> DataType:
    if fmt.startswith("ts") or fmt.startswith("tD"):
        unit = _TIME_UNITS[fmt[2]]
        if fmt.startswith("tD"):
            return DataType.duration(unit)
        tz = fmt.split(":", 1)[1] if ":" in fmt else ""
        return DataType.timestamp(unit, tz or None)
    kind = _KINDS.get(fmt)
    if kind is None:
        raise TypeError(f"an extension returned the Arrow format {fmt!r}, which the port "
                        f"does not read")
    return DataType(kind)


class _Exported:
    """What one exported schema or array keeps alive until its consumer calls
    ``release``: the C strings, the buffers, the pointer array and the
    callback object itself."""

    LIVE: Dict[int, "_Exported"] = {}

    def __init__(self, *keep):
        self.keep = keep


def _export_schema(out: _ArrowSchema, field: Field) -> None:
    fmt = ctypes.create_string_buffer(arrow_format(field.dtype).encode())
    name = ctypes.create_string_buffer(field.name.encode())
    out.format = ctypes.cast(fmt, ctypes.c_char_p)
    out.name = ctypes.cast(name, ctypes.c_char_p)
    out.metadata = None
    out.flags = ARROW_FLAG_NULLABLE
    out.n_children = 0
    out.children = None
    out.dictionary = None
    addr = ctypes.addressof(out)

    def release(p) -> None:
        p.contents.release = None
        _Exported.LIVE.pop(ctypes.addressof(p.contents), None)

    cb = _RELEASE_SCHEMA(release)
    _Exported.LIVE[addr] = _Exported(fmt, name, cb)
    out.release = ctypes.cast(cb, ctypes.c_void_p)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=bool), bitorder="little")


def _planes(s: Series):
    """(buffers as numpy arrays, null count) of a Series in Arrow's layout."""
    valid = s.validity_numpy()
    nulls = int(len(valid) - int(valid.sum()))
    validity = _pack_bits(valid) if nulls else None
    kind = s.dtype.kind
    if kind == "null":
        return [], len(s)
    if kind in ("string", "binary"):
        vals = s.to_pylist()
        items = [b"" if v is None else (v.encode() if isinstance(v, str) else bytes(v))
                 for v in vals]
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in items], out=offsets[1:])
        data = np.frombuffer(b"".join(items) or b"\0", dtype=np.uint8)
        return [validity, offsets, data], nulls
    if kind == "bool":
        data = _pack_bits(np.where(valid, s._values.astype(bool), False))
    else:
        data = np.ascontiguousarray(np.asarray(s._values).view(
            s.dtype.to_numpy() if kind not in ("date", "timestamp", "duration")
            else (np.int32 if kind == "date" else np.int64)))
    return [validity, data], nulls


def _export_array(out: _ArrowArray, s: Series) -> None:
    bufs, nulls = _planes(s)
    ptrs = (ctypes.c_void_p * max(len(bufs), 1))()
    for i, b in enumerate(bufs):
        ptrs[i] = None if b is None else b.ctypes.data
    out.length = len(s)
    out.null_count = nulls
    out.offset = 0
    out.n_buffers = len(bufs)
    out.n_children = 0
    out.buffers = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p))
    out.children = None
    out.dictionary = None

    def release(p) -> None:
        p.contents.release = None
        _Exported.LIVE.pop(ctypes.addressof(p.contents), None)

    cb = _RELEASE_ARRAY(release)
    _Exported.LIVE[ctypes.addressof(out)] = _Exported(bufs, ptrs, cb)
    out.release = ctypes.cast(cb, ctypes.c_void_p)


def _release_schema(s: _ArrowSchema) -> None:
    if s.release:
        _RELEASE_SCHEMA(s.release)(ctypes.byref(s))


def _release_array(a: _ArrowArray) -> None:
    if a.release:
        _RELEASE_ARRAY(a.release)(ctypes.byref(a))


def _bits(ptr: int, offset: int, n: int) -> np.ndarray:
    nbytes = (offset + n + 7) // 8
    raw = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                                shape=(max(nbytes, 1),))[:nbytes]
    return np.unpackbits(raw, bitorder="little")[offset:offset + n].astype(bool)


def _import_array(arr: _ArrowArray, schema: _ArrowSchema, name: str) -> Series:
    """A Series copied out of an array the module made (its buffers stay the
    module's, released by the caller)."""
    dtype = dtype_of_format(schema.format.decode())
    n, off = int(arr.length), int(arr.offset)
    bufs = [arr.buffers[i] for i in range(int(arr.n_buffers))]
    if dtype.kind == "null":
        return Series.from_pylist([None] * n, name, dtype=dtype)
    valid = _bits(bufs[0], off, n) if bufs and bufs[0] and arr.null_count != 0 \
        else np.ones(n, dtype=bool)
    if dtype.kind in ("string", "binary"):
        large = schema.format.decode() in ("U", "Z")
        odt = ctypes.c_int64 if large else ctypes.c_int32
        offsets = np.ctypeslib.as_array(ctypes.cast(bufs[1], ctypes.POINTER(odt)),
                                        shape=(off + n + 1,)).astype(np.int64)
        total = int(offsets[-1])
        data = ctypes.string_at(bufs[2], total) if total else b""
        vals = [data[offsets[off + i]:offsets[off + i + 1]] if valid[i] else None
                for i in range(n)]
        if dtype.kind == "string":
            vals = [None if v is None else v.decode() for v in vals]
        return Series.from_pylist(vals, name, dtype=dtype)
    if dtype.kind == "bool":
        values = _bits(bufs[1], off, n)
    else:
        np_dt = np.dtype(np.int32 if dtype.kind == "date" else
                         np.int64 if dtype.kind in ("timestamp", "duration") else
                         dtype.to_numpy())
        ctype = np.ctypeslib.as_ctypes_type(np_dt)
        values = np.ctypeslib.as_array(ctypes.cast(bufs[1], ctypes.POINTER(ctype)),
                                       shape=(off + n,))[off:].copy()
        if dtype.kind in ("date", "timestamp", "duration"):
            values = values.view(dtype.to_numpy())
    values = np.where(valid, values, np.zeros((), dtype=values.dtype))
    return Series.from_numpy(values, name, dtype=dtype, validity=valid)


# ---- modules and their functions ---------------------------------------------------


class ExtensionFunction:
    """One function of a loaded module: evaluated by exporting the argument
    columns through the C Data Interface, calling the module, and reading
    its result array back; registered in the scalar function registry."""

    def __init__(self, vtable: _ScalarFunction, module: "Extension"):
        self._vt = vtable
        self._module = module
        self.name = vtable.name(vtable.ctx).decode()

    def _err(self, errmsg: ctypes.c_char_p) -> str:
        msg = errmsg.value.decode() if errmsg.value else "unknown extension error"
        # the module frees its own allocation
        self._module._mod.free_string(errmsg)
        return msg

    def return_field(self, fields: List[Field]) -> DataType:
        schemas = (_ArrowSchema * max(len(fields), 1))()
        for i, f in enumerate(fields):
            _export_schema(schemas[i], f)
        ret = _ArrowSchema()
        errmsg = ctypes.c_char_p()
        try:
            rc = self._vt.get_return_field(self._vt.ctx, schemas, len(fields),
                                           ctypes.byref(ret), ctypes.byref(errmsg))
        finally:
            for i in range(len(fields)):
                _release_schema(schemas[i])
        if rc != 0:
            raise ValueError(f"{self.name}: {self._err(errmsg)}")
        try:
            return dtype_of_format(ret.format.decode())
        finally:
            _release_schema(ret)

    def __call__(self, series_args: List[Series], kwargs) -> Series:
        n = len(series_args)
        arrays = (_ArrowArray * max(n, 1))()
        schemas = (_ArrowSchema * max(n, 1))()
        for i, s in enumerate(series_args):
            _export_array(arrays[i], s)
            _export_schema(schemas[i], Field(s.name, s.dtype))
        ret_array = _ArrowArray()
        ret_schema = _ArrowSchema()
        errmsg = ctypes.c_char_p()
        try:
            rc = self._vt.call(self._vt.ctx, arrays, schemas, n,
                               ctypes.byref(ret_array), ctypes.byref(ret_schema),
                               ctypes.byref(errmsg))
        finally:
            for i in range(n):
                _release_array(arrays[i])
                _release_schema(schemas[i])
        if rc != 0:
            raise ValueError(f"{self.name}: {self._err(errmsg)}")
        name = series_args[0].name if series_args else self.name
        try:
            return _import_array(ret_array, ret_schema, name)
        finally:
            _release_array(ret_array)
            _release_schema(ret_schema)


class Extension:
    """One loaded module: its name, its functions, the library."""

    def __init__(self, path: str):
        self.path = path
        self._lib = ctypes.CDLL(path)
        magic = getattr(self._lib, "daft_tpu_module_magic", None)
        if magic is None:
            raise ValueError(f"{path}: not a daft_tpu extension "
                             f"(missing daft_tpu_module_magic)")
        magic.restype = _Module
        self._mod = magic()
        if self._mod.abi_version != DAFT_TPU_ABI_VERSION:
            raise ValueError(f"{path}: ABI version {self._mod.abi_version} != "
                             f"host {DAFT_TPU_ABI_VERSION}")
        self.name = self._mod.name.decode()
        self.functions: Dict[str, ExtensionFunction] = {}

        def _define(_ctx, fn_vtable) -> int:
            try:
                # a copy: the argument lives only during the call
                vt = _ScalarFunction()
                ctypes.memmove(ctypes.byref(vt), ctypes.byref(fn_vtable),
                               ctypes.sizeof(_ScalarFunction))
                f = ExtensionFunction(vt, self)
                self.functions[f.name] = f
                return 0
            except Exception:  # noqa: BLE001 -- the C boundary: the error is rc 1
                return 1

        self._define_cb = _DEFINE_FN(_define)  # kept alive with the module
        self._session = _SessionContext(ctx=None, define_function=self._define_cb)
        rc = self._mod.init(ctypes.byref(self._session))
        if rc != 0:
            raise ValueError(f"{path}: module init failed ({rc})")


def load_extension(path: str) -> Extension:
    """Load a native extension module and register its scalar functions."""
    ext = Extension(path)
    from .functions.registry import register

    for fname, f in ext.functions.items():
        def _rt(fields, kwargs, _f=f):
            return _f.return_field(fields)

        def _host(series_list, kwargs, _f=f):
            return _f(series_list, kwargs)

        register(fname, _rt, _host)
    return ext


def call_function(name: str, *args, **kwargs):
    """An expression calling a registered scalar function (a built-in or an
    extension's) by name (the reference's ``daft_tpu.call_function``)."""
    from .dataframe.dataframe import _to_expr
    from .expressions.expressions import Function

    return Function(name, [_to_expr(a) for a in args], kwargs or None)
