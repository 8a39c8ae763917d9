"""User-defined functions (counterpart of daft_tpu/udf/udf.py).

``@func`` wraps a Python function as a scalar UDF: row-wise by default (it
receives Python values), or a batch UDF (``is_batch=True``: Series in,
Series or a sequence out). ``@cls`` wraps a stateful class built once per
process on first use, ``@method`` marks its UDF methods, and ``@udf`` is the
legacy batch decorator.

``on_device=True`` marks a device UDF: ``fn(params, *tensors) -> tensor``, a
batch function on torch tensors whose output rows align with its input
rows. The executor runs it as a device stage (ops/udf_stage.py): its
weights, ``device_params()``, resident on the card, morsels coalesced, one
copy back per run.

The reference's process tier (``use_process=True``,
daft_tpu/execution/udf_process.py) is not ported: asking for it raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

from ..datatype import DataType

_PROCESS_TIER = ("use_process=True asks for the process tier (the reference's "
                 "daft_tpu/execution/udf_process.py), which the port does not have yet")


@dataclasses.dataclass
class Func:
    fn: Callable
    return_dtype: DataType
    is_batch: bool = False
    is_async: bool = False
    is_generator: bool = False
    batch_size: Optional[int] = None
    max_concurrency: Optional[int] = None
    use_process: bool = False
    name: str = "udf"
    # ---- the device-UDF tier (ops/udf_stage.py) -----------------------------------
    # fn(params, *tensors) -> tensor, on the stage's device; batch_size caps the
    # rows of one dispatch
    on_device: bool = False
    # () -> the weights, a dict of numpy arrays (nested dicts and lists allowed),
    # called once per process; the tier keeps them resident under a content
    # fingerprint of their bytes. None: a stateless fn (params is None)
    device_params: Optional[Callable] = None
    # True: device_params() returns a dict whose top-level entries are kept
    # resident each on their own, so a part shared between Funcs (one encoder
    # under embed and every classify label set) is one entry per process
    device_params_split: bool = False
    # host preprocess per morsel (tokenization): (*argument pylists) -> a tuple
    # of row-aligned numpy arrays fed to fn. None: each argument's values
    device_prepare: Optional[Callable] = None
    # host postprocess: (numpy output rows) -> a list of Python values (label
    # strings from argmax codes). None: the output rows as they are
    device_finish: Optional[Callable] = None
    # the reference's program-cache key, accepted for its API: the port calls
    # fn itself and keeps no program cache
    device_key: Optional[str] = None

    def __post_init__(self) -> None:
        if self.use_process:
            raise NotImplementedError(_PROCESS_TIER)

    def __call__(self, *args, **kwargs):
        from ..expressions.expressions import Expression, lit
        from .expr import UdfCall

        exprs = [a if isinstance(a, Expression) else lit(a) for a in args]
        return UdfCall(self, exprs, kwargs)


def func(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None,
         is_batch: bool = False, batch_size: Optional[int] = None,
         max_concurrency: Optional[int] = None, use_process: bool = False,
         on_device: bool = False, device_params: Optional[Callable] = None,
         device_prepare: Optional[Callable] = None,
         device_finish: Optional[Callable] = None, device_key: Optional[str] = None):
    """``@func``: wrap a Python function as a scalar UDF. The return dtype is
    ``return_dtype`` or the return annotation's. ``on_device=True`` marks a
    device UDF ``fn(params, *tensors) -> tensor`` (see the module)."""

    def wrap(f: Callable) -> Func:
        rdt = return_dtype
        if rdt is None:
            rdt = _dtype_from_hint(inspect.signature(f).return_annotation)
        return Func(
            fn=f,
            return_dtype=rdt,
            is_batch=is_batch or on_device,
            is_async=inspect.iscoroutinefunction(f),
            # a batch function returns whole Series: generators are row-wise only
            is_generator=inspect.isgeneratorfunction(f) and not (is_batch or on_device),
            batch_size=batch_size,
            max_concurrency=max_concurrency,
            use_process=use_process,
            name=getattr(f, "__name__", "udf"),
            on_device=on_device,
            device_params=device_params,
            device_prepare=device_prepare,
            device_finish=device_finish,
            device_key=device_key,
        )

    if fn is not None:
        return wrap(fn)
    return wrap


def _dtype_from_hint(hint) -> DataType:
    import typing

    mapping = {int: DataType.int64(), float: DataType.float64(), str: DataType.string(),
               bool: DataType.bool()}
    if hint in mapping:
        return mapping[hint]
    if hint is inspect.Signature.empty or hint is None:
        raise ValueError("UDF needs a return dtype: pass return_dtype= or annotate the "
                         "function's return type")
    if typing.get_origin(hint) in (list, typing.List):
        (inner,) = typing.get_args(hint) or (None,)
        if inner in mapping:
            return DataType.list(mapping[inner])
    return DataType.python()


class _ClsWrapper:
    """A user class under ``@cls``; calling it records the constructor's
    arguments and returns a lazy instance whose methods build UDF calls."""

    def __init__(self, klass, max_concurrency: Optional[int], use_process: bool):
        if use_process:
            raise NotImplementedError(_PROCESS_TIER)
        self._klass = klass
        self._max_concurrency = max_concurrency

    def __call__(self, *args, **kwargs) -> "_ClsInstance":
        return _ClsInstance(self, args, kwargs)


class _ClsInstance:
    """Deferred instance: the real object is built once per process on first
    use (a model loads where it runs, not where the plan is built)."""

    def __init__(self, wrapper: _ClsWrapper, init_args, init_kwargs):
        object.__setattr__(self, "_wrapper", wrapper)
        object.__setattr__(self, "_init_args", init_args)
        object.__setattr__(self, "_init_kwargs", init_kwargs)
        object.__setattr__(self, "_obj", None)
        object.__setattr__(self, "_method_funcs", {})

    def _materialize(self):
        if self._obj is None:
            obj = self._wrapper._klass(*self._init_args, **self._init_kwargs)
            object.__setattr__(self, "_obj", obj)
        return self._obj

    def __getattr__(self, name: str):
        # the proxy's own internals must fail fast while unpickling rebuilds it
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            method_funcs = object.__getattribute__(self, "_method_funcs")
            wrapper = object.__getattribute__(self, "_wrapper")
        except AttributeError:
            raise AttributeError(name) from None
        cached = method_funcs.get(name)
        if cached is not None:
            return cached
        klass = wrapper._klass
        target = getattr(klass, name, None)
        if target is None:
            raise AttributeError(name)
        if not callable(target):
            return getattr(self._materialize(), name)
        rdt = getattr(target, "__udf_return_dtype__", None)
        if rdt is None:
            try:
                rdt = _dtype_from_hint(inspect.signature(target).return_annotation)
            except ValueError:
                rdt = DataType.python()
        inst = self

        def bound(*vals, **kw):
            return getattr(inst._materialize(), name)(*vals, **kw)

        on_device = bool(getattr(target, "__udf_on_device__", False))
        hooks = {}
        if on_device:
            # the device hooks resolve off the lazily built instance: the model
            # loads once per process like any other @cls state
            for hook in ("device_params", "device_prepare", "device_finish"):
                if getattr(klass, hook, None) is not None:
                    hooks[hook] = _instance_hook(inst, hook)
        f = Func(
            fn=bound,
            return_dtype=rdt,
            is_batch=bool(getattr(target, "__udf_is_batch__", False)) or on_device,
            is_async=inspect.iscoroutinefunction(target),
            is_generator=inspect.isgeneratorfunction(target),
            max_concurrency=wrapper._max_concurrency,
            name=f"{klass.__name__}.{name}",
            on_device=on_device,
            device_key=getattr(target, "__udf_device_key__", None),
            batch_size=getattr(target, "__udf_batch_size__", None),
            **hooks,
        )
        method_funcs[name] = f
        return f


def _instance_hook(inst: _ClsInstance, hook: str) -> Callable:
    """The instance's ``hook`` method, called on the built instance."""
    return lambda *args: getattr(inst._materialize(), hook)(*args)


def cls(klass=None, *, max_concurrency: Optional[int] = None, use_process: bool = False):
    """``@cls``: a stateful UDF class, built once per process on first use::

        @cls
        class Embedder:
            def __init__(self, model): self.m = load(model)
            def embed(self, text: str) -> float: ...

        e = Embedder("small")                 # lazy: nothing loads here
        df.select(e.embed(col("text")))       # loads once
    """
    if klass is not None:
        return _ClsWrapper(klass, max_concurrency, use_process)
    return lambda k: _ClsWrapper(k, max_concurrency, use_process)


def method(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None,
           is_batch: bool = False, on_device: bool = False,
           batch_size: Optional[int] = None, device_key: Optional[str] = None):
    """Mark a method of a ``@cls`` class as a UDF with an explicit return
    dtype (else its annotation's). ``on_device=True``: the method is
    ``(self, params, *tensors) -> tensor`` on the device tier, and the class's
    ``device_params()`` (with the optional ``device_prepare`` and
    ``device_finish``) gives its weights; ``batch_size`` caps a dispatch;
    ``device_key`` is the reference's program-cache key (unused here)."""

    def wrap(f):
        f.__udf_method__ = True
        f.__udf_return_dtype__ = return_dtype
        f.__udf_is_batch__ = is_batch
        f.__udf_on_device__ = on_device
        f.__udf_batch_size__ = batch_size
        f.__udf_device_key__ = device_key
        return f

    if fn is not None:
        return wrap(fn)
    return wrap


def udf(*, return_dtype: DataType, batch_size: Optional[int] = None,
        max_concurrency: Optional[int] = None, use_process: bool = False):
    """The legacy ``@udf`` decorator: a batch UDF taking Series."""

    def wrap(f: Callable) -> Func:
        return Func(fn=f, return_dtype=return_dtype, is_batch=True, batch_size=batch_size,
                    max_concurrency=max_concurrency, use_process=use_process,
                    name=getattr(f, "__name__", "udf"))

    return wrap
