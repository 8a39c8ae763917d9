"""The UDF call expression (counterpart of daft_tpu/udf/expr.py).

The optimizer's ``rule_split_udfs`` isolates each call into a ``UDFProject``
plan node, so opaque Python never sits inside a device stage's expressions.
``eval_host`` runs a call on the host: row UDFs one row at a time (literal
arguments broadcast), batch UDFs on whole Series, generators into lists and
async UDFs concurrently under ``max_concurrency``. A device Func on the host
path goes through ``host_eval_device_func`` (ops/udf_stage.py).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

from ..core.series import Series
from ..datatype import DataType, Field
from ..expressions.expressions import Expression
from ..schema import Schema


class UdfCall(Expression):
    def __init__(self, func, args: List[Expression], kwargs: Dict[str, Any]):
        self.func = func
        self.args = args
        self.kwargs = kwargs

    def name(self) -> str:
        return self.args[0].name() if self.args else self.func.name

    def children(self) -> List[Expression]:
        return list(self.args)

    def with_children(self, children):
        return UdfCall(self.func, children, self.kwargs)

    def to_field(self, schema: Schema) -> Field:
        dt = self.func.return_dtype
        if self.func.is_generator:
            dt = DataType.list(dt)
        return Field(self.name(), dt)

    def __repr__(self):
        inner = ", ".join(repr(a) for a in self.args)
        return f"udf:{self.func.name}({inner})"

    def eval_host(self, arg_series: List[Series], num_rows: int) -> Series:
        f = self.func
        out_name = self.name()

        if f.on_device:
            # the device contract is positional tensors only: dropping kwargs
            # would run fn without them and give wrong results silently
            if self.kwargs:
                raise TypeError(f"device UDF {f.name!r} does not accept keyword arguments "
                                f"(got {sorted(self.kwargs)}); the contract is "
                                "fn(params, *tensors)")
            from ..ops.udf_stage import host_eval_device_func

            return host_eval_device_func(f, arg_series, num_rows, out_name)

        if f.is_batch:
            out = f.fn(*arg_series, **self.kwargs)
            if not isinstance(out, Series):
                out = Series.from_pylist(list(out), f.name, f.return_dtype)
            return out.rename(out_name)

        cols = [s.to_pylist() for s in arg_series]
        cols = [c * num_rows if len(c) == 1 and num_rows != 1 else c for c in cols]

        if f.is_generator:
            results = [list(f.fn(*vals, **self.kwargs)) for vals in zip(*cols)]
            return Series.from_pylist(results, out_name, DataType.list(f.return_dtype))

        if f.is_async:
            limit = f.max_concurrency or 256

            async def run_all():
                sem = asyncio.Semaphore(limit)

                async def one(vals):
                    async with sem:
                        return await f.fn(*vals, **self.kwargs)

                return await asyncio.gather(*(one(vals) for vals in zip(*cols)))

            results = asyncio.run(run_all())
        else:
            results = [f.fn(*vals, **self.kwargs) for vals in zip(*cols)]
        return Series.from_pylist(results, out_name, f.return_dtype)
