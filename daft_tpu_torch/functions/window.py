"""The ranking window functions (counterpart of daft_tpu/functions/
window.py); each is bound to a window with ``.over(Window(...))``."""

from __future__ import annotations

from ..expressions.expressions import _UnboundWindowFn


def row_number():
    return _UnboundWindowFn("row_number", None, {})


def rank():
    return _UnboundWindowFn("rank", None, {})


def dense_rank():
    return _UnboundWindowFn("dense_rank", None, {})


def percent_rank():
    return _UnboundWindowFn("percent_rank", None, {})


def cume_dist():
    return _UnboundWindowFn("cume_dist", None, {})


def ntile(n: int):
    return _UnboundWindowFn("ntile", None, {"n": n})
