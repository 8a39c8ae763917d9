"""The window specification (counterpart of daft_tpu/window.py).

    Window().partition_by("k").order_by("t", desc=True).rows_between(
        Window.unbounded_preceding, Window.current_row)

``partition_by`` and ``order_by`` take column names or expressions;
``order_by``'s ``nulls_first`` defaults to ``desc`` (nulls last ascending,
first descending). A frame is ``rows_between`` (row offsets) or
``range_between`` (offsets of the one numeric ORDER BY key), each bound an
integer (negative = preceding) or a marker, with ``min_periods`` rows for a
non-null aggregate. With no frame, an ordered window aggregates from the
partition's start through the current row's peers, and an unordered one
over the whole partition.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union


class Window:
    """An immutable window spec, built by chaining."""

    unbounded_preceding = object()
    unbounded_following = object()
    current_row = 0

    def __init__(self):
        self.partition_by_exprs: List = []
        self.order_by_exprs: List = []
        self.descending: List[bool] = []
        self.nulls_first: List[bool] = []
        self.frame_type: Optional[str] = None  # "rows" | "range"; None = the default
        self.frame_start = None
        self.frame_end = None
        self.min_periods: int = 1

    def _copy(self) -> "Window":
        w = Window.__new__(Window)
        w.partition_by_exprs = list(self.partition_by_exprs)
        w.order_by_exprs = list(self.order_by_exprs)
        w.descending = list(self.descending)
        w.nulls_first = list(self.nulls_first)
        w.frame_type = self.frame_type
        w.frame_start = self.frame_start
        w.frame_end = self.frame_end
        w.min_periods = self.min_periods
        return w

    def partition_by(self, *cols) -> "Window":
        from .dataframe.dataframe import _to_exprs

        w = self._copy()
        w.partition_by_exprs.extend(_to_exprs(cols))
        return w

    def order_by(self, *cols, desc: Union[bool, Sequence[bool]] = False,
                 nulls_first: Optional[Union[bool, Sequence[bool]]] = None) -> "Window":
        from .dataframe.dataframe import _to_exprs

        w = self._copy()
        exprs = _to_exprs(cols)
        descs = [desc] * len(exprs) if isinstance(desc, bool) else list(desc)
        if nulls_first is None:
            nfs = list(descs)
        elif isinstance(nulls_first, bool):
            nfs = [nulls_first] * len(exprs)
        else:
            nfs = list(nulls_first)
        w.order_by_exprs.extend(exprs)
        w.descending.extend(descs)
        w.nulls_first.extend(nfs)
        return w

    def rows_between(self, start, end, min_periods: int = 1) -> "Window":
        w = self._copy()
        w.frame_type, w.frame_start, w.frame_end, w.min_periods = "rows", start, end, min_periods
        return w

    def range_between(self, start, end, min_periods: int = 1) -> "Window":
        w = self._copy()
        w.frame_type, w.frame_start, w.frame_end, w.min_periods = "range", start, end, min_periods
        return w

    def __repr__(self) -> str:
        # every field that changes the result: the optimizer merges specs by it
        parts = []
        if self.partition_by_exprs:
            parts.append(f"partition_by={[repr(e) for e in self.partition_by_exprs]}")
        if self.order_by_exprs:
            parts.append(f"order_by={[repr(e) for e in self.order_by_exprs]}"
                         f" desc={self.descending} nulls_first={self.nulls_first}")
        if self.frame_type:
            def b(x):
                if x is Window.unbounded_preceding:
                    return "unbounded_preceding"
                if x is Window.unbounded_following:
                    return "unbounded_following"
                return str(x)

            parts.append(f"{self.frame_type}=[{b(self.frame_start)},{b(self.frame_end)}]"
                         f" min_periods={self.min_periods}")
        return "Window(" + ", ".join(parts) + ")"
