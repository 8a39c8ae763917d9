"""Runner registry (counterpart of daft_tpu/runners/__init__.py):
``DAFT_TPU_RUNNER`` names the runner, "native" (the default and the only
one the port has)."""

from __future__ import annotations

import os
from typing import Optional

from .native import NativeRunner, Runner

_RUNNER: Optional[Runner] = None


def get_or_create_runner() -> Runner:
    global _RUNNER
    if _RUNNER is None:
        name = os.environ.get("DAFT_TPU_RUNNER", "native").lower()
        if name == "native":
            _RUNNER = NativeRunner()
        else:
            raise ValueError(f"unknown runner {name!r}")
    return _RUNNER


def set_runner(runner: Runner) -> None:
    global _RUNNER
    _RUNNER = runner


__all__ = ["Runner", "NativeRunner", "get_or_create_runner", "set_runner"]
