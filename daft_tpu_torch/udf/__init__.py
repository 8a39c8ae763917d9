import sys
import types

from .expr import UdfCall
from .udf import Func, cls, func, method, udf

__all__ = ["Func", "cls", "func", "method", "udf", "UdfCall"]


class _CallableModule(types.ModuleType):
    """``daft_tpu_torch.udf`` is this package (so ``import daft_tpu_torch.udf
    as m; m.cls`` works) and ``daft_tpu_torch.udf(return_dtype=...)`` the
    legacy decorator, as in the reference."""

    def __call__(self, *args, **kwargs):
        return udf(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
