"""AI expression functions (counterpart of daft_tpu/functions/ai.py):
``embed_text``, ``classify_text``, ``prompt``, ``embed_image`` and
``llm_generate`` over the provider registry (ai/provider.py).

``provider="torch"`` makes ``embed_text`` and ``classify_text`` device UDFs
(ops/udf_stage.py: the encoder runs on the card with its weights resident;
``batch_size`` caps a dispatch); every other provider, and the other
functions, run as host batch UDFs whose task object loads on the first
batch. A null input gives a null output.
"""

from __future__ import annotations

from typing import List, Optional

from ..datatype import DataType
from ..expressions.expressions import Expression
from ..udf.udf import Func


def _device_options(fname: str, options: dict) -> Optional[int]:
    batch_size = options.pop("batch_size", None)
    if options:
        raise TypeError(f"{fname}(provider='torch') got unsupported options "
                        f"{sorted(options)}; the device tier takes batch_size only")
    return batch_size


def _provider_udf(expr: Expression, fname: str, return_dtype: DataType, make, call,
                  max_concurrency: Optional[int] = None, use_process: bool = False):
    """A host batch UDF: ``make()`` builds the task object on the first
    batch, ``call(task, values)`` maps the non-null values."""
    from ..core.series import Series

    state = {}

    def run(s: Series) -> Series:
        if "task" not in state:
            state["task"] = make()
        values = s.to_pylist()
        it = iter(call(state["task"], [v for v in values if v is not None]))
        out = [None if v is None else next(it) for v in values]
        return Series.from_pylist(out, s.name, return_dtype)

    return Func(fn=run, return_dtype=return_dtype, is_batch=True, name=fname,
                max_concurrency=max_concurrency, use_process=use_process)(expr)


def _vectors(vecs) -> list:
    return [list(map(float, v)) for v in vecs]


def embed_text(expr: Expression, provider: str = "transformers",
               model: Optional[str] = None, **options) -> Expression:
    """Embed a text column with the named provider's model."""
    if provider == "torch":
        from ..ai.torch_provider import torch_embed_func

        return torch_embed_func(model, _device_options("embed_text", options))(expr)
    from ..ai.provider import get_provider

    return _provider_udf(
        expr, "embed_text", DataType.list(DataType.float32()),
        lambda: get_provider(provider).get_text_embedder(model, **options),
        lambda task, texts: _vectors(task.embed_text(texts)))


def classify_text(expr: Expression, labels: List[str], provider: str = "dummy",
                  model: Optional[str] = None, **options) -> Expression:
    """Zero-shot classify a text column into ``labels``. With
    ``provider="torch"`` the encoder and the label argmax run as one device
    function and only int32 codes come back."""
    if provider == "torch":
        from ..ai.torch_provider import torch_classify_func

        return torch_classify_func(labels, model,
                                   _device_options("classify_text", options))(expr)
    from ..ai.provider import get_provider

    return _provider_udf(
        expr, "classify_text", DataType.string(),
        lambda: get_provider(provider).get_text_classifier(model, **options),
        lambda task, texts: task.classify_text(texts, labels))


def prompt(expr: Expression, provider: str, model: Optional[str] = None,
           **options) -> Expression:
    """Each prompt's answer from the provider's prompter."""
    from ..ai.provider import get_provider

    return _provider_udf(expr, "prompt", DataType.string(),
                         lambda: get_provider(provider).get_prompter(model, **options),
                         lambda task, texts: task.prompt(texts))


def embed_image(expr: Expression, provider: str = "dummy", model: Optional[str] = None,
                **options) -> Expression:
    """Embed an image column with the provider's image embedder."""
    from ..ai.provider import get_provider

    return _provider_udf(expr, "embed_image", DataType.list(DataType.float32()),
                         lambda: get_provider(provider).get_image_embedder(model, **options),
                         lambda task, images: _vectors(task.embed_image(images)))


def llm_generate(expr: Expression, provider: str = "dummy", model: Optional[str] = None,
                 max_concurrency: int = 1, use_process: bool = False,
                 **options) -> Expression:
    """Generation over the provider's prompter as a batched stateful UDF
    (the optimizer isolates it into its own UDFProject). The reference's
    ``use_process=True`` replicas run on its process tier, which the port
    does not have: asking for it raises NotImplementedError."""
    from ..ai.provider import get_provider

    return _provider_udf(expr, "llm_generate", DataType.string(),
                         lambda: get_provider(provider).get_prompter(model, **options),
                         lambda task, texts: task.prompt(texts),
                         max_concurrency=max_concurrency, use_process=use_process)
