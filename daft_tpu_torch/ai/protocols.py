"""AI task protocols (counterpart of daft_tpu/ai/protocols.py): what a
provider's task objects offer."""

from __future__ import annotations

from typing import Any, List, Protocol, runtime_checkable


@runtime_checkable
class TextEmbedder(Protocol):
    def embed_text(self, texts: List[str]) -> List[Any]: ...

    @property
    def dimensions(self) -> int: ...


@runtime_checkable
class ImageEmbedder(Protocol):
    def embed_image(self, images: List[Any]) -> List[Any]: ...

    @property
    def dimensions(self) -> int: ...


@runtime_checkable
class TextClassifier(Protocol):
    def classify_text(self, texts: List[str], labels: List[str]) -> List[str]: ...


@runtime_checkable
class Prompter(Protocol):
    def prompt(self, prompts: List[str]) -> List[str]: ...
