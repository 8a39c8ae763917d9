"""AI providers (counterpart of daft_tpu/ai/provider.py): a registry of
``Provider`` objects whose ``get_*`` methods make task objects lazily (a
model loads on its first batch, where it runs, never while a plan is
built).

Built in: "torch", the encoder on the engine's own device
(ai/torch_provider.py; the reference's "jax"), and "dummy", deterministic
hash-based answers for tests and offline pipelines. The reference's
"transformers" and "openai" providers need packages or a network that the
port's card does not have (ROADMAP).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_PROVIDERS: Dict[str, "Provider"] = {}
# the built-ins register lazily from whichever thread asks first
_PROVIDERS_LOCK = threading.Lock()


class Provider:
    name = "provider"

    def get_text_embedder(self, model: Optional[str] = None, **options):
        raise NotImplementedError(f"{self.name} has no text embedder")

    def get_image_embedder(self, model: Optional[str] = None, **options):
        raise NotImplementedError(f"{self.name} has no image embedder")

    def get_text_classifier(self, model: Optional[str] = None, **options):
        raise NotImplementedError(f"{self.name} has no text classifier")

    def get_prompter(self, model: Optional[str] = None, **options):
        raise NotImplementedError(f"{self.name} has no prompter")


def register_provider(provider: Provider, name: Optional[str] = None) -> None:
    with _PROVIDERS_LOCK:
        _PROVIDERS[(name or provider.name).lower()] = provider


def get_provider(name: str) -> Provider:
    key = name.lower()
    if key not in _PROVIDERS:
        if key == "dummy":
            register_provider(DummyProvider())
        elif key == "torch":
            from .torch_provider import TorchProvider

            register_provider(TorchProvider())
        else:
            raise ValueError(f"unknown AI provider {name!r}; registered: {sorted(_PROVIDERS)}")
    return _PROVIDERS[key]


class DummyProvider(Provider):
    """Deterministic hash-based answers for tests and offline pipelines."""

    name = "dummy"

    class _Embedder:
        dimensions = 16

        def embed_text(self, texts):
            import numpy as np

            out = []
            for t in texts:
                rng = np.random.default_rng(abs(hash(t)) % (2**32))
                v = rng.standard_normal(self.dimensions).astype(np.float32)
                out.append(v / np.linalg.norm(v))
            return out

    class _Classifier:
        def classify_text(self, texts, labels):
            return [labels[abs(hash(t)) % len(labels)] for t in texts]

    class _ImageEmbedder:
        dimensions = 16

        def embed_image(self, images):
            import numpy as np

            out = []
            for img in images:
                data = bytes(img) if isinstance(img, (bytes, bytearray)) \
                    else np.asarray(img).tobytes()
                rng = np.random.default_rng(abs(hash(data)) % (2**32))
                v = rng.standard_normal(self.dimensions).astype(np.float32)
                out.append(v / np.linalg.norm(v))
            return out

    class _Prompter:
        def __init__(self, model):
            self.model = model or "dummy-1"

        def prompt(self, prompts):
            # a deterministic echo "generation"
            return [f"[{self.model}] {p[:64]}" for p in prompts]

    def get_text_embedder(self, model=None, **options):
        return DummyProvider._Embedder()

    def get_image_embedder(self, model=None, **options):
        return DummyProvider._ImageEmbedder()

    def get_text_classifier(self, model=None, **options):
        return DummyProvider._Classifier()

    def get_prompter(self, model=None, **options):
        return DummyProvider._Prompter(model)
