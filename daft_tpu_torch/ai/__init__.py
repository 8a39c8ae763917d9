from .protocols import ImageEmbedder, Prompter, TextClassifier, TextEmbedder
from .provider import Provider, get_provider, register_provider

__all__ = [
    "Provider", "get_provider", "register_provider",
    "TextEmbedder", "ImageEmbedder", "TextClassifier", "Prompter",
]
