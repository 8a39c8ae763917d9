from .ai import classify_text, embed_image, embed_text, llm_generate, prompt

__all__ = ["classify_text", "embed_image", "embed_text", "llm_generate", "prompt"]
