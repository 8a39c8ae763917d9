from .ai import classify_text, embed_image, embed_text, llm_generate, prompt
from .window import cume_dist, dense_rank, ntile, percent_rank, rank, row_number

__all__ = ["classify_text", "cume_dist", "dense_rank", "embed_image", "embed_text",
           "llm_generate", "ntile", "percent_rank", "prompt", "rank", "row_number"]
