from .ai import classify_text, embed_image, embed_text, llm_generate, prompt
from .registry import FunctionSpec, get_function, has_function, register
from .window import cume_dist, dense_rank, ntile, percent_rank, rank, row_number
from ..filetype import DaftFile, File
from .media import run_process

__all__ = ["DaftFile", "File", "FunctionSpec", "classify_text", "cume_dist", "dense_rank",
           "embed_image", "embed_text", "get_function", "has_function", "llm_generate", "ntile",
           "percent_rank", "prompt", "rank", "register", "row_number", "run_process"]
