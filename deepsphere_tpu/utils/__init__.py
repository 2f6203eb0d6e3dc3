from .activations import resolve_activation
from .compile_cache import enable_compile_cache
from .profiling import timed_block, trace
from .summary import count_params, format_summary

__all__ = [
    "resolve_activation",
    "enable_compile_cache",
    "count_params",
    "format_summary",
    "trace",
    "timed_block",
]
