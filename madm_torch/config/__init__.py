from .lazy import LazyCall, LazyConfig, ConfigDict, instantiate, MISSING, get_by_path, set_by_path
from .utils import auto_scale_workers

__all__ = [
    "LazyCall",
    "LazyConfig",
    "ConfigDict",
    "instantiate",
    "MISSING",
    "get_by_path",
    "set_by_path",
    "auto_scale_workers",
]
