from .loader import (
    TaskBank, bake_bank, Loader, ARCLoader, MiniARCLoader, ListLoader,
    TaskTuple,
)
from .synthetic import make_task, make_tasks, SyntheticLoader, write_corpus

__all__ = [
    "TaskBank", "bake_bank", "Loader", "ARCLoader", "MiniARCLoader",
    "ListLoader", "TaskTuple", "make_task", "make_tasks", "SyntheticLoader",
    "write_corpus",
]
