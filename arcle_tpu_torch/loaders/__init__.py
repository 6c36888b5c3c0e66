from .loader import (
    TaskBank, bake_bank, Loader, ARCLoader, MiniARCLoader, ListLoader,
    TaskTuple,
)
from .synthetic import (
    make_task, make_tasks, SyntheticLoader, write_corpus,
    write_real_layout_fixture, write_sample_dataset,
)

__all__ = [
    "TaskBank", "bake_bank", "Loader", "ARCLoader", "MiniARCLoader",
    "ListLoader", "TaskTuple", "make_task", "make_tasks", "SyntheticLoader",
    "write_corpus", "write_real_layout_fixture", "write_sample_dataset",
]
