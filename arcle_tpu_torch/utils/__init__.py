from .metrics import MetricLogger, Throughput
from .checkpoint import Checkpointer
from .config import RunConfig, EnvConfig, make_table, make_loader

__all__ = [
    "MetricLogger", "Throughput", "Checkpointer", "RunConfig", "EnvConfig",
    "make_table", "make_loader",
]
