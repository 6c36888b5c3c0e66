from .metrics import MetricLogger, Throughput, profile_trace
from .checkpoint import Checkpointer
from .config import RunConfig, EnvConfig, make_table, make_loader

__all__ = [
    "MetricLogger", "Throughput", "profile_trace", "Checkpointer", "RunConfig", "EnvConfig",
    "make_table", "make_loader",
]
