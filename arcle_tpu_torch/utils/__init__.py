from .metrics import MetricLogger, Throughput, profile_trace
from .checkpoint import Checkpointer
from .config import RunConfig, EnvConfig, make_table, make_loader
from .render import render_ansi_core, render_ansi_o2

__all__ = [
    "MetricLogger", "Throughput", "profile_trace", "Checkpointer", "RunConfig", "EnvConfig",
    "make_table", "make_loader", "render_ansi_core", "render_ansi_o2",
]
