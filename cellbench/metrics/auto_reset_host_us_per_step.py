"""Host microseconds of auto-reset per lockstep step: the mean of the
port's ``auto_reset`` spans (``envs/core.py::BatchedEnv._auto_reset``: the
fresh rows, from the pool or drawn, merged into every field)."""

from cellbench.spans import mean_us


def read(ctx):
    return mean_us("auto_reset")
