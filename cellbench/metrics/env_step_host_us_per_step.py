"""Host microseconds per lockstep step inside the port: the mean of its
``env.step`` spans (``envs/core.py::BatchedEnv.step``: the step kernel's
wrapper, reward shaping, truncation and auto-reset)."""

from cellbench.spans import mean_us


def read(ctx):
    return mean_us("env.step")
