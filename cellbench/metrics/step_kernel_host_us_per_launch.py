"""Host microseconds per step of the step kernel's wrapper: the mean of
the port's ``step_kernel`` spans (``ops/step_kernel.py::complete_step``:
the inputs' checks, the output arena's views and the launch)."""

from cellbench.spans import mean_us


def read(ctx):
    return mean_us("step_kernel")
