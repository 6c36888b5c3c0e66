"""The step kernel's share of its roofline: the bytes the window's steps
must move (``cost/step_kernel_bytes.py``, per env-step as the reference
counted them over the checked segments' actions, times the window's
env-steps) at 3.35 TB/s, over the traced device time of the kernels whose
name begins ``step_kernel``."""

from cellbench.cost.step_kernel_bytes import HBM_BYTES_PER_S


def read(ctx):
    per = ctx.get("bytes_per_env_step")
    seconds = ctx["trace"].kernel_seconds("step_kernel")
    if not per or seconds <= 0:
        return None
    return 100.0 * per * ctx["env_steps"] / HBM_BYTES_PER_S / seconds
