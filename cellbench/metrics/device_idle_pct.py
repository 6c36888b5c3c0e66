"""The share of the measured window in which no operation ran on the
card: the union of the traced device operations' intervals against the
window (``torch.profiler``, CUDA activity)."""


def read(ctx):
    if ctx.get("window_s", 0) <= 0 or ctx.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
