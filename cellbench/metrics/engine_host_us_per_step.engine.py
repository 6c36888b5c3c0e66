"""Host microseconds per ``BatchedEnv.step`` call: the benchmark's own
span around each call in its loop, summed, over the calls."""


def read(ctx):
    total_ns, n = ctx["spans"].total_ns("env.step")
    return total_ns / n / 1e3 if n else None
