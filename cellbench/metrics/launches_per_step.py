"""Launches on the card per lockstep step: the device operations (kernels,
copies, fills) of the traced window over the port's ``env.step`` spans.
Each launch of a kernel, a copy or a fill is one device operation in the
trace (the port captures no CUDA graph); every launch of the window
counts, the learner's and the benchmark's action draws among them.  None
on the CPU, whose trace holds no device operations."""

from cellbench.spans import count, program_spans


def read(ctx):
    trace = ctx.get("trace")
    spans = program_spans()
    steps = count(spans, "env.step") if spans else 0
    if trace is None or not trace.cuda or not steps:
        return None
    return (len(trace.kernels) - 1) / steps
