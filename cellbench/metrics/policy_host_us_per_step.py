"""Host microseconds of the policy per lockstep step: the port's ``policy``
spans (each sampling and evaluating forward, with its distribution's
arithmetic) that no ``update`` span holds, summed, over the window's
``env.step`` spans."""

from cellbench.spans import count, program_spans, under


def read(ctx):
    spans = program_spans()
    steps = count(spans, "env.step") if spans else 0
    if not steps:
        return None
    ns = sum(s[2] - s[1] for i, s in enumerate(spans)
             if s[0] == "policy" and s[2] and not under(spans, i, "update"))
    return ns / steps / 1e3
