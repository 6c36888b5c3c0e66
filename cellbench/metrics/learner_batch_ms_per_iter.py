"""Host milliseconds of the learner batch per iteration: the port's
``learner_batch`` spans (GAE, the advantages' normalisation and the
flattened batch) summed, over its ``iteration`` spans."""

from cellbench.spans import count, program_spans, total_ns


def read(ctx):
    spans = program_spans()
    n = count(spans, "iteration") if spans else 0
    return total_ns(spans, "learner_batch") / n / 1e6 if n else None
