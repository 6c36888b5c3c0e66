"""Share of the policy's calls replayed from a CUDA graph: of the window's
``policy`` spans that no ``update`` span holds (the rollout's and the
evaluator's forwards, not the learner's), the percentage that hold a
``policy_graph`` span.  None where the port recorded no ``policy_graph``
span at all, as a port that captures no graph records none."""

from cellbench.spans import program_spans, under


def read(ctx):
    spans = program_spans()
    if not spans or not any(s[0] == "policy_graph" for s in spans):
        return None
    calls = {i for i, s in enumerate(spans)
             if s[0] == "policy" and s[2] and not under(spans, i, "update")}
    if not calls:
        return None
    graphed = {s[3] for s in spans if s[0] == "policy_graph" and s[2]}
    return 100.0 * len(calls & graphed) / len(calls)
