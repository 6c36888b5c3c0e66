"""Rollout milliseconds per lockstep step: the port's own CUDA events
(first to second mark of each iteration: the rollout and the learner
batch), summed over the window's iterations, over their steps."""


def read(ctx):
    split = ctx.get("split_ms")
    if not split:
        return None
    return sum(r for r, _ in split) / (len(split) * ctx["T"])
