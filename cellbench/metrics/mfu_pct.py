"""The whole step's share of the card's peak: the analytic model FLOPs of
the window's work (``cost/flops.py``: the training iterations, or the
evaluator's live env-steps) over the window's seconds and the
configuration's peak on this card; nothing where the card's peak is not
listed."""

from cellbench.cost import peaks


def read(ctx):
    peak = peaks(ctx.get("card", "")).get(f"{ctx['peak']}_tflops")
    if not peak or ctx.get("window_s", 0) <= 0:
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * peak * 1e12)
