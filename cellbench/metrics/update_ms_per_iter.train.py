"""Update milliseconds per iteration: the port's own CUDA events (second
to third mark: ``train_step``), averaged over the window's iterations."""


def read(ctx):
    split = ctx.get("split_ms")
    if not split:
        return None
    return sum(u for _, u in split) / len(split)
