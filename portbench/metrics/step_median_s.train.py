"""The median of Trainer.step_seconds (host clock, each ended by reading
the loss) over the traced call's steps: a step without the call's final
save and stalls; its distance from train_step_s shows them."""

import statistics


def read(ctx):
    steps = [s for r in ctx.get("records", []) for s in r.get("step_seconds", [])]
    if ctx.get("unit") != "train_step" or not steps:
        return None
    return statistics.median(steps)
