"""Tokens of every train step completed in the window over the window's
seconds (host clock; each step ends in a loss read)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
