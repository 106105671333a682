"""Output tokens of every request completed in the window over the
window's seconds (host clock)."""


def read(run):
    if run.kind != "serve" or not run.steps:
        return None
    return sum(b["requests"] * b["gen"] for b in run.steps) / run.window_s
