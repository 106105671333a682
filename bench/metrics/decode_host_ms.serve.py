"""The median host duration of the port's ``rt.serve.decode_step`` spans,
in ms: a decode step's host time (the model's step, the argmax and the
finite flag, enqueued without a sync)."""

import statistics


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    steps = run.trace.spans.get("rt.serve.decode_step")
    if not steps:
        return None
    return 1e3 * statistics.median(e - s for s, e in steps)
