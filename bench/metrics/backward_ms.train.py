"""Device ms a step of the events launched inside the port's
``rt.train.backward`` span (autograd's backward, each checkpointed unit's
recompute included)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    tr = run.trace
    ms = 1e3 * tr.device_s(lambda name, at: tr.in_span("rt.train.backward",
                                                       at)) / len(run.steps)
    return ms or None
