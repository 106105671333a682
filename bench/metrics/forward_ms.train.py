"""Device ms a step of the events launched inside the port's
``rt.train.forward`` span (``model.loss``: the forward, the loss and its
kernels)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    tr = run.trace
    ms = 1e3 * tr.device_s(lambda name, at: tr.in_span("rt.train.forward",
                                                       at)) / len(run.steps)
    return ms or None
