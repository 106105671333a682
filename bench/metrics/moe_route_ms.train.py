"""Device ms a step of the events launched inside the port's
``rt.moe.route``, ``rt.moe.dispatch`` or ``rt.moe.combine`` spans: the MoE
FFN's routing, dispatch and combine in the forward and the recompute
(their backward kernels run under no layer span)."""

SPANS = ("rt.moe.route", "rt.moe.dispatch", "rt.moe.combine")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    tr = run.trace
    ms = 1e3 * tr.device_s(lambda name, at: any(tr.in_span(s, at)
                                                 for s in SPANS)) / len(
        run.steps)
    return ms or None
