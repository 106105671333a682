"""Device events (kernels, copies, sets) launched inside the port's
``rt.serve.decode_step`` spans, over the number of those spans: the
launches of one decode step."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    tr = run.trace
    steps = len(tr.spans.get("rt.serve.decode_step", ()))
    if not steps:
        return None
    return sum(tr.in_span("rt.serve.decode_step", at)
               for at in tr.launch_at) / steps
