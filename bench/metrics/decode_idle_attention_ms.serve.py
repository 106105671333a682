"""Device idle ms a decode step spent waiting on attention's host: the
idle gaps inside the window (formed as ``Trace.breakdown`` forms them)
that end at an event launched inside both a ``rt.serve.decode_step`` span
and a ``rt.attention`` span, over the number of decode steps."""

SPANS = ("rt.attention",)


def idle_ms(run, spans) -> float | None:
    """The idle ms a decode step in gaps whose next event was launched
    inside a decode step and inside one of ``spans``."""
    if run.kind != "serve" or run.trace is None:
        return None
    tr = run.trace
    steps = len(tr.spans.get("rt.serve.decode_step", ()))
    if not steps:
        return None
    t0, t1 = tr.window()
    idle, end = 0.0, t0
    for (s, e, *_), at in zip(tr.kernels, tr.launch_at):
        if e <= t0 or s >= t1:
            continue
        if (s > end and tr.in_span("rt.serve.decode_step", at)
                and any(tr.in_span(x, at) for x in spans)):
            idle += min(s, t1) - end
        end = max(end, e)
    return 1e3 * idle / steps


def read(run):
    return idle_ms(run, SPANS)
