"""Device ms a step of the events launched under the harness's
``optimizer`` span (AdamW's ``update``)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    tr = run.trace
    ms = 1e3 * tr.device_s(lambda name, at: tr.in_span("optimizer", at)) / (
        len(run.steps))
    return ms or None
