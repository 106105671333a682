"""The share (%) of the traced window in which no event ran on the device
(1 - the union of the device intervals over the window's length)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t0, t1 = run.trace.window()
    return 100 * (1 - run.trace.busy_s(t0, t1) / (t1 - t0))
