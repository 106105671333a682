"""Device ms a step, outside the ``optimizer`` span, in kernels that are
neither the port's own nor matrix products (the ``other`` group: rotary,
gates, residuals, casts, copies, the Mamba mixer's conv and gates)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = 1e3 * run.trace.group_s({"other"}, outside="optimizer") / len(
        run.steps)
    return ms or None
