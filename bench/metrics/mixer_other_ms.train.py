"""Device ms a step of the ``other``-group kernels (neither the port's own
kernels nor matrix products: the conv, gates, casts and copies) launched
inside the port's ``rt.mamba`` span: the Mamba mixer's eager part in the
forward and the recompute (its backward kernels run under no layer
span)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = 1e3 * run.trace.group_s({"other"}, inside="rt.mamba") / len(
        run.steps)
    return ms or None
