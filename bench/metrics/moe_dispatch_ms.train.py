"""Device ms a step in the MoE routing's and dispatch's kernel groups
(``gather_scatter``: gather, scatter, scatter_add; ``sort``)."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    ms = 1e3 * run.trace.group_s({"gather_scatter", "sort"}) / len(run.steps)
    return ms or None
