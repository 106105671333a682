"""The 95th percentile (nearest rank), over every request completed in the
window, of the time from its batch's start to its first token (host clock,
synchronised), in ms."""

from benchlib.record import nearest_rank


def read(run):
    if run.kind != "serve" or not run.steps:
        return None
    ttft = [b["t_first"] - b["t0"] for b in run.steps
            for _ in range(b["requests"])]
    return 1e3 * nearest_rank(ttft, 0.95)
