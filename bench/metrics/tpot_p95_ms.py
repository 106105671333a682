"""The 95th percentile (nearest rank), over the traced window's requests,
of (last token's time - first token's time) / (tokens - 1), in ms: the
decode loop's time a token, paced by the host."""

from benchlib.record import nearest_rank


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    tpot = [(b["t1"] - b["t_first"]) / (b["gen"] - 1) for b in run.steps
            for _ in range(b["requests"])]
    return 1e3 * nearest_rank(tpot, 0.95)
