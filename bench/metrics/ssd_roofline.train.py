"""The SSD scan kernels' least time (``counts.ssd_flops``/``ssd_bwd_flops``
and ``ssd_bytes`` at the train shapes, times the calls the port's launch
counters saw) over their device time in the traced window, in %."""

from benchlib import counts


def read(run):
    if run.kind != "train" or run.trace is None or "ssm_state" not in run.cfg:
        return None
    c, m = run.cfg, run.mix
    B, S = m["batch"], m["seq"]
    P, N, Q = c["ssm_head_dim"], c["ssm_state"], c["ssm_chunk"]
    H = c["ssm_expand"] * c["d_model"] // P
    fwd = counts.least_s(counts.ssd_bytes(B, S, H, P, N, False),
                         counts.ssd_flops(B, S, H, P, N, Q))
    bwd = counts.least_s(counts.ssd_bytes(B, S, H, P, N, True),
                         counts.ssd_bwd_flops(B, S, H, P, N, Q))
    least = (run.launches["ssd_scan"] * fwd
             + run.launches["ssd_scan_bwd"] * bwd)
    device = run.trace.group_s({"ssd_scan", "ssd_scan_bwd"})
    return 100 * least / device if device else None
