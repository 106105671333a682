"""Model FLOPs of the traced steps (``counts.train_flops``: 6 per active
parameter per token, plus three times the forward's attention or SSD
scan) over the traced window's seconds (host clock), as a share (%) of the
bf16 peak."""

from benchlib import counts


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    flops = counts.train_flops(run.cfg, run.mix["batch"], run.mix["seq"])
    return 100 * flops * len(run.steps) / run.window_s / counts.PEAK_BF16_FLOPS
