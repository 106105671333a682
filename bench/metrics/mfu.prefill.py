"""Model FLOPs of the traced window's prefills (``counts.prefill_flops``)
over the device's busy time of the events launched inside the
``prefill`` spans, as a share (%) of the bf16 peak."""

from benchlib import counts


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    flops = sum(counts.prefill_flops(run.cfg, b["requests"], b["length"])
                for b in run.steps)
    busy = run.trace.busy_s(span="prefill")
    return 100 * flops / busy / counts.PEAK_BF16_FLOPS if busy else None
