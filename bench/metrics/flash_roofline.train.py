"""The flash kernels' least time (``counts.flash_fwd``/``flash_bwd`` at the
train shapes, times the calls the port's launch counters saw) over their
device time in the traced window, in %."""

from benchlib import counts


def read(run):
    if run.kind != "train" or run.trace is None or "n_heads" not in run.cfg:
        return None
    c, m = run.cfg, run.mix
    shape = (m["batch"], m["seq"], c["n_heads"], c["n_kv_heads"],
             c["head_dim"])
    window = c.get("sliding_window", 0)
    B, S, H, KV, hd = shape
    fwd = counts.least_s(*counts.flash_fwd(B, S, S, H, KV, hd, True, window,
                                           True))
    bwd = counts.least_s(*counts.flash_bwd(B, S, H, KV, hd, True, window))
    least = (run.launches["flash_attention"] * fwd
             + run.launches["flash_attention_bwd"] * bwd)
    device = run.trace.group_s({"flash_attention", "flash_attention_bwd"})
    return 100 * least / device if device else None
