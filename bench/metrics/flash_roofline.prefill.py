"""The prefill flash calls' least time (``counts.flash_fwd`` at each traced
batch's shape, one call an attention layer: the architecture's
``mixers``) over the flash kernels' device time in the traced window, in
%."""

from benchlib import counts, spec


def read(run):
    if run.kind != "serve" or run.trace is None or "n_heads" not in run.cfg:
        return None
    c = run.cfg
    n_attn = spec.architecture(c).mixers(c)["attn"]
    least = sum(n_attn * counts.least_s(*counts.flash_fwd(
        b["requests"], b["length"], b["length"], c["n_heads"],
        c["n_kv_heads"], c["head_dim"], True, c.get("sliding_window", 0),
        False)) for b in run.steps)
    device = run.trace.group_s({"flash_attention"})
    return 100 * least / device if device else None
