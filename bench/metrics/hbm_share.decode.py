"""The least time of the traced window's decode steps (each step's bytes,
the architecture's ``decode_bytes``, over the HBM rate) over the device's
busy time of the events launched inside the ``decode`` spans, as a share
(%)."""

from benchlib import counts, spec


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    arch = spec.architecture(run.cfg)
    least = sum(arch.decode_bytes(run.cfg, b["requests"], b["length"] + i)
                for b in run.steps for i in range(b["gen"] - 1))
    busy = run.trace.busy_s(span="decode")
    return 100 * least / counts.HBM_BYTES_PER_S / busy if busy else None
