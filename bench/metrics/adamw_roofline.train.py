"""AdamW's least time a step over the device time of the events launched
inside the port's ``rt.train.optimizer`` span, in %.  The least time moves
every leaf of the architecture (its ``leaves``) once at the memory
rate: g read twice (the global norm, the update), p read and written in
its dtype, m and v read and written in float32, so n x (4 x itemsize + 16)
bytes a leaf.  Nothing to read without the span (a program without it)."""

import math

from benchlib import counts, spec

ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_bytes(cfg: dict) -> int:
    return sum(math.prod(leaf.shape) * (4 * ITEM[leaf.dtype] + 16)
               for leaf in spec.architecture(cfg).leaves(cfg))


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    tr = run.trace
    device = tr.device_s(lambda name, at: tr.in_span("rt.train.optimizer",
                                                     at))
    if not device:
        return None
    least = least_bytes(run.cfg) / counts.HBM_BYTES_PER_S * len(run.steps)
    return 100 * least / device
