"""The share (%) of the MoE expert buffers' rows that hold a kept (token,
choice) pair over the traced window: 100 x the port's ``moe_pairs_kept``
counter over its ``moe_buffer_rows`` (the rest is padding to capacity and
the room of dropped pairs)."""


def read(run):
    if run.kind != "train" or not run.launches:
        return None
    rows = run.launches.get("moe_buffer_rows")
    kept = run.launches.get("moe_pairs_kept")
    return 100 * kept / rows if rows and kept is not None else None
