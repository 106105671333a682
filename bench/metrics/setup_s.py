"""Seconds from the process's start to the window's (host clock): imports,
the CUDA context, loading or building the kernels, drawing the weights,
and the warm-up (a train cell's checked first steps; a serve cell's one
batch of each prompt length)."""


def read(run):
    return run.setup_s
