"""Entry points of the port (serving, training, profiling, the sweeps and
the paper's figures)."""
