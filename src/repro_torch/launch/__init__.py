"""Entry points of the port (serving, training, profiling)."""
