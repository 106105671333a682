"""Gradient paths between the backward pass and the optimizer: int8
error-feedback compression (``compression``) and the collectives issued in
the step-DAG plan's order (``collectives``)."""
