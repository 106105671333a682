"""Parallelism: the gradient paths between the backward pass and the
optimizer (int8 error-feedback ``compression``; the ``collectives`` issued
in the step-DAG plan's order), the FSDP x TP layouts on a ``DeviceMesh``
(logical ``axes``, the ``sharding`` rules and spec functions), and the GPipe
``pipeline``."""
