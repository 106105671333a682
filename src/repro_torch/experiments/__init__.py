"""The port's sweep routing: ``batched.run_cells_batched`` runs fifo,
fault-free cells on the lockstep engine (``repro_torch.core.simtorch``)."""

from repro_torch.experiments.batched import batchable, run_cells_batched

__all__ = ["batchable", "run_cells_batched"]
