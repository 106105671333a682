"""Model zoo of the port: the dense decoder-only serving path in PyTorch."""

from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
