"""Model zoo of the port: dense, SSM and hybrid decoder-only models in
PyTorch (serving; the train loss for dense models)."""

from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
