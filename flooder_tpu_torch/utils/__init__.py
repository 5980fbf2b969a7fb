"""Device resolution and stage timing for the PyTorch port."""

from .device import as_tensor, resolve_device

__all__ = ["as_tensor", "resolve_device"]
