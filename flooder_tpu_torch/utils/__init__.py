"""Device resolution and step timing for the PyTorch port."""

from .device import as_tensor, resolve_device
from .timing import StepStats, StepTimer

__all__ = ["as_tensor", "resolve_device", "StepTimer", "StepStats"]
