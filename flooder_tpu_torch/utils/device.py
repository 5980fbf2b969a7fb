"""Device resolution and tensor conversion.

Every public entry point of the port takes ``device=None``, which means
``"cuda"``. Inputs (numpy arrays, tensors, anything ``np.asarray`` takes)
are moved to that device. Without CUDA, a request for it raises: nothing
silently carries on on the CPU. Pass ``device="cpu"`` to run on the host.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Resolve ``None`` / ``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` to a
    ``torch.device``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested (device=None means 'cuda') but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the host"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda[:N]' or 'cpu'")
    return dev


def as_tensor(x, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """Convert ``x`` to a tensor on ``device`` (default ``"cuda"``).

    This is how state crosses into the port: the cloud and the landmarks
    (the system has no learned weights) arrive as numpy arrays or tensors
    and leave as tensors on the resolved device. A tensor already on that
    device with that dtype is returned as the same object, so identity
    caches keyed on it (the engine cache) keep working.
    """
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.ascontiguousarray(np.asarray(x))
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if t.device != dev and not (
        dev.type == "cuda" and dev.index is None and t.device.type == "cuda"
    ):
        t = t.to(dev)
    return t
