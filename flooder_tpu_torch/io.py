"""Saving results to disk.

Same semantics as ``flooder_tpu.io.save_to_disk`` (refuse to overwrite
unless asked; inject a ``_meta`` entry into dict payloads). Serialization
is ``torch.save``, as in the original flooder, with tensors moved to the
CPU first so a file written on the card loads on any machine.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Any, Union

import torch


def _to_host(obj: Any) -> Any:
    """Recursively move tensors to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        converted = [_to_host(v) for v in obj]
        return type(obj)(converted) if isinstance(obj, tuple) else converted
    return obj


def save_to_disk(
    obj: Any,
    path: Union[str, Path],
    metadata: bool = True,
    overwrite: bool = False,
) -> None:
    """Save an object to disk with ``torch.save``.

    Args:
        obj: The Python object to save.
        path: Destination file path.
        metadata: Whether to inject ``_meta`` (timestamp, keys) into a copy
            of a dict payload.
        overwrite: Whether to overwrite an existing file; otherwise an
            existing file raises FileExistsError.
    """
    path = Path(path)
    if path.exists() and not overwrite:
        raise FileExistsError(f"File already exists: {path}")

    to_save = _to_host(obj)
    if metadata and isinstance(to_save, dict):
        meta = {
            "timestamp": datetime.datetime.now().isoformat(),
            "keys": list(to_save.keys()),
        }
        to_save = dict(to_save)
        to_save.setdefault("_meta", meta)
    torch.save(to_save, path)
