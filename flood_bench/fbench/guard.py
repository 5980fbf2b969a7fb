"""Which loaded modules a run of the benchmark may not hold.

The port's package name begins with the JAX package's name, so names are
compared by their whole top-level part (before the first dot), never by
prefix.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "flooder_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Sorted top-level names among ``names`` (default: ``sys.modules``)
    that are JAX, its libraries or the JAX package."""
    if names is None:
        names = list(sys.modules)
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))
