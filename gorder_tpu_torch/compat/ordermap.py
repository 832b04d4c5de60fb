"""pygorder ``gorder.ordermap`` (ordermap.pyi)."""

from __future__ import annotations

from typing import Optional, Sequence

from ..input.config import OrderMapParams


def OrderMap(output_directory: Optional[str] = None, min_samples: int = 1,
             dim: Optional[Sequence] = None,
             bin_size: Sequence[float] = (0.1, 0.1),
             plane: Optional[str] = None) -> OrderMapParams:
    spec = {
        "output_directory": output_directory,
        "min_samples": min_samples,
        "bin_size": list(bin_size),
    }
    if dim is not None:
        spec["dim"] = ["auto" if isinstance(d, str) else
                       {"start": float(d[0]), "end": float(d[1])}
                       for d in dim]
    if plane is not None:
        spec["plane"] = plane
    spec = {k: v for k, v in spec.items() if v is not None}
    return OrderMapParams.parse(spec)


__all__ = ["OrderMap"]
