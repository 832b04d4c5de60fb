"""pygorder ``gorder.estimate_error`` (estimate_error.pyi)."""

from __future__ import annotations

from typing import Optional

from ..input.config import EstimateError as _EstimateError


def EstimateError(n_blocks: int = 5,
                  output_convergence: Optional[str] = None) -> _EstimateError:
    return _EstimateError(n_blocks=n_blocks,
                          output_convergence=output_convergence)


__all__ = ["EstimateError"]
