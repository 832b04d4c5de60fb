"""pygorder ``gorder.Analysis`` (pygorder __init__.pyi:20-111): the same
kwargs constructor as this package's ``Analysis``, but ``run()`` returns
the method-style results objects of the reference's Python API
(results/pyapi.py) instead of the attribute-style tree. It runs on the
GPU unless the caller passes another ``device``."""

from __future__ import annotations

from ..input.config import Analysis as _NativeAnalysis
from ..results.pyapi import AnalysisResults


class Analysis:
    """Drop-in for pygorder's ``gorder.Analysis``."""

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], _NativeAnalysis):
            self._inner = args[0]
        else:
            self._inner = _NativeAnalysis(*args, **kwargs)

    def run(self, device: str = "cuda") -> AnalysisResults:
        """Run on `device` (the GPU by default; without one this raises
        AnalysisError)."""
        return AnalysisResults(self._inner.run(device))

    @staticmethod
    def from_file(file: str) -> "Analysis":
        return Analysis(_NativeAnalysis.from_file(file))

    def run_partial(self, shard_index: int, shard_count: int,
                    device: str = "cuda") -> dict:
        """One contiguous frame shard's raw partial state, run on
        `device`."""
        return self._inner.run_partial(shard_index, shard_count, device)

    def merge(self, states) -> AnalysisResults:
        """Merge partial states (dicts or .npz paths) into full
        method-style results (host work)."""
        return AnalysisResults(self._inner.merge(states))

    def __getattr__(self, name):
        # config fields (structure, trajectory, begin, ...) read through
        return getattr(self._inner, name)
