"""Partial states of sharded runs on disk (port of
`gorder_tpu/parallel/shard.py`, numpy only).

`run_analysis_partial` (engine/drivers.py) computes one contiguous frame
block; its state is a handful of exact int64 arrays plus the per-frame
series indexed by global frame ordinals, so `merge_partial_states`
reproduces the single run's output byte for byte. The file is
`gorder_tpu`'s: a state written by either package loads in the other.
Typical use: one process per GPU (or host), `gorder-tpu-torch config.yaml
--frame-shard I/N --partial part_I.npz`, then `gorder-tpu-torch
config.yaml --merge 'part_*.npz'` anywhere.
"""

from __future__ import annotations

import glob as _glob
import json
from typing import List

import numpy as np

from ..errors import AnalysisError


def save_partial(path: str, state: dict) -> None:
    """Write `state`: its arrays as .npz members, the rest as JSON."""
    arrays = {}
    meta = {}
    for key, value in state.items():
        if isinstance(value, np.ndarray):
            arrays[key] = value
        else:
            meta[key] = value
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_partial(path: str) -> dict:
    """The state `save_partial` wrote to `path`."""
    try:
        with np.load(path, allow_pickle=False) as data:
            state = dict(json.loads(str(data["__meta__"])))
            for key in data.files:
                if key != "__meta__":
                    state[key] = data[key]
    except (OSError, KeyError, ValueError) as e:
        raise AnalysisError(
            f"could not load partial state '{path}': {e}") from None
    return state


def expand_partial_paths(specs) -> List[str]:
    """Paths and globs → the paths of the states, each glob's sorted."""
    paths: List[str] = []
    for spec in specs:
        if any(ch in spec for ch in "*?["):
            matched = sorted(_glob.glob(spec))
            if not matched:
                raise AnalysisError(f"no partial states match '{spec}'")
            paths.extend(matched)
        else:
            paths.append(spec)
    return paths
