"""Membrane-normals export presenter.

Format reference: src/presentation/normals.rs and the golden
tests/files/ua_normals.yaml: molecule-type → per-analyzed-frame lists of
`[ x,y,z]` vectors (6 decimals, space-padded sign column, NaN allowed)."""

from __future__ import annotations

import math
from typing import List

from ..version import __version__
from .common import prepare_output_path


def _component(v: float) -> str:
    if math.isnan(v):
        return " .nan"
    return f"{v: .6f}"


def render_normals(results) -> str:
    data = results.normals_data
    traj = " ".join(results.trajectory_paths)
    lines: List[str] = [
        f"# Membrane normals file generated by 'gorder-tpu v{__version__}' "
        f"using a trajectory file '{traj}'."
    ]
    frames = data["frames"]          # (F, M, 3)
    step = data["step"]
    for name, lo, hi in data["kinds"]:
        lines.append(f"{name}:")
        for f in range(frames.shape[0]):
            lines.append(f"# Frame index {1 + f * step}")
            vectors = ",".join(
                "[" + ",".join(_component(float(c)) for c in frames[f, m])
                + "]"
                for m in range(lo, hi)
            )
            lines.append(f"  - [{vectors}]")
    return "\n".join(lines) + "\n"


def write_normals(results, path: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_normals(results))
