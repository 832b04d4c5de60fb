"""Leaflet-assignment export presenter.

Format reference: src/presentation/leaflets.rs and the goldens
(tests/files/aa_leaflets_every*.yaml): molecule-type → per-assignment-frame
lists serialized as 1 (upper) / 0 (lower), with 1-based frame-index comments
strided by frequency × step.
"""

from __future__ import annotations

from typing import List

from ..version import __version__
from .common import prepare_output_path


def render_leaflets(results) -> str:
    data = results.leaflets_data
    traj = " ".join(results.trajectory_paths)
    lines: List[str] = [
        f"# Leaflet assignment file generated by 'gorder-tpu v{__version__}' "
        f"using a trajectory file '{traj}'."
    ]
    frames = data["frames"]               # list of (M,) class arrays
    step = data["step"]
    stride = data["frequency_n"] * step   # trajectory-frame stride
    for name, lo, hi in data["kinds"]:
        lines.append(f"{name}:")
        for f, classes in enumerate(frames):
            lines.append(f"# Frame index {1 + f * stride}")
            # internal classes: 0 = upper, 1 = lower; file: 1 = upper
            values = ",".join(str(1 - int(c)) for c in classes[lo:hi])
            lines.append(f"  - [{values}]")
    return "\n".join(lines) + "\n"


def write_leaflets(results, path: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_leaflets(results))
