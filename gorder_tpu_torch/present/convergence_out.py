"""Convergence-curve XVG presenter.

Format reference: src/presentation/convergence.rs and goldens
(aa_order_convergence.xvg): one series per molecule type, x = 1-based frame
offset within the analyzed window (stride = step), y = sample-weighted
prefix-averaged order.
"""

from __future__ import annotations

import math
from typing import List

from ..results.model import AnalysisResults
from .common import prepare_output_path, results_header

_YLABELS = {"aa": "-Sch", "cg": "S", "ua": "-Sch"}


def render_convergence(results: AnalysisResults) -> str:
    lines: List[str] = [results_header(results)]
    lines.append(
        '@    title "Convergence of average order parameters for individual '
        'molecule types"')
    lines.append('@    xaxis label "Frame number"')
    lines.append(f'@    yaxis label "{_YLABELS[results.mode]}"')
    # leaflet-wise runs emit three series per molecule type: full/upper/lower
    # (convergence.rs; golden aa_order_leaflets_convergence.xvg)
    with_leaflets = any(
        "upper" in (mol.convergence or {}) for mol in results.molecules)
    curves = []
    idx = 0
    for mol in results.molecules:
        if with_leaflets:
            for cls, label in (("total", "full"), ("upper", "upper"),
                               ("lower", "lower")):
                lines.append(f'@    s{idx} legend "{mol.name} {label}"')
                curves.append(mol.convergence[cls])
                idx += 1
        else:
            lines.append(f'@    s{idx} legend "{mol.name}"')
            curves.append(mol.convergence["total"])
            idx += 1
    lines.append("@TYPE xy")
    n = len(curves[0]) if curves else 0
    step = getattr(results.analysis, "step", 1) if results.analysis else 1
    for k in range(n):
        x = 1 + k * step
        # frame {:<4} + one {: >8.4} field per series (convergence.rs:232-242)
        values = "".join(
            f"{'NaN' if math.isnan(float(c[k])) else f'{float(c[k]):.4f}': >8} "
            for c in curves)
        lines.append(f"{x:<4d} {values}")
    return "\n".join(lines) + "\n"


def write_convergence(results: AnalysisResults, path: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_convergence(results))
