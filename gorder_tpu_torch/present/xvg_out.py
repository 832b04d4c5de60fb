"""XVG (Grace) presenter: one file per molecule type.

Format reference: src/presentation/xvg_presenter.rs and goldens
(`order.xvg` → `order_POPC.xvg`): Grace headers with per-class legends,
`# Atom C12:` / `# Bond NC3 - PO4:` comments, 1-based x indices, 4-decimal
values. AA/UA plot per-atom totals (y label "-Sch"); CG plots per-bond
values (y label "S").
"""

from __future__ import annotations

import math
import os
from typing import List

from ..results.model import AnalysisResults
from .common import prepare_output_path, results_header

_TITLES = {
    "aa": "Atomistic order parameters",
    "cg": "Coarse-grained order parameters",
    "ua": "United-atom order parameters",
}
_YLABELS = {"aa": "-Sch", "cg": "S", "ua": "-Sch"}
_LEGENDS = {
    "total": "Full membrane",
    "upper": "Upper leaflet",
    "lower": "Lower leaflet",
}


def _num(value) -> str:
    if value is None or math.isnan(value):
        return "NaN"
    return f"{value:.4f}"


def xvg_path_for(pattern: str, molecule: str) -> str:
    """`order.xvg` → `order_POPC.xvg`; an extension-less pattern stays
    extension-less (`order` → `order_POPC`, xvg_presenter.rs:104-124)."""
    root, ext = os.path.splitext(pattern)
    if not ext:
        return f"{root}_{molecule}"
    return f"{root}_{molecule}{ext}"


def render_xvg(results: AnalysisResults, molecule) -> str:
    classes = ["total"]
    if molecule.average_order.upper is not None:
        classes = ["total", "upper", "lower"]
    lines: List[str] = [results_header(results)]
    lines.append(
        f'@    title "{_TITLES[results.mode]} for molecule type '
        f'{molecule.name}"')
    lines.append(
        f'@    xaxis label "{"Bond" if results.mode == "cg" else "Atom"}"')
    lines.append(f'@    yaxis label "{_YLABELS[results.mode]}"')
    for i, c in enumerate(classes):
        lines.append(f'@    s{i} legend "{_LEGENDS[c]}"')
    lines.append("@TYPE xy")

    def row(i, order):
        # index {:<4} + per-class value {: >8.4} (xvg_presenter.rs:150),
        # a missing class writes literal ' NaN ' (:98)
        fields = []
        for c in classes:
            o = getattr(order, c)
            if o is None:
                fields.append(" NaN ")
            else:
                fields.append(f"{_num(o.value): >8} ")
        return f"{i:<4d} " + "".join(fields)

    if results.mode == "cg":
        for i, bond in enumerate(molecule.bonds, start=1):
            lines.append(f"# Bond {bond.atom1.name} - {bond.atom2.name}:")
            lines.append(row(i, bond.order))
    else:
        for i, atom in enumerate(molecule.atoms, start=1):
            lines.append(f"# Atom {atom.atom.name}:")
            lines.append(row(i, atom.order))

    return "\n".join(lines) + "\n"


def write_xvg(results: AnalysisResults, pattern: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    for molecule in results.molecules:
        path = xvg_path_for(pattern, molecule.name)
        prepare_output_path(path, overwrite)
        with open(path, "w") as fh:
            fh.write(render_xvg(results, molecule))
