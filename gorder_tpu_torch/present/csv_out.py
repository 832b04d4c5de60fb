"""CSV presenter.

Format reference: src/presentation/csv_presenter.rs and goldens:
CG: `molecule,atom 1,atom 2,<class columns>`;
AA/UA: `molecule,residue,atom,relative index,<total cols>,<hydrogen #k cols>`
with the hydrogen column count = maximum over all molecule types, empty
trailing cells for missing bonds, `NaN` for missing values.
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..results.model import AnalysisResults
from .common import prepare_output_path

_CLASS_NAMES = {
    "total": "full membrane",
    "upper": "upper leaflet",
    "lower": "lower leaflet",
}
_AA_CLASS_SUFFIX = {
    "total": "full membrane",
    "upper": "upper leaflet",
    "lower": "lower leaflet",
}


def _num(value: Optional[float]) -> str:
    if value is None:
        return ""
    if math.isnan(value):
        return "NaN"
    return f"{value:.4f}"


def render_csv(results: AnalysisResults) -> str:
    with_errors = (
        results.analysis is not None
        and getattr(results.analysis, "estimate_error", None) is not None
    )
    classes = ["total"]
    if results.molecules and results.molecules[0].average_order.upper is not None:
        classes = ["total", "upper", "lower"]
    multi = len(classes) > 1

    lines: List[str] = []

    def collection_cells(col) -> List[str]:
        cells = []
        for c in classes:
            o = getattr(col, c) if col is not None else None
            cells.append(_num(o.value) if o is not None else "")
            if with_errors:
                cells.append(
                    _num(o.error if o.error is not None else float("nan"))
                    if o is not None else "")
        return cells

    if results.mode == "cg":
        header = ["molecule", "atom 1", "atom 2"]
        for c in classes:
            header.append(_CLASS_NAMES[c])
            if with_errors:
                header.append(f"{_CLASS_NAMES[c]} error")
        lines.append(",".join(header))
        for mol in results.molecules:
            for bond in mol.bonds:
                row = [mol.name, bond.atom1.name, bond.atom2.name]
                row += collection_cells(bond.order)
                lines.append(",".join(row))
    else:
        max_bonds = max(
            (len(a.bonds) for mol in results.molecules for a in mol.atoms),
            default=0)
        header = ["molecule", "residue", "atom", "relative index"]

        def group_names(base: str) -> List[str]:
            names = []
            if multi:
                for c in classes:
                    names.append(f"{base} {_AA_CLASS_SUFFIX[c]}")
                    if with_errors:
                        names.append(f"{base} {_AA_CLASS_SUFFIX[c]} error")
            else:
                names.append(base)
                if with_errors:
                    names.append(f"{base} error")
            return names

        header += group_names("total")
        for k in range(max_bonds):
            header += group_names(f"hydrogen #{k + 1}")
        lines.append(",".join(header))

        width = len(classes) * (2 if with_errors else 1)
        for mol in results.molecules:
            for atom in mol.atoms:
                row = [mol.name, atom.atom.resname, atom.atom.name,
                       str(atom.atom.rel_index)]
                row += collection_cells(atom.order)
                for k in range(max_bonds):
                    if k < len(atom.bonds):
                        row += collection_cells(atom.bonds[k].order)
                    else:
                        row += [""] * width
                lines.append(",".join(row))

    return "\n".join(lines) + "\n"


def write_csv(results: AnalysisResults, path: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_csv(results))
