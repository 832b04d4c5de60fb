"""Human-readable table presenter.

Byte-level format reference: src/presentation/tab_presenter.rs (fixed
literal headers, {:<16}/{:<8} labels, ' {: ^8.4} ' cells and
' {: >7.4} ± {: ^7.4} ' error cells) and the goldens
tests/files/*_order_*.tab.
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..results.model import AnalysisResults, Order
from .common import prepare_output_path, results_header

# write_cg_molecule_header (tab_presenter.rs:396-414), keyed by
# (leaflets, errors)
_CG_HEADERS = {
    (True, True): "                        FULL              UPPER"
                  "              LOWER       |",
    (True, False): "                   FULL     UPPER     LOWER   |",
    (False, True): "                        FULL       |",
    (False, False): "                   FULL   |",
}
# per-group sub-header literals for leaflet-wise AA/UA blocks (:444-456)
_SUB_HEADERS = {
    True: "        FULL              UPPER              LOWER       |",
    False: "   FULL     UPPER     LOWER   |",
}
# TOTAL/HYDROGEN group widths (:424-429), keyed by (leaflets, errors)
_GROUP_WIDTHS = {(True, True): 55, (True, False): 28,
                 (False, True): 17, (False, False): 8}


def _order_cell(order: Optional[Order], errors: bool) -> str:
    """One order cell (tab_presenter.rs:113-138)."""
    if order is None or order.value is None:
        return " " + " " * (17 if errors else 8) + " "
    v = order.value
    e = order.error
    if not math.isnan(v) and e is not None and not math.isnan(e):
        return f" {v:>7.4f} ± {f'{e:.4f}':^7} "
    if math.isnan(v) and e is not None:
        return f" {'NaN':^17} "
    if math.isnan(v):
        return f" {'NaN':^8} "
    return f" {v:^8.4f} "


def _collection_cells(col, leaflets: bool, errors: bool) -> str:
    """OrderCollection::write_tab (:145-170): total (+ upper/lower when
    leaflet-wise), empty classes rendered as blank cells."""
    classes = ("total", "upper", "lower") if leaflets else ("total",)
    return "".join(_order_cell(getattr(col, c), errors) for c in classes)


def _flags(results: AnalysisResults):
    leaflets = any(mol.average_order.upper is not None
                   for mol in results.molecules)
    errors = (results.analysis is not None
              and getattr(results.analysis, "estimate_error", None)
              is not None)
    return leaflets, errors


def render_tab(results: AnalysisResults) -> str:
    leaflets, errors = _flags(results)
    lines: List[str] = [results_header(results)]

    if results.mode == "cg":
        for mol in results.molecules:
            lines.append("")
            lines.append(f"Molecule type {mol.name}")
            lines.append(_CG_HEADERS[(leaflets, errors)])
            for bond in mol.bonds:
                label = f"{bond.atom1.name} - {bond.atom2.name}"
                lines.append(f"{label:<16}"
                             + _collection_cells(bond.order, leaflets,
                                                 errors) + "|")
            lines.append("AVERAGE         "
                         + _collection_cells(mol.average_order, leaflets,
                                             errors) + "|")
        lines.append("")
        lines.append("All molecule types")
        lines.append(_CG_HEADERS[(leaflets, errors)])
        lines.append("AVERAGE         "
                     + _collection_cells(results.average_order, leaflets,
                                         errors) + "|")
    else:
        width = _GROUP_WIDTHS[(leaflets, errors)]
        for mol in results.molecules:
            # hydrogen columns are sized per molecule type
            # (max_bonds_for_molecule; golden
            # aa_order_different_hydrogen_numbers)
            max_bonds = max((len(a.bonds) for a in mol.atoms), default=0)
            lines.append("")
            lines.append(f"Molecule type {mol.name}")
            groups = ["TOTAL"] + [
                f"HYDROGEN #{k + 1}" if leaflets or errors else f"H #{k + 1}"
                for k in range(max_bonds)]
            lines.append(" " * 9
                         + "".join(f" {g:^{width}} |" for g in groups))
            if leaflets:
                lines.append(" " * 9
                             + _SUB_HEADERS[errors] * (max_bonds + 1))
            for atom in mol.atoms:
                row = f"{atom.atom.name:<8} "
                row += _collection_cells(atom.order, leaflets, errors) + "|"
                for k in range(max_bonds):
                    if k < len(atom.bonds):
                        row += _collection_cells(atom.bonds[k].order,
                                                 leaflets, errors)
                    else:
                        row += _collection_cells(_EMPTY, leaflets, errors)
                    row += "|"
                lines.append(row)
            lines.append("AVERAGE  "
                         + _collection_cells(mol.average_order, leaflets,
                                             errors) + "|")
        lines.append("")
        lines.append("All molecule types")
        if leaflets:
            lines.append(" " * 9 + _SUB_HEADERS[errors])
        elif errors:
            lines.append(" " * 9 + f" {'TOTAL':^17} |")
        else:
            lines.append(" " * 9 + f" {'TOTAL':^8} |")
        lines.append("AVERAGE  "
                     + _collection_cells(results.average_order, leaflets,
                                         errors) + "|")

    return "\n".join(lines) + "\n"


class _Empty:
    total = None
    upper = None
    lower = None


_EMPTY = _Empty()


def write_tab(results: AnalysisResults, path: str) -> None:
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_tab(results))
