"""YAML results presenter — the complete dump.

Format reference: src/presentation/yaml_presenter.rs and the golden files
tests/files/*_order_*.yaml. The YAML is emitted by hand to reproduce the
reference's exact structure (key labels like `POPC NC3 (0) - POPC PO4 (1)`,
4-decimal floats, `.nan`, nested mean/error when errors are present,
UA bond lists).
"""

from __future__ import annotations

from typing import List, Optional

from ..results.model import AnalysisResults, Order, OrderCollection
from .common import fmt4, results_header


def _order_lines(label: str, order: Optional[Order], indent: str) -> List[str]:
    if order is None:
        return []
    if order.error is not None or _errors_present.flag:
        return [
            f"{indent}{label}:",
            f"{indent}  mean: {fmt4(order.value)}",
            f"{indent}  error: {fmt4(order.error if order.error is not None else float('nan'))}",
        ]
    return [f"{indent}{label}: {fmt4(order.value)}"]


class _errors_present:
    """Module-level flag: when errors are computed, even NaN entries render
    in mean/error form."""

    flag = False


def _collection_lines(col: OrderCollection, indent: str) -> List[str]:
    lines: List[str] = []
    lines += _order_lines("total", col.total, indent)
    lines += _order_lines("upper", col.upper, indent)
    lines += _order_lines("lower", col.lower, indent)
    return lines


def render_yaml(results: AnalysisResults) -> str:
    _errors_present.flag = (
        results.analysis is not None
        and getattr(results.analysis, "estimate_error", None) is not None
    )
    lines: List[str] = [results_header(results)]
    lines.append("average order:")
    lines += _collection_lines(results.average_order, "  ")

    for mol in results.molecules:
        lines.append(f"{mol.name}:")
        lines.append("  average order:")
        lines += _collection_lines(mol.average_order, "    ")
        lines.append("  order parameters:")
        if results.mode == "cg":
            for bond in mol.bonds:
                lines.append(
                    f"    {bond.atom1.label()} - {bond.atom2.label()}:"
                )
                lines += _collection_lines(bond.order, "      ")
        elif results.mode == "aa":
            for atom in mol.atoms:
                lines.append(f"    {atom.atom.label()}:")
                lines += _collection_lines(atom.order, "      ")
                lines.append("      bonds:")
                for bond in atom.bonds:
                    lines.append(f"        {bond.atom2.label()}:")
                    lines += _collection_lines(bond.order, "          ")
        else:  # ua
            for atom in mol.atoms:
                lines.append(f"    {atom.atom.label()}:")
                lines += _collection_lines(atom.order, "      ")
                lines.append("      bonds:")
                for bond in atom.bonds:
                    # list-item map: '- total:' with nested keys keeping
                    # their absolute columns (serde_yaml sequence style)
                    entry = _collection_lines(bond.order, "        ")
                    if entry:
                        lines.append(f"      - {entry[0].strip()}")
                        lines.extend(entry[1:])
    _errors_present.flag = False
    return "\n".join(lines) + "\n"


def write_yaml(results: AnalysisResults, path: str) -> None:
    from .common import prepare_output_path

    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_path(path, overwrite)
    with open(path, "w") as fh:
        fh.write(render_yaml(results))
