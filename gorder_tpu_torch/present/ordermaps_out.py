"""Ordermap directory presenter.

Format reference: src/presentation/ordermaps_presenter.rs and the golden
directories (tests/files/ordermaps*): an output directory with a plotting
script, system-wide `ordermap_average_{class}.dat` files, and one
subdirectory per molecule type holding per-bond / per-atom maps plus the
molecule average. Rows are `x y value` with x slow, 4-decimal floats, NaN
for tiles below min_samples.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np

from ..results.model import AnalysisResults
from ..version import __version__
from .common import prepare_output_dir

_CLASS_SUFFIX = {"total": "full", "upper": "upper", "lower": "lower"}

PLOT_SCRIPT = '''#!/usr/bin/env python3
"""Plot an ordermap produced by gorder-tpu (or gorder).

Usage: python3 plot.py ORDERMAP.dat [--output FIGURE.png]
"""

import argparse

import matplotlib.pyplot as plt
import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("ordermap")
    parser.add_argument("--output", default=None)
    args = parser.parse_args()

    xs, ys, vs = [], [], []
    zrange = (-1.0, 1.0)
    with open(args.ordermap) as fh:
        for line in fh:
            if line.startswith("@ zrange"):
                parts = line.split()
                zrange = (float(parts[2]), float(parts[3]))
            if line.startswith(("#", "@", "$")) or not line.strip():
                continue
            x, y, v = line.split()
            xs.append(float(x))
            ys.append(float(y))
            vs.append(float(v))

    x = np.unique(xs)
    y = np.unique(ys)
    grid = np.asarray(vs).reshape(len(x), len(y)).T

    fig, ax = plt.subplots(figsize=(7, 6))
    mesh = ax.pcolormesh(x, y, grid, cmap="seismic_r",
                         vmin=zrange[0], vmax=zrange[1], shading="nearest")
    fig.colorbar(mesh, ax=ax, label="order parameter")
    ax.set_xlabel("x [nm]")
    ax.set_ylabel("y [nm]")
    ax.set_aspect("equal")
    if args.output:
        fig.savefig(args.output, dpi=300, bbox_inches="tight")
    else:
        plt.show()


if __name__ == "__main__":
    main()
'''


def _zrange(mode: str):
    # AA/UA report -Sch in [-1, 0.5]; CG reports S in [-0.5, 1]
    return (-1.0, 0.5) if mode in ("aa", "ua") else (-0.5, 1.0)


def _axis_labels(plane: str):
    return plane[0], plane[1]


def _write_map(path: str, comment: str, grid: np.ndarray, spec, mode: str):
    zmin, zmax = _zrange(mode)
    lx, ly = _axis_labels_from_spec(spec)
    zlabel = "$S$" if mode == "cg" else "$-S_{CH}$"
    with open(path, "w") as fh:
        fh.write(comment + "\n")
        fh.write(f"@ xlabel {lx}-dimension [nm]\n")
        fh.write(f"@ ylabel {ly}-dimension [nm]\n")
        fh.write(f"@ zlabel order parameter ({zlabel})\n")
        fh.write(f"@ zrange {zmin:.1f} {zmax:.1f} 0.25\n")
        fh.write("$ type colorbar\n")
        fh.write("$ colormap seismic_r\n")
        ticks0 = spec.tick0()
        ticks1 = spec.tick1()
        for i, x in enumerate(ticks0):
            for j, y in enumerate(ticks1):
                v = grid[i, j]
                value = "NaN" if math.isnan(v) else f"{v:.4f}"
                fh.write(f"{x:.4f} {y:.4f} {value}\n")


_AXNAMES = "xyz"


def _axis_labels_from_spec(spec):
    return _AXNAMES[spec.ax0], _AXNAMES[spec.ax1]


def _comment(text: str) -> str:
    return (f"# {text}\n# Calculated with 'gorder-tpu v{__version__}'.")


def write_ordermaps(results: AnalysisResults, directory: str) -> None:
    params, spec = results.map_params
    overwrite = bool(getattr(results.analysis, "overwrite", False))
    prepare_output_dir(directory, overwrite)
    mode = results.mode

    with open(os.path.join(directory, "plot.py"), "w") as fh:
        fh.write(PLOT_SCRIPT)

    def classes_of(maps: Optional[Dict[str, np.ndarray]]):
        return maps.items() if maps else ()

    # system-wide averages
    for cls, grid in classes_of(results.average_maps):
        path = os.path.join(
            directory, f"ordermap_average_{_CLASS_SUFFIX[cls]}.dat")
        _write_map(path, _comment(
            "Map of average order parameters calculated for all bonds of "
            "all molecule types."), grid, spec, mode)

    for mol in results.molecules:
        mol_dir = os.path.join(directory, mol.name)
        os.makedirs(mol_dir, exist_ok=True)
        for cls, grid in classes_of(mol.average_maps):
            path = os.path.join(
                mol_dir, f"ordermap_average_{_CLASS_SUFFIX[cls]}.dat")
            _write_map(path, _comment(
                f"Map of average order parameters calculated for a molecule "
                f"type {mol.name}."), grid, spec, mode)
        for bond in mol.bonds:  # CG
            for cls, grid in classes_of(bond.maps):
                a1, a2 = sorted((bond.atom1, bond.atom2),
                                key=lambda a: a.rel_index)
                name = (f"ordermap_{a1.compact()}--"
                        f"{a2.compact()}_{_CLASS_SUFFIX[cls]}.dat")
                _write_map(os.path.join(mol_dir, name), _comment(
                    f"Map of average order parameters calculated for bonds "
                    f"between atom types {a1.compact()} and "
                    f"{a2.compact()} of a molecule type {mol.name}."),
                    grid, spec, mode)
        for atom in mol.atoms:  # AA / UA
            for cls, grid in classes_of(atom.maps):
                name = (f"ordermap_{atom.atom.compact()}"
                        f"_{_CLASS_SUFFIX[cls]}.dat")
                _write_map(os.path.join(mol_dir, name), _comment(
                    f"Map of average order parameters calculated for an "
                    f"atom type {atom.atom.compact()} of a molecule type "
                    f"{mol.name}."), grid, spec, mode)
            for bond in atom.bonds:
                for cls, grid in classes_of(bond.maps):
                    if bond.atom2 is not None:
                        a1, a2 = sorted((bond.atom1, bond.atom2),
                                        key=lambda a: a.rel_index)
                        name = (f"ordermap_{a1.compact()}--"
                                f"{a2.compact()}"
                                f"_{_CLASS_SUFFIX[cls]}.dat")
                        what = (f"bonds between atom types "
                                f"{a1.compact()} and "
                                f"{a2.compact()}")
                    else:
                        # UA virtual hydrogens: RES-H{k}-{relindex}
                        virtual = (f"{bond.atom1.resname}-"
                                   f"H{bond.virtual_index + 1}-"
                                   f"{bond.atom1.rel_index}")
                        name = (f"ordermap_{bond.atom1.compact()}--"
                                f"{virtual}_{_CLASS_SUFFIX[cls]}.dat")
                        what = (f"bonds between an atom type "
                                f"{bond.atom1.compact()} and a virtual "
                                f"hydrogen #{bond.virtual_index + 1}")
                    _write_map(os.path.join(mol_dir, name), _comment(
                        f"Map of average order parameters calculated for "
                        f"{what} of a molecule type {mol.name}."),
                        grid, spec, mode)
