"""Config re-export (--export-config): emit the analysis options with all
defaults filled in, using the same YAML schema + !Tag syntax the parser
accepts (reference: application/mod.rs:171-211). The port's own copy of
`gorder_tpu/input/export.py`: it writes the same file."""

from __future__ import annotations

import math
from typing import List

from .config import Analysis


def _quote(s: str) -> str:
    return '"' + str(s).replace('"', '\\"') + '"'


def _freq_lines(freq, indent: str) -> List[str]:
    if freq.kind == "once":
        return [f"{indent}frequency: !Once"]
    return [f"{indent}frequency: !Every {freq.n}"]


def analysis_to_yaml(a: Analysis) -> str:
    lines: List[str] = []
    lines.append(f"structure: {_quote(a.structure)}")
    if a.bonds:
        lines.append(f"bonds: {_quote(a.bonds)}")
    if len(a.trajectory) == 1:
        lines.append(f"trajectory: {_quote(a.trajectory[0])}")
    else:
        lines.append("trajectory:")
        for t in a.trajectory:
            lines.append(f"- {_quote(t)}")
    if a.index:
        lines.append(f"index: {_quote(a.index)}")
    for field in ("output_yaml", "output_tab", "output_xvg", "output_csv"):
        value = getattr(a, field)
        if value:
            lines.append(f"{field}: {_quote(value)}")

    at = a.analysis_type
    lines.append(f"analysis_type: !{at.name}")
    if at.kind == "aa":
        lines.append(f"  heavy_atoms: {_quote(at.heavy_atoms)}")
        lines.append(f"  hydrogens: {_quote(at.hydrogens)}")
    elif at.kind == "cg":
        lines.append(f"  beads: {_quote(at.beads)}")
    else:
        if at.saturated:
            lines.append(f"  saturated: {_quote(at.saturated)}")
        if at.unsaturated:
            lines.append(f"  unsaturated: {_quote(at.unsaturated)}")
        if at.ignore:
            lines.append(f"  ignore: {_quote(at.ignore)}")

    normal = a.membrane_normal
    if normal.kind == "static":
        lines.append(f"membrane_normal: {normal.axis}")
    elif normal.kind == "dynamic":
        lines.append("membrane_normal: !Dynamic")
        lines.append(f"  heads: {_quote(normal.heads)}")
        lines.append(f"  radius: {normal.radius}")
    elif normal.kind == "from_file":
        lines.append("membrane_normal: !FromFile")
        lines.append(f"  file: {_quote(normal.file)}")
    else:
        lines.append("membrane_normal: !FromMap {{ ... }}  # inline map")

    lines.append(f"begin: {a.begin if math.isfinite(a.begin) else 0.0}")
    if math.isfinite(a.end):
        lines.append(f"end: {a.end}")
    else:
        lines.append("end: .inf")
    lines.append(f"step: {a.step}")
    lines.append(f"min_samples: {a.min_samples}")
    lines.append(f"n_threads: {a.n_threads}")

    lf = a.leaflets
    if lf is not None:
        tag = {
            "global": "Global", "local": "Local", "individual": "Individual",
            "from_file": "FromFile", "from_map": "FromMap",
            "from_ndx": "FromNdx", "clustering": "Clustering",
            "spherical": "SphericalClustering",
        }[lf.kind]
        lines.append(f"leaflets: !{tag}")
        if lf.membrane:
            lines.append(f"  membrane: {_quote(lf.membrane)}")
        if lf.heads:
            lines.append(f"  heads: {_quote(lf.heads)}")
        if lf.methyls:
            lines.append(f"  methyls: {_quote(lf.methyls)}")
        if lf.kind == "local":
            lines.append(f"  radius: {lf.radius}")
        if lf.file:
            lines.append(f"  file: {_quote(lf.file)}")
        if lf.ndx:
            lines.append("  ndx:")
            for n in lf.ndx:
                lines.append(f"  - {_quote(n)}")
            lines.append(f"  upper_leaflet: {_quote(lf.upper_leaflet)}")
            lines.append(f"  lower_leaflet: {_quote(lf.lower_leaflet)}")
        lines += _freq_lines(lf.frequency, "  ")
        if lf.flip:
            lines.append("  flip: true")
        if lf.collect.enabled:
            value = _quote(lf.collect.path) if lf.collect.path else "true"
            lines.append(f"  collect: {value}")

    m = a.map
    if m is not None:
        lines.append("map:")
        if m.output_directory:
            lines.append(f"  output_directory: {_quote(m.output_directory)}")
        lines.append(f"  min_samples: {m.min_samples}")
        lines.append(f"  bin_size: [{m.bin_size[0]}, {m.bin_size[1]}]")
        lines.append("  dim:")
        for span in m.dim:
            if span.auto:
                lines.append("  - !Auto")
            else:
                lines.append(
                    f"  - !Manual {{ start: {span.start}, end: {span.end} }}")
        if m.plane:
            lines.append(f"  plane: {m.plane}")

    ee = a.estimate_error
    if ee is not None:
        lines.append("estimate_error:")
        lines.append(f"  n_blocks: {ee.n_blocks}")
        if ee.output_convergence:
            lines.append(
                f"  output_convergence: {_quote(ee.output_convergence)}")

    g = a.geometry
    if g is not None:
        tag = {"cuboid": "Cuboid", "cylinder": "Cylinder",
               "sphere": "Sphere"}[g.kind]
        lines.append(f"geometry: !{tag}")
        if g.reference is not None:
            if isinstance(g.reference, str):
                lines.append(f"  reference: {_quote(g.reference)}")
            else:
                lines.append(
                    f"  reference: [{g.reference[0]}, {g.reference[1]}, "
                    f"{g.reference[2]}]")
        if g.kind == "cuboid":
            for dim_name in ("xdim", "ydim", "zdim"):
                lo, hi = getattr(g, dim_name)
                if math.isfinite(lo) or math.isfinite(hi):
                    lines.append(f"  {dim_name}: [{lo}, {hi}]")
        elif g.kind == "cylinder":
            if math.isfinite(g.radius):
                lines.append(f"  radius: {g.radius}")
            if math.isfinite(g.span[0]) or math.isfinite(g.span[1]):
                lines.append(f"  span: [{g.span[0]}, {g.span[1]}]")
            lines.append(f"  orientation: {g.orientation}")
        else:
            if math.isfinite(g.radius):
                lines.append(f"  radius: {g.radius}")

    lines.append(f"handle_pbc: {str(a.handle_pbc).lower()}")
    lines.append(f"silent: {str(a.silent).lower()}")
    lines.append(f"overwrite: {str(a.overwrite).lower()}")
    return "\n".join(lines) + "\n"
