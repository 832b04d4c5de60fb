"""Whether what the timed path produced is correct: each analysis's results
object and the YAML its `write()` made, against the plain reference.

Numbers compared (each with its limit from the traffic file's `limits`):
- `order_gap`: the widest gap between a value of the results object and
  the reference's, over every value of the tree (system, molecule type,
  atom and bond; total and each leaflet). A missing or extra value, or a
  NaN on one side only, reads infinite.
- `yaml_excess`: how far a value printed in the YAML lies outside the
  half print quantum (5e-5) around the reference's value, the widest over
  the file: 0 when each printed value is the reference's rounded to four
  decimals, or off only where the two lie on either side of a rounding
  boundary by less than the results' own gap. Missing or extra entries,
  or a file that does not parse, read infinite.
- `frames_short`: frames the results say were analyzed, against the
  frames the analysis covers (exact).
"""

from __future__ import annotations

import math

import yaml

HALF_QUANTUM = 0.5e-4
CLASSES = ("total", "upper", "lower")
NAMES = ("order_gap", "yaml_excess", "frames_short")


def flatten_results(results) -> dict:
    """{key path: value} of a results object, keyed as its YAML nests it."""
    out = {}

    def put(path, collection):
        for cls in CLASSES:
            order = getattr(collection, cls, None)
            if order is not None:
                out[path + (cls,)] = float(order.value)

    put(("average order",), results.average_order)
    for mol in results.molecules:
        put((mol.name, "average order"), mol.average_order)
        for bond in mol.bonds:
            put((mol.name, "order parameters",
                 f"{bond.atom1.label()} - {bond.atom2.label()}"), bond.order)
        for atom in mol.atoms:
            path = (mol.name, "order parameters", atom.atom.label())
            put(path, atom.order)
            for bond in atom.bonds:
                put(path + ("bonds", bond.atom2.label()), bond.order)
    return out


def flatten_yaml_text(text: str) -> dict:
    """{key path: value} of an order-parameter YAML file's leaves."""
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    tree = yaml.load(text, Loader=loader)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, path + (str(key),))
        else:
            out[path] = float(node)

    walk(tree, ())
    return out


def fmt4(value: float) -> float:
    """A value as a four-decimal print gives it back."""
    return round(float(value), 4)


def _gaps(expected: dict, got: dict, slack: float = 0.0) -> float:
    if set(expected) != set(got):
        return math.inf
    widest = 0.0
    for key, want in expected.items():
        have = got[key]
        if math.isnan(want) or math.isnan(have):
            if math.isnan(want) != math.isnan(have):
                return math.inf
            continue
        widest = max(widest, abs(have - want) - slack)
    return max(widest, 0.0)


def order_gap(expected: dict, got: dict) -> float:
    return _gaps(expected, got)


def yaml_excess(expected: dict, printed: dict) -> float:
    return _gaps(expected, printed, HALF_QUANTUM)


def judge(expected: dict, frames: int, analyses, limits: dict):
    """Compare every analysis [(flat results, YAML text or None, frames
    analyzed)] → ({number: widest reading}, failed analyses)."""
    widest = dict.fromkeys(NAMES, 0.0)
    failed = 0
    for values, text, n_frames in analyses:
        try:
            printed = flatten_yaml_text(text)
        except (yaml.YAMLError, TypeError, ValueError):
            printed = None
        reading = {
            "order_gap": order_gap(expected, values),
            "yaml_excess": (math.inf if printed is None
                            else yaml_excess(expected, printed)),
            "frames_short": float(abs(frames - n_frames)),
        }
        if any(reading[k] > limits[k] for k in NAMES):
            failed += 1
        for k in NAMES:
            widest[k] = max(widest[k], reading[k])
    return widest, failed
