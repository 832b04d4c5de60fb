"""A cell as `BENCHMARK.json` names it, and the files it is made of, found
by name: its configuration's file (the entry's `file`), its traffic
(`benchmark/workloads/<traffic>.json`), the readers of its metrics
(`benchmark/metrics/<metric>.py`), the kernels' counts
(`benchmark/rooflines/<kernel>.py`), the methods of its plain
reference (`benchmark/reference/<axis>/<method>.py`) and the lipid
template its configuration lays out (`benchmark/templates/<template>.py`)."""

from __future__ import annotations

import functools
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the plain reference's methods, one module a method:
#: `<axis>/<tag in snake case>.py`
REFERENCE = HERE / "reference"
_TAG = re.compile(r"^[A-Za-z][A-Za-z0-9]*$")
#: the lipid templates, one module a template:
#: `<template with "-" as "_">.py`; a template's name is lower case, its
#: words joined by "-"
TEMPLATES = HERE / "templates"
_TEMPLATE = re.compile(r"^[a-z0-9][a-z0-9-]*$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_bytes: bytes
    traffic: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str) -> bool:
    """An end-to-end metric is every cell's unless it lists its cells; a
    per-layer metric always lists them."""
    return cell in entry.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config_bytes = (root / conf["file"]).read_bytes()
    traffic = json.loads(
        (HERE / "workloads" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(entry["chips"]),
                config=json.loads(config_bytes), config_bytes=config_bytes,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


@functools.lru_cache(maxsize=None)
def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module(kind: str, name: str):
    ident = name.replace("-", "_").replace(".", "_")
    return _load(HERE / kind / f"{name}.py", f"benchmark.{kind}.{ident}")


def metric_reader(name: str):
    """The `read(run)` of `benchmark/metrics/<name>.py`."""
    return _module("metrics", name).read


def roofline(kernel: str):
    """The module `benchmark/rooflines/<kernel>.py`."""
    return _module("rooflines", kernel)


def snake_case(tag: str) -> str:
    """A gorder tag as a module name: `SphericalClustering` →
    `spherical_clustering`, `AAOrder` → `aa_order`."""
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_",
                  tag).lower()


def reference_part(axis: str, spec):
    """The module of the plain reference's method for the tagged value
    `spec` ({"!": Tag, field: value, ...}) on `axis` (`kinds`, `normals`
    or `leaflets`): `benchmark/reference/<axis>/<tag in snake case>.py`.
    NotImplementedError, naming the spec and the file looked for, where
    there is none."""
    tag = spec.get("!") if isinstance(spec, dict) else None
    what = f"the reference has no {axis} method for {spec}"
    if not (isinstance(tag, str) and _TAG.match(tag)):
        raise NotImplementedError(
            f"{what}: it is no tagged value {{'!': Tag, ...}}")
    return _part(REFERENCE / axis, snake_case(tag), what)


def template_part(name):
    """The module of the lipid template `name` (a configuration's
    `template`): `benchmark/templates/<name with "-" as "_">.py`, whose
    `template()` gives (atom names in file order, bonds as index pairs
    within the molecule). NotImplementedError, naming the template and the
    file looked for, where there is none."""
    what = f"no lipid template {name!r}"
    if not (isinstance(name, str) and _TEMPLATE.match(name)):
        raise NotImplementedError(f"{what}: it is no template name")
    return _part(TEMPLATES, name.replace("-", "_"), what)


def _part(directory: Path, ident: str, what: str):
    """The module `<directory>/<ident>.py`; NotImplementedError, `what`
    and the file looked for, where there is none."""
    path = directory / f"{ident}.py"
    if not path.is_file():
        raise NotImplementedError(f"{what}: no {_shown(path)}")
    return _load(path, f"benchmark.{directory.name}.{ident}")


def _shown(path: Path):
    return path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
