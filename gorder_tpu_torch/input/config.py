"""Analysis configuration model.

Mirrors the reference's YAML schema 1:1 (src/input/analysis.rs:123-277 and
the parameter structs in src/input/*.rs), including `!Tag` enum syntax,
field aliases (`output`/`output_yml`, `type`, `maps`/`ordermap`/`ordermaps`,
`start`), `"default"`/`true` shorthands for ordermaps and error estimation,
and unknown-field rejection.
"""

from __future__ import annotations

import os
from dataclasses import InitVar, dataclass, field as dataclass_field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import yaml

from ..errors import (ConfigError, ErrorEstimationError, FrequencyError,
                      GeometryError, OrderMapError, fnum)

# ------------------------------------------------------------- YAML with tags


class _Tagged(dict):
    """Mapping node carrying a local YAML tag (e.g. !AAOrder)."""

    tag: str = ""


def _tag_constructor(loader, tag_suffix, node):
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = {"__seq__": loader.construct_sequence(node, deep=True)}
    else:
        scalar = loader.construct_scalar(node)
        value = {} if scalar in (None, "") else {"__scalar__": scalar}
    tagged = _Tagged(value)
    tagged.tag = tag_suffix
    return tagged


class _ConfigLoader(yaml.SafeLoader):
    pass


_ConfigLoader.add_multi_constructor("!", _tag_constructor)


def load_yaml(text: str, path: str = "<string>"):
    try:
        return yaml.load(text, Loader=_ConfigLoader)
    except yaml.YAMLError as e:
        # wording: src/errors.rs:292-294 (ConfigError::CouldNotParseConfig)
        raise ConfigError(
            f"could not understand the contents of the configuration file "
            f"'{path}' ({e})") from None


# ------------------------------------------------------------------ utilities


def _expect_keys(mapping: Dict, allowed: Dict[str, Sequence[str]], what: str):
    """Resolve aliases and reject unknown fields. Returns canonical dict."""
    out = {}
    alias_to_canonical = {}
    for canonical, aliases in allowed.items():
        alias_to_canonical[canonical] = canonical
        for a in aliases:
            alias_to_canonical[a] = canonical
    for key, value in mapping.items():
        if key not in alias_to_canonical:
            raise ConfigError(f"unknown field '{key}' in {what}")
        canonical = alias_to_canonical[key]
        if canonical in out:
            raise ConfigError(f"duplicate field '{canonical}' in {what}")
        out[canonical] = value
    return out


# ------------------------------------------------------------------ Frequency


@dataclass(frozen=True)
class Frequency:
    """once | every(n) (src/input/frequency.rs)."""

    kind: str = "every"   # 'every' | 'once'
    n: int = 1

    @staticmethod
    def every(n: int) -> "Frequency":
        if n < 1:
            # wording: src/errors.rs:49-50 (FrequencyError::EveryZero)
            raise FrequencyError(
                f"action cannot be performed once every '{n}' frames "
                f"(frequency has to be at least 1)")
        return Frequency("every", n)

    @staticmethod
    def once() -> "Frequency":
        return Frequency("once", 0)

    def describe(self) -> str:
        """Human description matching the reference's Display impl
        (src/presentation/mod.rs:772-782); used inside error messages."""
        if self.kind == "once":
            return "once at the start of the analysis"
        if self.n == 1:
            return "every analyzed frame"
        suffix = {2: "nd", 3: "rd"}.get(self.n, "th")
        return f"every {self.n}{suffix} analyzed frame"

    @staticmethod
    def parse(value) -> "Frequency":
        if value is None:
            return Frequency.every(1)
        if isinstance(value, Frequency):
            return value
        if isinstance(value, _Tagged):
            tag = value.tag.lower()
            if tag == "once":
                return Frequency.once()
            if tag == "every":
                n = value.get("__scalar__", value.get("n"))
                try:
                    return Frequency.every(int(n))
                except (TypeError, ValueError):
                    raise FrequencyError(
                        f"invalid frequency value '{n}'"
                    ) from None
            raise FrequencyError(f"unknown frequency '!{value.tag}'")
        if isinstance(value, int):
            return Frequency.every(value)
        raise FrequencyError(f"invalid frequency specification '{value}'")


# -------------------------------------------------------------------- Collect


@dataclass(frozen=True)
class Collect:
    """false | true | output path (src/input/mod.rs Collect)."""

    enabled: bool = False
    path: Optional[str] = None

    @staticmethod
    def parse(value) -> "Collect":
        if value is None or value is False:
            return Collect(False, None)
        if value is True:
            return Collect(True, None)
        if isinstance(value, str):
            return Collect(True, value)
        if isinstance(value, Collect):
            return value
        raise ConfigError(f"invalid collect/export specification '{value}'")


# ---------------------------------------------------------------------- Axis

_AXES = {"x": 0, "y": 1, "z": 2}


# ----------------------------------------------------------- membrane normal


@dataclass
class MembraneNormal:
    """static axis | dynamic | from file | inline map
    (src/input/membrane_normal.rs)."""

    kind: str = "static"      # 'static' | 'dynamic' | 'from_file' | 'from_map'
    axis: Optional[str] = "z"
    heads: Optional[str] = None
    radius: float = 2.0
    collect: Collect = dataclass_field(default_factory=Collect)
    file: Optional[str] = None
    normals_map: Optional[Dict] = None

    @staticmethod
    def static(axis: str) -> "MembraneNormal":
        axis = axis.lower()
        if axis not in _AXES:
            raise ConfigError(f"invalid membrane normal axis '{axis}'")
        return MembraneNormal(kind="static", axis=axis)

    @staticmethod
    def dynamic(heads: str, radius: float = 2.0, collect=None) -> "MembraneNormal":
        if radius <= 0:
            # wording: src/errors.rs:359-363
            # (ConfigError::InvalidDynamicNormalRadius)
            raise ConfigError(
                f"the specified radius for dynamic membrane normal "
                f"calculation must be larger than 0, not '{fnum(radius)}'\n"
                f"(hint: the recommended value for 'radius' is roughly half "
                f"of the membrane thickness)")
        return MembraneNormal(
            kind="dynamic", axis=None, heads=heads, radius=radius,
            collect=Collect.parse(collect),
        )

    @staticmethod
    def from_file(path: str, collect=None) -> "MembraneNormal":
        return MembraneNormal(kind="from_file", axis=None, file=path,
                              collect=Collect.parse(collect))

    @staticmethod
    def from_map(mapping: Dict, collect=None) -> "MembraneNormal":
        return MembraneNormal(kind="from_map", axis=None, normals_map=mapping,
                              collect=Collect.parse(collect))

    @staticmethod
    def parse(value) -> "MembraneNormal":
        if value is None:
            return MembraneNormal.static("z")
        if isinstance(value, MembraneNormal):
            return value
        if isinstance(value, str):
            if value.lower() in _AXES:
                return MembraneNormal.static(value)
            return MembraneNormal.from_file(value)
        if isinstance(value, _Tagged):
            tag = value.tag.lower()
            if tag == "dynamic":
                fields = _expect_keys(
                    {k: v for k, v in value.items()},
                    {"heads": [], "radius": [], "collect": ["export"]},
                    "!Dynamic membrane normal",
                )
                if "heads" not in fields:
                    raise ConfigError("dynamic membrane normal requires 'heads'")
                return MembraneNormal.dynamic(
                    fields["heads"], float(fields.get("radius", 2.0)),
                    fields.get("collect"),
                )
            if tag == "fromfile":
                if "__scalar__" in value:  # !FromFile "normals.yaml"
                    return MembraneNormal.from_file(value["__scalar__"])
                fields = _expect_keys(
                    dict(value), {"file": [], "collect": ["export"]},
                    "!FromFile membrane normal",
                )
                return MembraneNormal.from_file(
                    fields["file"], fields.get("collect"))
            if tag == "frommap":
                fields = _expect_keys(
                    dict(value), {"normals": [], "collect": ["export"]},
                    "!FromMap membrane normal",
                )
                return MembraneNormal.from_map(
                    fields["normals"], fields.get("collect"))
            if tag == "inline":
                # molecule-type keys directly under the tag
                mapping = dict(value)
                collect = mapping.pop("collect", None)
                return MembraneNormal.from_map(mapping, collect)
            raise ConfigError(f"unknown membrane normal type '!{value.tag}'")
        if isinstance(value, dict):
            # inline manual normals map (moltype -> per-frame vectors)
            return MembraneNormal.from_map(value)
        raise ConfigError(f"invalid membrane normal specification '{value}'")


# -------------------------------------------------------------- analysis type


@dataclass
class AnalysisType:
    kind: str                       # 'aa' | 'cg' | 'ua'
    heavy_atoms: Optional[str] = None
    hydrogens: Optional[str] = None
    beads: Optional[str] = None
    saturated: Optional[str] = None
    unsaturated: Optional[str] = None
    ignore: Optional[str] = None

    @property
    def name(self) -> str:
        return {"aa": "AAOrder", "cg": "CGOrder", "ua": "UAOrder"}[self.kind]

    @staticmethod
    def aaorder(heavy_atoms: str, hydrogens: str) -> "AnalysisType":
        return AnalysisType("aa", heavy_atoms=heavy_atoms, hydrogens=hydrogens)

    @staticmethod
    def cgorder(beads: str) -> "AnalysisType":
        return AnalysisType("cg", beads=beads)

    @staticmethod
    def uaorder(saturated: Optional[str] = None,
                unsaturated: Optional[str] = None,
                ignore: Optional[str] = None) -> "AnalysisType":
        if saturated is None and unsaturated is None:
            # wording: src/errors.rs:104-105 (TopologyError::NoUACarbons);
            # the reference defers this to topology preparation
            # (uaorder.rs:190), we reject it at config time
            raise ConfigError(
                "no carbons for the calculation of united-atom order "
                "parameters were specified"
            )
        return AnalysisType("ua", saturated=saturated,
                            unsaturated=unsaturated, ignore=ignore)

    @staticmethod
    def parse(value) -> "AnalysisType":
        if isinstance(value, AnalysisType):
            return value
        if not isinstance(value, _Tagged):
            raise ConfigError(
                "analysis type must be specified as !AAOrder, !CGOrder, or "
                "!UAOrder"
            )
        tag = value.tag.lower()
        if tag == "aaorder":
            fields = _expect_keys(dict(value),
                                  {"heavy_atoms": [], "hydrogens": []},
                                  "!AAOrder")
            missing = {"heavy_atoms", "hydrogens"} - set(fields)
            if missing:
                raise ConfigError(
                    f"missing field(s) {sorted(missing)} in !AAOrder")
            return AnalysisType.aaorder(fields["heavy_atoms"],
                                        fields["hydrogens"])
        if tag == "cgorder":
            fields = _expect_keys(dict(value), {"beads": ["atoms"]},
                                  "!CGOrder")
            if "beads" not in fields:
                raise ConfigError("missing field 'beads' in !CGOrder")
            return AnalysisType.cgorder(fields["beads"])
        if tag == "uaorder":
            fields = _expect_keys(
                dict(value),
                {"saturated": [], "unsaturated": [], "ignore": []},
                "!UAOrder",
            )
            return AnalysisType.uaorder(fields.get("saturated"),
                                        fields.get("unsaturated"),
                                        fields.get("ignore"))
        raise ConfigError(f"unknown analysis type '!{value.tag}'")


# ------------------------------------------------------ leaflet classification


@dataclass
class LeafletClassification:
    """8 assignment methods (src/input/leaflets.rs:24-353)."""

    kind: str
    membrane: Optional[str] = None
    heads: Optional[str] = None
    methyls: Optional[str] = None
    radius: float = 0.0
    file: Optional[str] = None
    assignment: Optional[Dict] = None
    ndx: Optional[List[str]] = None
    upper_leaflet: Optional[str] = None
    lower_leaflet: Optional[str] = None
    frequency: Frequency = dataclass_field(default_factory=Frequency)
    membrane_normal: Optional[str] = None
    collect: Collect = dataclass_field(default_factory=Collect)
    flip: bool = False

    @staticmethod
    def global_(membrane: str, heads: str) -> "LeafletClassification":
        return LeafletClassification("global", membrane=membrane, heads=heads)

    @staticmethod
    def local(membrane: str, heads: str, radius: float) -> "LeafletClassification":
        if radius <= 0:
            raise ConfigError(
                f"radius of the local membrane center must be positive, "
                f"not {radius}"
            )
        return LeafletClassification("local", membrane=membrane, heads=heads,
                                     radius=radius)

    @staticmethod
    def individual(heads: str, methyls: str) -> "LeafletClassification":
        return LeafletClassification("individual", heads=heads, methyls=methyls)

    @staticmethod
    def from_file(path: str) -> "LeafletClassification":
        return LeafletClassification("from_file", file=path)

    @staticmethod
    def from_map(assignment: Dict) -> "LeafletClassification":
        return LeafletClassification("from_map", assignment=assignment)

    @staticmethod
    def from_ndx(ndx, heads: str, upper_leaflet: str,
                 lower_leaflet: str) -> "LeafletClassification":
        if isinstance(ndx, str):
            # a string is a glob pattern; expanded sorted, and kept literal
            # when nothing matches (leaflets.rs deserialize_string_or_vec)
            import glob as _glob
            ndx = sorted(_glob.glob(ndx)) or [ndx]
        return LeafletClassification(
            "from_ndx", ndx=list(ndx), heads=heads,
            upper_leaflet=upper_leaflet, lower_leaflet=lower_leaflet,
        )

    @staticmethod
    def clustering(heads: str) -> "LeafletClassification":
        return LeafletClassification("clustering", heads=heads)

    @staticmethod
    def spherical(heads: str) -> "LeafletClassification":
        return LeafletClassification("spherical", heads=heads)

    def with_frequency(self, frequency: Frequency) -> "LeafletClassification":
        self.frequency = frequency
        return self

    def with_collect(self, collect) -> "LeafletClassification":
        self.collect = Collect.parse(collect)
        return self

    def with_flip(self, flip: bool = True) -> "LeafletClassification":
        self.flip = flip
        return self

    def with_membrane_normal(self, axis: str) -> "LeafletClassification":
        if axis.lower() not in _AXES:
            raise ConfigError(f"invalid membrane normal axis '{axis}'")
        self.membrane_normal = axis.lower()
        return self

    @staticmethod
    def parse(value) -> Optional["LeafletClassification"]:
        if value is None:
            return None
        if isinstance(value, LeafletClassification):
            return value
        if not isinstance(value, _Tagged):
            raise ConfigError(
                "leaflet classification must use a !Tag (e.g. !Global)")
        tag = value.tag.lower()
        common = {"frequency": [], "membrane_normal": [],
                  "collect": ["export"], "flip": []}

        def finish(lc: LeafletClassification, fields) -> LeafletClassification:
            lc.frequency = Frequency.parse(fields.get("frequency"))
            lc.collect = Collect.parse(fields.get("collect"))
            lc.flip = bool(fields.get("flip", False))
            normal = fields.get("membrane_normal")
            if normal is not None:
                lc.with_membrane_normal(str(normal))
            return lc

        if tag == "global":
            fields = _expect_keys(dict(value),
                                  {"membrane": [], "heads": [], **common},
                                  "!Global leaflet classification")
            lc = LeafletClassification.global_(fields["membrane"],
                                               fields["heads"])
            return finish(lc, fields)
        if tag == "local":
            fields = _expect_keys(
                dict(value),
                {"membrane": [], "heads": [], "radius": [], **common},
                "!Local leaflet classification")
            lc = LeafletClassification.local(
                fields["membrane"], fields["heads"], float(fields["radius"]))
            return finish(lc, fields)
        if tag == "individual":
            fields = _expect_keys(dict(value),
                                  {"heads": [], "methyls": [], **common},
                                  "!Individual leaflet classification")
            lc = LeafletClassification.individual(fields["heads"],
                                                  fields["methyls"])
            return finish(lc, fields)
        if tag == "fromfile":
            if "__scalar__" in value:  # !FromFile "assignment.yaml"
                return LeafletClassification.from_file(value["__scalar__"])
            fields = _expect_keys(dict(value), {"file": [], **common},
                                  "!FromFile leaflet classification")
            lc = LeafletClassification.from_file(fields["file"])
            return finish(lc, fields)
        if tag in ("frommap", "inline"):
            fields = _expect_keys(dict(value), {"assignment": [], **common},
                                  "!FromMap leaflet classification")
            lc = LeafletClassification.from_map(fields["assignment"])
            return finish(lc, fields)
        if tag == "fromndx":
            fields = _expect_keys(
                dict(value),
                {"ndx": [], "heads": [], "upper_leaflet": [],
                 "lower_leaflet": [], **common},
                "!FromNdx leaflet classification")
            lc = LeafletClassification.from_ndx(
                fields["ndx"], fields["heads"], fields["upper_leaflet"],
                fields["lower_leaflet"])
            return finish(lc, fields)
        if tag == "clustering":
            fields = _expect_keys(dict(value), {"heads": [], **common},
                                  "!Clustering leaflet classification")
            lc = LeafletClassification.clustering(fields["heads"])
            return finish(lc, fields)
        if tag in ("sphericalclustering", "spherical"):
            fields = _expect_keys(dict(value), {"heads": [], **common},
                                  "!SphericalClustering leaflet classification")
            lc = LeafletClassification.spherical(fields["heads"])
            return finish(lc, fields)
        raise ConfigError(f"unknown leaflet classification '!{value.tag}'")


# ------------------------------------------------------------------- ordermap


@dataclass
class GridSpan:
    auto: bool = True
    start: float = 0.0
    end: float = 0.0

    @staticmethod
    def manual(start: float, end: float) -> "GridSpan":
        if start > end:
            # wording: src/errors.rs:21-23 (GridSpanError::Invalid)
            raise OrderMapError(
                f"the first coordinate for the grid span ('{fnum(start)}' "
                f"nm) is higher than the second coordinate for the grid "
                f"span ('{fnum(end)}' nm)")
        return GridSpan(False, start, end)

    @staticmethod
    def parse(value) -> "GridSpan":
        if value is None:
            return GridSpan()
        if isinstance(value, GridSpan):
            return value
        if isinstance(value, _Tagged):
            if value.tag.lower() == "auto":
                return GridSpan()
            if value.tag.lower() == "manual":
                fields = _expect_keys(dict(value), {"start": [], "end": []},
                                      "!Manual grid span")
                return GridSpan.manual(float(fields["start"]),
                                       float(fields["end"]))
            raise OrderMapError(f"unknown grid span '!{value.tag}'")
        raise OrderMapError(f"invalid grid span '{value}'")


@dataclass
class OrderMapParams:
    """2-D ordermap parameters (src/input/ordermap.rs:21-275)."""

    output_directory: Optional[str] = None
    min_samples: int = 1
    bin_size: Tuple[float, float] = (0.1, 0.1)
    dim: Tuple[GridSpan, GridSpan] = dataclass_field(
        default_factory=lambda: (GridSpan(), GridSpan()))
    plane: Optional[str] = None  # 'xy' | 'xz' | 'yz'

    @staticmethod
    def parse(value) -> Optional["OrderMapParams"]:
        if value is None:
            return None
        if isinstance(value, OrderMapParams):
            return value
        if value is True or value == "default":
            return OrderMapParams()
        if value is False:
            raise OrderMapError(
                "invalid value 'false' for 'map'; omit the field instead")
        if not isinstance(value, dict):
            raise OrderMapError(f"invalid ordermap specification '{value}'")
        fields = _expect_keys(
            dict(value),
            {"output_directory": ["output_dir"], "min_samples": [],
             "bin_size": [], "dim": [], "plane": []},
            "ordermap parameters")
        params = OrderMapParams()
        params.output_directory = fields.get("output_directory")
        if params.output_directory is not None:
            # the ordermap writer clears its output directory — refusing the
            # cwd protects the user's working tree (ordermap.rs:196-214)
            resolved = os.path.realpath(params.output_directory)
            if resolved == os.path.realpath(os.getcwd()):
                # wording: src/errors.rs:407-408
                # (OrderMapConfigError::InvalidOutputDirectory)
                raise OrderMapError(
                    "output directory specified for saving ordermaps "
                    "cannot be the current directory "
                    f"(provided path: '{params.output_directory}')")
        params.min_samples = int(fields.get("min_samples", 1))
        if params.min_samples < 1:
            # wording: src/errors.rs:372-375
            # (OrderMapConfigError::InvalidMinSamples)
            raise OrderMapError(
                "the specified value of 'min_samples' inside 'ordermap' is "
                "invalid (must be positive)")
        bin_size = fields.get("bin_size", [0.1, 0.1])
        if isinstance(bin_size, (int, float)):
            bin_size = [bin_size, bin_size]
        if len(bin_size) != 2:
            raise OrderMapError(f"invalid ordermap bin size '{bin_size}'")
        for b in bin_size:
            if float(b) <= 0:
                # wording: src/errors.rs:384-388
                # (OrderMapConfigError::InvalidBinSize)
                raise OrderMapError(
                    f"invalid bin size of 'ordermap': value is "
                    f"'{fnum(float(b))}', must be positive")
        params.bin_size = (float(bin_size[0]), float(bin_size[1]))
        dim = fields.get("dim")
        if dim is not None:
            if len(dim) != 2:
                raise OrderMapError("ordermap 'dim' must have two entries")
            params.dim = (GridSpan.parse(dim[0]), GridSpan.parse(dim[1]))
        # note: bin-size-vs-span (BinTooLarge) is validated when the grid is
        # built, once the simulation box (auto spans) is known —
        # core/ordermap.py build_map_spec, mirroring ordermap.rs Map::new
        plane = fields.get("plane")
        if plane is not None:
            plane = str(plane).lower()
            if plane not in ("xy", "xz", "yz"):
                raise OrderMapError(f"invalid ordermap plane '{plane}'")
            params.plane = plane
        return params


# ------------------------------------------------------------ error estimation


@dataclass
class EstimateError:
    """Block-averaged error estimation (src/input/estimate_error.rs)."""

    n_blocks: int = 5
    output_convergence: Optional[str] = None

    @staticmethod
    def parse(value) -> Optional["EstimateError"]:
        if value is None:
            return None
        if isinstance(value, EstimateError):
            return value
        if value is True or value == "default":
            return EstimateError()
        if value is False:
            raise ConfigError(
                "invalid value 'false' for 'estimate_error'; omit the field "
                "instead")
        if not isinstance(value, dict):
            raise ConfigError(f"invalid estimate_error specification '{value}'")
        fields = _expect_keys(dict(value),
                              {"n_blocks": [], "output_convergence": []},
                              "estimate_error parameters")
        n_blocks = int(fields.get("n_blocks", 5))
        if n_blocks < 2:
            # wording: src/errors.rs:414-416
            # (ErrorEstimationError::NotEnoughBlocks)
            raise ErrorEstimationError(
                f"number of blocks for error estimation must be at least 2, "
                f"not '{n_blocks}'")
        return EstimateError(n_blocks=n_blocks,
                             output_convergence=fields.get("output_convergence"))


# ------------------------------------------------------------------- geometry


@dataclass
class Geometry:
    """Cuboid / cylinder / sphere region selection
    (src/input/geometry.rs:20-352)."""

    kind: str                               # 'cuboid' | 'cylinder' | 'sphere'
    reference: Union[str, Sequence[float], None] = None  # query | point | None=center
    # cuboid
    xdim: Tuple[float, float] = (-float("inf"), float("inf"))
    ydim: Tuple[float, float] = (-float("inf"), float("inf"))
    zdim: Tuple[float, float] = (-float("inf"), float("inf"))
    # cylinder
    radius: float = float("inf")
    span: Tuple[float, float] = (-float("inf"), float("inf"))
    invert: bool = False
    orientation: str = "z"

    def __post_init__(self):
        if self.kind not in ("cuboid", "cylinder", "sphere"):
            raise GeometryError(f"unknown geometry '{self.kind}'")
        if self.kind == "cylinder" and self.orientation not in _AXES:
            raise GeometryError(
                f"invalid cylinder orientation '{self.orientation}'")
        if self.radius < 0:
            # wording: src/errors.rs:32-35 (GeometryConfigError::InvalidRadius)
            raise GeometryError(
                f"the specified radius for the geometry selection is "
                f"'{fnum(self.radius)}' but it must be non-negative")
        for what, span in (("xdim", self.xdim), ("ydim", self.ydim),
                           ("zdim", self.zdim)):
            if span[0] > span[1]:
                # wording: src/errors.rs:29-30
                # (GeometryConfigError::InvalidDimension)
                raise GeometryError(
                    f"the first value for dimension ('{fnum(span[0])}' nm) "
                    f"is higher than the second value for dimension "
                    f"('{fnum(span[1])}' nm)")
        if self.span[0] > self.span[1]:
            # wording: src/errors.rs:37-40 (GeometryConfigError::InvalidSpan)
            raise GeometryError(
                f"the first value for span ('{fnum(self.span[0])}' nm) is "
                f"higher than the second value for span "
                f"('{fnum(self.span[1])}' nm)")

    @staticmethod
    def _parse_reference(value):
        if value is None:
            return None  # box center
        if isinstance(value, str):
            return value
        if isinstance(value, (list, tuple)) and len(value) == 3:
            return tuple(float(v) for v in value)
        raise GeometryError(f"invalid geometry reference '{value}'")

    @staticmethod
    def _parse_span(value, what) -> Tuple[float, float]:
        if value is None:
            return (-float("inf"), float("inf"))
        if not isinstance(value, (list, tuple)) or len(value) != 2:
            raise GeometryError(f"invalid {what} '{value}'")
        # ordering is validated in __post_init__ with the reference wording
        return (float(value[0]), float(value[1]))

    @staticmethod
    def parse(value) -> Optional["Geometry"]:
        if value is None:
            return None
        if isinstance(value, Geometry):
            return value
        if not isinstance(value, _Tagged):
            raise GeometryError(
                "geometry must use a !Tag (!Cuboid, !Cylinder, or !Sphere)")
        tag = value.tag.lower()
        if tag == "cuboid":
            fields = _expect_keys(
                dict(value),
                {"reference": [], "xdim": ["x"], "ydim": ["y"],
                 "zdim": ["z"], "invert": []},
                "!Cuboid geometry")
            return Geometry(
                "cuboid",
                reference=Geometry._parse_reference(fields.get("reference")),
                xdim=Geometry._parse_span(fields.get("xdim"), "xdim"),
                ydim=Geometry._parse_span(fields.get("ydim"), "ydim"),
                zdim=Geometry._parse_span(fields.get("zdim"), "zdim"),
                invert=bool(fields.get("invert", False)),
            )
        if tag == "cylinder":
            fields = _expect_keys(
                dict(value),
                {"reference": [], "radius": [], "span": [],
                 "orientation": [], "invert": []},
                "!Cylinder geometry")
            radius = float(fields.get("radius", float("inf")))
            orientation = str(fields.get("orientation", "z")).lower()
            if orientation not in _AXES:
                raise GeometryError(
                    f"invalid cylinder orientation '{orientation}'")
            return Geometry(
                "cylinder",
                reference=Geometry._parse_reference(fields.get("reference")),
                radius=radius,
                span=Geometry._parse_span(fields.get("span"), "cylinder span"),
                orientation=orientation,
                invert=bool(fields.get("invert", False)),
            )
        if tag == "sphere":
            fields = _expect_keys(
                dict(value), {"reference": [], "radius": [], "invert": []},
                "!Sphere geometry")
            radius = float(fields.get("radius", float("inf")))
            return Geometry(
                "sphere",
                reference=Geometry._parse_reference(fields.get("reference")),
                radius=radius,
                invert=bool(fields.get("invert", False)),
            )
        raise GeometryError(f"unknown geometry '!{value.tag}'")


# ------------------------------------------------------------------- Analysis


_ANALYSIS_FIELDS = {
    "structure": [],
    "bonds": [],
    "trajectory": [],
    "index": [],
    "output_yaml": ["output", "output_yml"],
    "output_tab": [],
    "output_xvg": [],
    "output_csv": [],
    "analysis_type": ["type"],
    "membrane_normal": [],
    "begin": ["start"],
    "end": [],
    "step": [],
    "min_samples": [],
    "n_threads": [],
    "leaflets": [],
    "map": ["maps", "ordermap", "ordermaps"],
    "estimate_error": [],
    "geometry": [],
    "handle_pbc": [],
    "silent": [],
    "overwrite": [],
}

_STRUCTURE_FORMATS = (".tpr", ".pdb", ".gro", ".pqr")


@dataclass
class Analysis:
    """Full analysis request (mirrors the reference `Analysis`)."""

    structure: str
    trajectory: List[str]
    analysis_type: AnalysisType
    bonds: Optional[str] = None
    index: Optional[str] = None
    output_yaml: Optional[str] = None
    output_tab: Optional[str] = None
    output_xvg: Optional[str] = None
    output_csv: Optional[str] = None
    membrane_normal: MembraneNormal = dataclass_field(
        default_factory=lambda: MembraneNormal.static("z"))
    begin: float = 0.0
    end: float = float("inf")
    step: int = 1
    min_samples: int = 1
    n_threads: int = 1
    leaflets: Optional[LeafletClassification] = None
    map: Optional[OrderMapParams] = None
    estimate_error: Optional[EstimateError] = None
    geometry: Optional[Geometry] = None
    handle_pbc: bool = True
    silent: bool = False
    overwrite: bool = False
    # pygorder constructor alias for `map` (pygorder Analysis.__new__)
    ordermap: InitVar[Optional[OrderMapParams]] = None

    def __post_init__(self, ordermap=None):
        if ordermap is not None and self.map is None:
            self.map = ordermap
        if isinstance(self.trajectory, str):
            self.trajectory = [self.trajectory]
        # pygorder-style argument coercions (pygorder Analysis.__new__):
        # membrane_normal accepts an axis string or a moltype→vectors map
        if isinstance(self.membrane_normal, str):
            self.membrane_normal = MembraneNormal.static(self.membrane_normal)
        elif isinstance(self.membrane_normal, dict):
            self.membrane_normal = MembraneNormal.from_map(
                self.membrane_normal)
        elif self.membrane_normal is None:
            self.membrane_normal = MembraneNormal.static("z")
        self.validate()

    def validate(self) -> None:
        if not str(self.structure).lower().endswith(_STRUCTURE_FORMATS):
            # wording: src/errors.rs:338-339
            # (ConfigError::InvalidStructureFormat)
            raise ConfigError(
                f"the provided structure file '{self.structure}' has an "
                f"unknown, invalid, or unsupported format")
        # wording: src/errors.rs:304-314 (ConfigError::Invalid{Step,...})
        if self.step < 1:
            raise ConfigError(
                "the specified value of 'step' is invalid (must be positive)")
        if self.min_samples < 1:
            raise ConfigError(
                "the specified value of 'min_samples' is invalid "
                "(must be positive)")
        if self.n_threads < 1:
            raise ConfigError(
                "the specified value of 'n_threads' is invalid "
                "(must be positive)")
        if self.begin > self.end:
            # wording: src/errors.rs:316-320 (ConfigError::InvalidBeginEnd)
            raise ConfigError(
                "invalid values of 'begin' and 'end' "
                "(begin is higher than end)")
        if self.map is not None and self.map.plane is None:
            # plane defaults to the plane perpendicular to a static normal
            if self.membrane_normal.kind == "static":
                axis = self.membrane_normal.axis
                self.map.plane = {"x": "yz", "y": "xz", "z": "xy"}[axis]
            else:
                # wording: src/errors.rs:403-405
                # (OrderMapConfigError::InvalidPlaneAuto)
                raise OrderMapError(
                    "membrane normal is not a static global dimension => "
                    "unable to automatically set ordermap plane "
                    "(hint: set ordermap plane manually)")

    @staticmethod
    def from_yaml_dict(raw: Dict) -> "Analysis":
        if not isinstance(raw, dict):
            raise ConfigError("configuration must be a yaml mapping")
        fields = _expect_keys(raw, _ANALYSIS_FIELDS, "analysis configuration")
        for required in ("structure", "trajectory", "analysis_type"):
            if required not in fields:
                alias = "type" if required == "analysis_type" else required
                raise ConfigError(f"missing required field '{alias}'")
        return Analysis(
            structure=str(fields["structure"]),
            trajectory=fields["trajectory"],
            analysis_type=AnalysisType.parse(fields["analysis_type"]),
            bonds=fields.get("bonds"),
            index=fields.get("index"),
            output_yaml=fields.get("output_yaml"),
            output_tab=fields.get("output_tab"),
            output_xvg=fields.get("output_xvg"),
            output_csv=fields.get("output_csv"),
            membrane_normal=MembraneNormal.parse(fields.get("membrane_normal")),
            begin=float(fields.get("begin", 0.0)),
            end=float(fields.get("end", float("inf"))),
            step=int(fields.get("step", 1)),
            min_samples=int(fields.get("min_samples", 1)),
            n_threads=int(fields.get("n_threads", 1)),
            leaflets=LeafletClassification.parse(fields.get("leaflets")),
            map=OrderMapParams.parse(fields.get("map")),
            estimate_error=EstimateError.parse(fields.get("estimate_error")),
            geometry=Geometry.parse(fields.get("geometry")),
            handle_pbc=bool(fields.get("handle_pbc", True)),
            silent=bool(fields.get("silent", False)),
            overwrite=bool(fields.get("overwrite", False)),
        )

    @staticmethod
    def from_file(path: str) -> "Analysis":
        try:
            with open(path, "r") as fh:
                text = fh.read()
        except OSError:
            # wording: src/errors.rs:289-290 (ConfigError::CouldNotOpenConfig)
            raise ConfigError(
                f"could not open the configuration file '{path}'") from None
        return Analysis.from_yaml_dict(load_yaml(text, path))

    def run(self, device: str = "cuda"):
        """Run this analysis with the PyTorch port on `device` (the GPU
        by default; without one this raises AnalysisError)."""
        from ..engine.drivers import run_analysis

        return run_analysis(self, device)

    def run_partial(self, shard_index: int, shard_count: int,
                    device: str = "cuda") -> dict:
        """Run frame shard `shard_index` of `shard_count` (a contiguous
        block) on `device` and return its raw partial state, to be merged
        by `merge` (one process per GPU; the GPU by default)."""
        from ..engine.drivers import run_analysis_partial

        return run_analysis_partial(self, shard_index, shard_count, device)

    def merge(self, states):
        """Merge partial states (dicts, or paths of the files
        `parallel.shard.save_partial` writes, of this package or of
        gorder_tpu) into the results of the whole run, byte for byte a
        single run's. Host work only."""
        from ..engine.drivers import merge_partial_states
        from ..parallel.shard import load_partial

        loaded = [load_partial(s) if isinstance(s, str) else s
                  for s in states]
        return merge_partial_states(self, loaded)
