"""pygorder ``gorder.leaflets`` (leaflets.pyi)."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

from ..input.config import Frequency, LeafletClassification


def _finish(lc: LeafletClassification, frequency=None, membrane_normal=None,
            collect=None, flip=False) -> LeafletClassification:
    if frequency is not None:
        lc.with_frequency(frequency if isinstance(frequency, Frequency)
                          else Frequency.parse(frequency))
    if membrane_normal is not None:
        lc.with_membrane_normal(membrane_normal)
    if collect is not None:
        lc.with_collect(collect)
    if flip:
        lc.with_flip(True)
    return lc


def GlobalClassification(membrane: str, heads: str, frequency=None,
                         membrane_normal: Optional[str] = None,
                         collect=None, flip: bool = False):
    return _finish(LeafletClassification.global_(membrane, heads),
                   frequency, membrane_normal, collect, flip)


def LocalClassification(membrane: str, heads: str, radius: float,
                        frequency=None,
                        membrane_normal: Optional[str] = None,
                        collect=None, flip: bool = False):
    return _finish(LeafletClassification.local(membrane, heads, radius),
                   frequency, membrane_normal, collect, flip)


def IndividualClassification(heads: str, methyls: str, frequency=None,
                             membrane_normal: Optional[str] = None,
                             collect=None, flip: bool = False):
    return _finish(LeafletClassification.individual(heads, methyls),
                   frequency, membrane_normal, collect, flip)


def ClusteringClassification(heads: str, frequency=None, collect=None,
                             flip: bool = False):
    return _finish(LeafletClassification.clustering(heads),
                   frequency, None, collect, flip)


def SphericalClusteringClassification(heads: str, frequency=None,
                                      collect=None, flip: bool = False):
    return _finish(LeafletClassification.spherical(heads),
                   frequency, None, collect, flip)


def ManualClassification(input: Union[str, Mapping], frequency=None,
                         flip: bool = False):
    if isinstance(input, str):
        lc = LeafletClassification.from_file(input)
    else:
        lc = LeafletClassification.from_map(
            {k: [list(map(int, row)) for row in v]
             if not isinstance(v, list) or (v and not isinstance(v[0], list))
             else v for k, v in dict(input).items()})
    return _finish(lc, frequency, None, None, flip)


def NdxClassification(ndx: Sequence[str], heads: str, upper_leaflet: str,
                      lower_leaflet: str, frequency=None,
                      flip: bool = False):
    return _finish(
        LeafletClassification.from_ndx(ndx, heads, upper_leaflet,
                                       lower_leaflet),
        frequency, None, None, flip)


__all__ = ["GlobalClassification", "LocalClassification",
           "IndividualClassification", "ClusteringClassification",
           "SphericalClusteringClassification", "ManualClassification",
           "NdxClassification"]
