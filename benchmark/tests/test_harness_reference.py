"""The plain reference against hand-computed bonds, normals and
leaflets."""

import math

import numpy as np
import torch

from benchmark.reference.normals import dynamic_normals
from benchmark.reference.order import OrderReference, quantize
from benchmark.reference.spherical import spherical_classes

AA = {"type": {"!": "AAOrder", "heavy_atoms": "resname LIP and name r'^C'",
               "hydrogens": "resname LIP and name r'^H'"},
      "membrane_normal": "z"}


def _two_lipids():
    names = ["C1", "H1", "H2", "C2"] * 2
    resnames = ["LIP"] * 8
    molecule = np.repeat([0, 1], 4)
    bonds = np.array([[0, 1], [0, 2], [0, 3], [4, 5], [4, 6], [4, 7]])
    # molecule 0: C1-H1 along z (S = 1), C1-H2 along x (S = -0.5);
    # molecule 1: C1-H1 across the x boundary, 45 degrees from z after
    # the minimum image (S = 0.25), C1-H2 along y (S = -0.5)
    frame = [[1000, 1000, 1000], [1000, 1000, 1100], [1100, 1000, 1000],
             [900, 1000, 1000],
             [9950, 5000, 5000], [50, 5000, 5100], [9950, 5100, 5000],
             [9850, 5000, 5000]]
    ints = torch.tensor([frame, frame], dtype=torch.int32)
    return names, resnames, molecule, bonds, ints


def test_quantize_rounds_half_away_from_zero():
    s = torch.tensor([0.5e-6, -0.5e-6, 1.5e-6, 0.25], dtype=torch.float64)
    assert quantize(s).tolist() == [1, -1, 2, 250000]


def test_aa_order_by_hand():
    names, resnames, molecule, bonds, ints = _two_lipids()
    ref = OrderReference(names, resnames, molecule, bonds, [10.0] * 3,
                         1000.0, AA, "cpu")
    ref.add(ints)
    got = ref.values()
    atom = ("LIP", "order parameters", "LIP C1 (0)")
    assert got[atom + ("bonds", "LIP H1 (1)", "total")] == -0.625
    assert got[atom + ("bonds", "LIP H2 (2)", "total")] == 0.5
    assert got[atom + ("total",)] == -0.0625
    assert got[("LIP", "average order", "total")] == -0.0625
    assert got[("average order", "total")] == -0.0625
    assert len(got) == 5


def test_cg_order_by_hand():
    names, resnames, molecule, bonds, ints = _two_lipids()
    ref = OrderReference(names, resnames, molecule, bonds[[0, 3]],
                         [10.0] * 3, 1000.0,
                         {"type": {"!": "CGOrder", "beads": "resname LIP"}},
                         "cpu")
    ref.add(ints)
    got = ref.values()
    assert got[("LIP", "order parameters", "LIP C1 (0) - LIP H1 (1)",
                "total")] == 0.625


def test_dynamic_normal_of_a_flat_cloud():
    g = np.arange(5) * 500
    plane = np.array([[x, y, 5000] for x in g for y in g])
    plane[:, 0] = (plane[:, 0] - 800) % 10000        # across the x edge
    heads = torch.tensor(plane[None], dtype=torch.int32)
    box = torch.tensor([10000.0] * 3, dtype=torch.float64)
    normals, pairs = dynamic_normals(heads, heads, box, 2000 ** 2)
    assert torch.allclose(normals[0, :, 2].abs(),
                          torch.ones(25, dtype=torch.float64))
    # within 2000 of (0, 0): the grid points of |(i, j)| <= 4 steps
    per_head = [sum((i - a) ** 2 + (j - b) ** 2 <= 16 for a in range(5)
                    for b in range(5)) for i in range(5) for j in range(5)]
    assert pairs == sum(per_head)


def test_spherical_classes_of_two_shells():
    def shell(n, r):
        i = np.arange(n) + 0.5
        z = 1 - 2 * i / n
        t = math.pi * (3 - math.sqrt(5)) * i
        s = np.sqrt(1 - z * z)
        return 4500 + r * np.stack([s * np.cos(t), s * np.sin(t), z], 1)

    heads = np.concatenate([shell(60, 3000), shell(40, 2000)])
    ints = torch.tensor(np.rint(heads)[None], dtype=torch.int32)
    box = torch.tensor([9000.0] * 3, dtype=torch.float64)
    classes = spherical_classes(ints, box, 1000.0)
    assert classes[0, :60].eq(0).all() and classes[0, 60:].eq(1).all()
