"""The dynamic normals' neighbour kernel (`gorder_tpu_torch/ops/
neighbors.py` → `csrc/neighbors.cu` `normal_cloud_kernel`): the least
time the window's clouds need on the card, counting the work these inputs
need, not the dense kernel's heads × cloud pairs: per frame, every
(head, cloud atom) pair within the radius (the head itself included),
each with its distance once (the offset 3, the minimum image 12, d² 5,
the test 1: 21 f32 operations) and its covariance terms once (the count
and the centroid sums 4, the centred products 15: 19); each head read
once (12 bytes) and each head's count and six covariances written once
(28 bytes), and the frame's box. The pairs are the reference's exact
integer count (`reference/normals/dynamic.py`); a run whose normal
method counts no pairs has no cloud work here."""

from __future__ import annotations

from benchmark.peaks import bound_s as bound

KERNELS = ("normal_cloud",)
PAIR_OPS = 21 + 19
HEAD_BYTES = 12 + 28


def start(ref, config):
    if getattr(ref.normal, "cloud_pairs", None) is None:
        return None
    return {"frames": 0, "heads": int(ref.normal.heads.numel()),
            "pairs": 0}


def add(state, ints):
    state["frames"] += ints.shape[0]


def finish(state, ref):
    state["pairs"] = int(ref.normal.cloud_pairs)


def bound_s(state, peaks):
    """The least seconds of one analysis's cloud work on a card of
    `peaks`."""
    moved = state["frames"] * (state["heads"] * HEAD_BYTES + 12)
    return bound(peaks, moved, state["pairs"] * PAIR_OPS)
