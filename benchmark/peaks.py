"""Published peaks of the cards the benchmark reports rooflines for: the
card's name (as `torch.cuda.get_device_name()` gives it) must hold the
entry's `match`. NVIDIA's H100 data sheet, SXM part, dense rates without
sparsity, at its full power limit of 700 W: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores."""

from __future__ import annotations

TABLE = [
    {"match": "H100", "hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
]


def peaks_of(kind: str):
    """The peaks of the card named `kind`, or None (no roofline then)."""
    for entry in TABLE:
        if entry["match"] in kind:
            return entry
    return None


def bound_s(peaks: dict, moved_bytes: float, f32_ops: float) -> float:
    """The least seconds the card needs: the larger of the bytes over the
    memory rate and the operations over their rate."""
    return max(moved_bytes / peaks["hbm_bytes_per_s"],
               f32_ops / peaks["f32_ops_per_s"])
