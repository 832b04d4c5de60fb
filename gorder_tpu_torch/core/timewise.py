"""Block-averaged error estimation and convergence curves.

Behavioral reference: src/analysis/timewise.rs (TimeWiseData::estimate_error
:191-231, prefix_average :259-274). Works on the per-frame fixed-point sums
the accumulator already collects — the reference's per-thread TimeWiseData
vectors become (frames, types) arrays, and the interleave-merge machinery
disappears because frames are processed in order.

All divisions reproduce the reference's OrderValue integer division
(i64 // n, truncated toward zero) so printed values agree to the last digit.
"""

from __future__ import annotations

import numpy as np

_SCALE = 1.0e6


def _trunc_div(sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """i64 division truncated toward zero (Rust semantics), → float order."""
    counts = np.asarray(counts)
    safe = np.where(counts > 0, counts, 1)
    q = np.trunc(np.asarray(sums, np.float64) / safe)
    return np.where(counts > 0, q / _SCALE, np.nan)


def estimate_error(frame_sums: np.ndarray, frame_counts: np.ndarray,
                   n_blocks: int) -> float:
    """Sample standard deviation of block means.

    frame_sums: (F,) int64 fixed-point sums per analyzed frame;
    frame_counts: (F,) int64 sample counts. Frames are split into n_blocks
    contiguous blocks of F // n_blocks frames (remainder dropped); each block
    mean is sample-weighted; a block with zero samples → NaN.
    """
    n_frames = len(frame_sums)
    if n_frames == 0:
        return float("nan")
    block_size = n_frames // n_blocks
    if block_size == 0:
        return float("nan")
    used = block_size * n_blocks
    bsums = frame_sums[:used].reshape(n_blocks, block_size).sum(axis=1)
    bcounts = frame_counts[:used].reshape(n_blocks, block_size).sum(axis=1)
    if np.any(bcounts == 0):
        return float("nan")
    means = _trunc_div(bsums, bcounts)
    return float(np.std(means.astype(np.float32), ddof=1))


def prefix_average(frame_sums: np.ndarray, frame_counts: np.ndarray
                   ) -> np.ndarray:
    """Sample-weighted prefix averages (convergence curve); NaN while the
    cumulative sample count is zero."""
    csums = np.cumsum(np.asarray(frame_sums, np.int64))
    ccounts = np.cumsum(np.asarray(frame_counts, np.int64))
    return _trunc_div(csums, ccounts).astype(np.float32)
