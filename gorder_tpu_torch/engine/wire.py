"""The b7 wire: its host-side probe and its device-side decoders on
tensors (port of `gorder_tpu/engine/wire.py:89-133` and `_probe_b7`), the
int16 dequantization, and the geometry bitplane (`geo_bits`, port of
`gorder_tpu/engine/fused.py:69-76`, and its inverse `pack_geo_bits`). In
the JAX package the decoders are XLA code, not Pallas, so here they are
plain PyTorch ops on whatever device the payload lies on.

The bit arithmetic runs in int32: every intermediate below fits, and
PyTorch's unsigned types lack most operations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.native import b7_stride


def _probe_b7(traj, frame_indices, space, bond_a, bond_b, n_threads,
              batch_size):
    """Probe the b7 bond-difference wire format over one batch-sized
    window. Returns a sized esc_cap or None when unfit."""
    n = len(frame_indices)
    w = frame_indices[:min(batch_size, n)]
    esc_cap = 512
    for _attempt in range(2):
        pack = np.zeros((len(w), b7_stride(len(bond_a))), np.uint8)
        gaps = np.zeros((len(w), esc_cap), np.uint16)
        vals = np.zeros((len(w), esc_cap), np.int16)
        res, nesc = traj.read_frames_b7(w, space, bond_a, bond_b,
                                        pack, gaps, vals,
                                        n_threads=n_threads)
        if res is not None:
            cap = int(nesc * 1.4) + 64
            return max(128, min(8192, (cap + 127) // 128 * 128))
        if nesc <= esc_cap or nesc > 8192:
            return None  # unfit for reasons other than capacity
        esc_cap = min(8192, ((int(nesc * 2) + 127) // 128) * 128)
    return None


def b7_residuals(pk: torch.Tensor, gp: torch.Tensor, vl: torch.Tensor,
                 nv: int) -> torch.Tensor:
    """Unpack the b7 wire's escape-applied residuals (port of
    `_b7_residuals_impl`): 7-bit codes, eight per 7 bytes little-endian,
    sign-extended, then the sparse escape channel scattered in.

    pk (B, stride) uint8; gp (B, cap) escape gaps, u16 values carried in an
    int16 tensor (the bits are reinterpreted here); vl (B, cap) int16
    escape values → (B, nv) int16."""
    b = pk.shape[0]
    by = pk.reshape(b, -1, 7).to(torch.int32).unbind(-1)
    lo = by[0] | (by[1] << 8) | (by[2] << 16)           # bits 0-23
    hi = by[4] | (by[5] << 8) | (by[6] << 16)           # bits 32-55
    codes = torch.stack([
        lo & 127, (lo >> 7) & 127, (lo >> 14) & 127,
        ((lo >> 21) | (by[3] << 3)) & 127,               # bits 21-27
        ((by[3] >> 4) | (hi << 4)) & 127,                # bits 28-34
        (hi >> 3) & 127, (hi >> 10) & 127, (hi >> 17) & 127,
    ], dim=-1).reshape(b, -1)
    codes = ((codes + 64) & 127) - 64                    # sign-extend
    r = torch.zeros((b, nv + 1), dtype=torch.int16, device=pk.device)
    r[:, :nv] = codes[:, :nv]
    gaps = gp.to(torch.int32) & 0xFFFF
    pos = torch.cumsum(gaps, dim=1, dtype=torch.int32) - 1
    # gap 0 is padding: scatter it into the spare column nv, sliced off
    pos = torch.where((gaps == 0) | (pos >= nv), nv, pos)
    r.scatter_(1, pos.to(torch.int64), vl.to(torch.int16))
    return r[:, :nv].contiguous()


def b7(pk, gp, vl, base) -> torch.Tensor:
    """b7 wire → (B, n_bonds, 3) int32 exact bond integer differences
    (port of `_b7_impl`)."""
    nv = base.shape[0]
    r = b7_residuals(pk, gp, vl, nv).to(torch.int32)
    return (base.to(torch.int32)[None, :] + r).reshape(pk.shape[0], nv // 3, 3)


def dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int XTC integers → f32 nm, f32(q)·s, bit-identical to the host
    decode (port of `_dequant_impl`)."""
    return q.to(torch.float32) * s[:, None, None]


def geo_bits(geo: torch.Tensor, n_bonds: int) -> torch.Tensor:
    """(B, ⌈N/8⌉) uint8 geometry bitplane → (B, n_bonds) bool: bit j of
    byte j >> 3 is bond j inside the shape, the layout of the decoder's
    bitplane (native/xdr.cpp xtc_geo_mask; gorder_tpu/engine/fused.py
    geo_bits, which gives the same bits as f32)."""
    shifts = torch.arange(8, dtype=torch.int32, device=geo.device)
    bits = (geo.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(geo.shape[0], -1)[:, :n_bonds].to(torch.bool)


def pack_geo_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool inside-shape mask → the (B, ⌈N/8⌉) uint8 bitplane of
    `geo_bits`, so that a mask computed on the device and the decoder's
    reach the P2 kernel in one layout."""
    b, n = mask.shape
    pad = (-n) % 8
    bits = torch.nn.functional.pad(mask.to(torch.int32), (0, pad))
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (bits.reshape(b, -1, 8) * weights).sum(-1, dtype=torch.int32) \
        .to(torch.uint8)
