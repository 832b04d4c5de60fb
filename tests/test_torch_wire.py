"""The port's device-side wire decoders (gorder_tpu_torch/engine/wire.py)
against the JAX package's (gorder_tpu/engine/wire.py `_b7_residuals_impl`,
`_b7_impl`, `_dequant_impl`): the outputs must be equal; and the P2
step's packed b7 entry (`p2_b7`) against the JAX package's order step on
the same decoded wire."""

import numpy as np
import pytest
import torch

from gorder_tpu.engine.wire import (
    _b7_impl,
    _b7_residuals_impl,
    _dequant_impl,
)
from gorder_tpu_torch.io import native
from gorder_tpu_torch.io.traj import AtomSubset, Trajectory
from gorder_tpu_torch.engine.wire import b7, b7_residuals, dequant

N_PAIRS = 30
N_FRAMES = 40
PAD = 8          # zero padding rows, as the batch loop leaves them


@pytest.fixture(scope="module")
def b7_payload(tmp_path_factory):
    """A small XTC whose first half of bonds stays near a fixed vector and
    whose second half jumps by up to ±0.5 nm per frame (escapes), decoded
    on the b7 wire into buffers with trailing zero padding rows."""
    rng = np.random.default_rng(4)
    box = np.array([6.0, 6.0, 6.0], np.float32)
    a = rng.uniform(0.5, 5.5, (N_FRAMES, N_PAIRS, 3))
    vec = np.tile(rng.uniform(-0.15, 0.15, (1, N_PAIRS, 3)), (N_FRAMES, 1, 1))
    vec += rng.normal(0, 0.005, vec.shape)
    vec[:, N_PAIRS // 2:] += rng.uniform(-0.5, 0.5,
                                         (N_FRAMES, N_PAIRS // 2, 3))
    coords = np.empty((N_FRAMES, 2 * N_PAIRS, 3), np.float32)
    coords[:, 0::2] = a
    coords[:, 1::2] = a + vec
    xtc = str(tmp_path_factory.mktemp("wire") / "wire.xtc")
    native.xtc_write(xtc, coords, np.tile(np.diag(box), (N_FRAMES, 1, 1)),
                     np.arange(N_FRAMES, dtype=np.float32),
                     np.arange(N_FRAMES, dtype=np.int32), precision=1000.0)

    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    space = AtomSubset.prefix(2 * N_PAIRS)
    bond_a = np.arange(0, 2 * N_PAIRS, 2, dtype=np.int32)
    bond_b = bond_a + 1
    esc_cap = 1024
    rows = N_FRAMES + PAD
    pk = np.zeros((rows, native.b7_stride(N_PAIRS)), np.uint8)
    eg = np.zeros((rows, esc_cap), np.uint16)
    ev = np.zeros((rows, esc_cap), np.int16)
    res, nesc = traj.read_frames_b7(idx, space, bond_a, bond_b, pk, eg, ev)
    assert res is not None, f"escape demand {nesc} exceeds {esc_cap}"
    base, inv_prec, _, _, _ = res
    q, _, _, _, _ = traj.read_frames_quantized(idx, space)
    d_true = (q[:, bond_b].astype(np.int32) - q[:, bond_a].astype(np.int32))
    return dict(pk=pk, eg=eg, ev=ev, base=base, inv=inv_prec, nesc=nesc,
                d_true=d_true, q=q)


def _port_args(p):
    t = torch.as_tensor
    return t(p["pk"]), t(p["eg"].view(np.int16)), t(p["ev"])


def test_b7_residuals_match_jax(b7_payload):
    p = b7_payload
    assert p["nesc"] > 0 and (p["eg"] != 0).any(), "no escapes exercised"
    nv = 3 * N_PAIRS
    got = b7_residuals(*_port_args(p), nv).numpy()
    want = np.asarray(_b7_residuals_impl(p["pk"], p["eg"], p["ev"], nv))
    assert got.dtype == np.int16 and got.shape == (N_FRAMES + PAD, nv)
    np.testing.assert_array_equal(got, want)


def test_b7_matches_jax_and_exact_differences(b7_payload):
    p = b7_payload
    got = b7(*_port_args(p), torch.as_tensor(p["base"])).numpy()
    want = np.asarray(_b7_impl(p["pk"], p["eg"], p["ev"], p["base"]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:N_FRAMES], p["d_true"])
    # padding rows decode to the base differences
    np.testing.assert_array_equal(
        got[N_FRAMES:], np.broadcast_to(p["base"].reshape(-1, 3),
                                        (PAD, N_PAIRS, 3)))


def test_b7_residuals_random_payload():
    """Every code position of the 7-byte groups, escape gaps above 2^15
    (u16 values carried in int16), padding gaps and positions past the
    end, on random bytes."""
    rng = np.random.default_rng(11)
    B, nv = 5, 40_003
    pk = rng.integers(0, 256, (B, native.b7_stride(nv // 3)), np.uint8)
    eg = np.zeros((B, 6), np.uint16)
    eg[:, :3] = [[40_000, 7, 1], [1, 65_535, 0], [0, 0, 0],
                 [39_999, 3, 5], [20_000, 20_000, 10]]
    ev = rng.integers(-32_768, 32_767, (B, 6), np.int16)
    got = b7_residuals(torch.as_tensor(pk), torch.as_tensor(eg.view(np.int16)),
                       torch.as_tensor(ev), nv).numpy()
    want = np.asarray(_b7_residuals_impl(pk, eg, ev, nv))
    np.testing.assert_array_equal(got, want)


def test_dequant_matches_jax(b7_payload):
    p = b7_payload
    s = np.asarray(p["inv"], np.float32)
    got = dequant(torch.as_tensor(p["q"]), torch.as_tensor(s)).numpy()
    want = np.asarray(_dequant_impl(p["q"], s))
    np.testing.assert_array_equal(got, want)


def test_packed_entry_matches_jax(b7_payload, monkeypatch):
    """`p2_b7` on the decoder's packed wire (the plain version on the CPU:
    the unpack, then the step) equals the JAX package's order step (XLA
    path, op by op) on the residuals its own decoder unpacks."""
    from gorder_tpu.core.order import make_order_step as jax_make_order_step
    from gorder_tpu_torch.core.order import from_reference_rows
    from gorder_tpu_torch.ops import p2

    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    p = b7_payload
    rows = N_FRAMES + PAD
    atom_a = np.arange(0, 2 * N_PAIRS, 2, dtype=np.int32)
    btype = (np.arange(N_PAIRS) // 4).astype(np.int32)   # runs of 4
    n_types = int(btype.max()) + 1
    box = np.full((rows, 3), 6.0, np.float32)
    mask = np.arange(rows) < N_FRAMES
    inv = np.zeros(rows, np.float32)
    inv[:N_FRAMES] = p["inv"]
    normal = np.array([0.0, 0.0, 1.0], np.float32)
    t = torch.as_tensor
    got = p2.p2_b7(*_port_args(p), t(p["base"]), t(inv), t(box), t(normal),
                   t(mask), t(btype), n_types, handle_pbc=True).numpy()
    step = jax_make_order_step(atom_a, atom_a + 1, btype,
                               np.zeros(N_PAIRS, np.int32), n_types, 1)
    r = np.asarray(_b7_residuals_impl(p["pk"], p["eg"], p["ev"],
                                      3 * N_PAIRS))
    out, _ = step.impl((r, p["base"]), box, normal, mask, inv_scale=inv,
                       resid_input=True, use_pallas=False)
    np.testing.assert_array_equal(got,
                                  from_reference_rows(np.asarray(
                                      out["total"])))
    assert got[:N_FRAMES, 1].sum() == N_FRAMES * N_PAIRS
    assert not got[N_FRAMES:].any()
