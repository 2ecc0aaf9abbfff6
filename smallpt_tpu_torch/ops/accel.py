"""Grid-binning helpers of the ray acceleration (PyTorch port of the part of
smallpt_tpu/ops/accel.py that the mesh grid accel, ops/mesh_accel.py,
needs).

A ray's bin is (origin grid cell) x (one of N_DIR direction cones: the
dominant axis x the component-sign octant); ``_reach_masks`` decides on the
host, conservatively, which chunk of primitives any ray of a bin can reach.
The rest of the JAX module (the sphere grid accel and the binned
scheduler's tile work lists) arrives with the binned scheduler (ROADMAP.md,
modules item 11, kernel K8).
"""

from __future__ import annotations

import numpy as np
import torch

N_DIR = 24  # dominant axis (3) x component-sign octant (8)


def _reach_masks(cell_lo, cell_hi, k_lo, k_hi):
    """Conservative bin -> chunk reachability, in numpy on the host.

    cell_lo/hi: (Bo, 3) origin-cell AABBs (border cells pre-extended to
    +-inf); k_lo/hi: (C, 3) chunk AABBs. Returns (Bo, N_DIR, C) bool.

    Test: does the displacement box D = [k_lo - cell_hi, k_hi - cell_lo]
    contain any vector v with the cone's sign pattern and |v_dom| maximal?
    Choosing v_dom at its largest feasible magnitude m relaxes the other
    components monotonically, so the test reduces to per-axis interval
    checks (conservative, never misses a reachable chunk)."""
    d_lo = k_lo[None, :, :] - cell_hi[:, None, :]  # (Bo, C, 3)
    d_hi = k_hi[None, :, :] - cell_lo[:, None, :]

    out = np.zeros((d_lo.shape[0], N_DIR, d_lo.shape[1]), dtype=bool)
    for dom in range(3):
        o1, o2 = [a for a in range(3) if a != dom]
        for bits in range(8):
            sg = [1 - 2 * ((bits >> (2 - a)) & 1) for a in range(3)]
            # dominant-axis magnitude bound m = max |v_dom| with the right
            # sign
            m = d_hi[..., dom] if sg[dom] > 0 else -d_lo[..., dom]
            ok = m > 0
            for o in (o1, o2):
                if sg[o] > 0:
                    # need [d_lo, d_hi]_o to meet [0, m]
                    ok &= (d_hi[..., o] >= 0) & (d_lo[..., o] <= m)
                else:
                    ok &= (d_lo[..., o] <= 0) & (d_hi[..., o] >= -m)
            out[:, dom * 8 + bits, :] = ok
    return out


def _dir_bin(dx, dy, dz):
    """Direction cone of each ray: dominant axis * 8 + sign octant."""
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    dom = torch.where((ax >= ay) & (ax >= az), 0,
                      torch.where(ay >= az, 1, 2))
    bits = ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
            + (dz < 0).to(torch.int32))
    return (dom * 8 + bits).to(torch.int32)


def _axis_cell(p, lo, inv_cell, n: int):
    """Grid cell index along one axis, clipped to [0, n - 1]. XLA converts
    float to int32 by truncation, saturating, with NaN to 0; clamping to
    [-1, n] first gives the same clipped index without torch's undefined
    out-of-range conversion."""
    f = torch.nan_to_num((p - lo) * inv_cell, nan=0.0)
    return f.clamp(-1.0, float(n)).to(torch.int32).clamp(0, n - 1)


def _cell_lin(px, py, pz, lo, inv_cell, nb):
    """Linear origin-grid cell (z fastest) of each ray origin."""
    bx, by, bz = nb
    cx = _axis_cell(px, lo[0], inv_cell[0], bx)
    cy = _axis_cell(py, lo[1], inv_cell[1], by)
    cz = _axis_cell(pz, lo[2], inv_cell[2], bz)
    return (cx * by + cy) * bz + cz
