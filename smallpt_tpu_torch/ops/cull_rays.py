"""Rays built to reach the edges of K7's box cull and its group walk
(csrc/closest_tri_culled.cu), on a mesh's accel: what
tests/test_torch_tri_cull.py holds the plain cull and sweep to on the CPU
and chip_smoke.py holds the kernel to on the card.

``edge_rays(kind, accel, table, n, seed)`` returns (org, dirs), (n, 3)
float32 numpy, of one kind:
- "random": origins in the room, directions uniform;
- "coherent": a camera-like bundle;
- "surface", "on_surface": origins 0.999 of the way to (or on) the
  surfaces the bundle hits first, directions uniform (t near eps on
  "on_surface");
- "grazing": through a point of a live triangle, along its plane tilted
  off it by |cos| 0, 1e-7, 1e-6, ..., 1e-2, from 0.5 to 30 before it;
- "axis_parallel": one zero direction component (+0 or -0), two on every
  other ray, a quarter of the origins at chunk box centres;
- "box_faces": origins on a chunk box's face, directions along the face
  (0), grazing it (1e-6) or uniform;
- "inside_box": origins inside chunk boxes;
- "nan_inf": NaN, inf and -inf in a quarter of the rays' origins or
  directions, among finite rays;
- "one_lane_misses": every ray hits near the first local chunk's box but
  ray 37, which starts outside the room and points away.
``table`` is the mesh's brute table (mesh_pallas.build_tri_table), on the
device the surface kinds' first hits are found on (closest_tri).

``rotated_ball_mesh`` builds a mesh whose triangles share no normals, the
case K7's normal cones are at their weakest on."""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("random", "coherent", "surface", "on_surface", "grazing",
         "axis_parallel", "box_faces", "inside_box", "nan_inf")

ROOM_LO, ROOM_HI = (5, 5, 25), (95, 75, 145)


def _unit(d):
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def rotated_ball_mesh(n_balls: int = 12, seed: int = 0,
                      subdiv_longitude: int = 4):
    """A MeshScene of n_balls lat/long balls (core/scene.py::
    make_sphere_tri_mesh at the origin, radius 2 to 6) placed through
    core/scene.py::make_instanced_mesh_scene, each turned by its own
    random rotation and moved into the room: unlike procedural_mesh_scene's
    balls, whose copies share their normals, no two balls share one, so
    graze_cones finds a cone for about every few rows."""
    from smallpt_tpu_torch.core.scene import (
        make_instanced_mesh_scene, make_sphere_tri_mesh,
    )

    r = np.random.default_rng(seed)
    instances = []
    for _ in range(n_balls):
        q, rr = np.linalg.qr(r.normal(size=(3, 3)))
        q = q * np.sign(np.diag(rr))[None, :]
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        t34 = np.concatenate([q, r.uniform(ROOM_LO, ROOM_HI)[:, None]],
                             axis=1)
        p, nn, t = make_sphere_tri_mesh((0.0, 0.0, 0.0),
                                        float(r.uniform(2.0, 6.0)),
                                        subdiv_longitude)
        instances.append((p, nn, t, t34, ((0, 0, 0), tuple(
            r.uniform(0.2, 0.9, 3)), 0)))
    return make_instanced_mesh_scene(instances)


def local_boxes(accel):
    """(lo, hi) float64 (C, 3) numpy of the accel's local chunk boxes,
    [c - h, c + h]."""
    b = accel.boxes[accel.n_glob_chunks:, :7].double().cpu().numpy()
    return b[:, 0:3] - b[:, 4:7], b[:, 0:3] + b[:, 4:7]


def _first_hits(o, d, table):
    """Where each (n, 3) f32 ray first hits the brute table (o + t d, f32)
    and whether it hits."""
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    dev = table.device
    t = mp.closest_tri(torch.from_numpy(o.T.copy()).to(dev),
                       torch.from_numpy(d.T.copy()).to(dev), table)[0]
    t = t.cpu().numpy()
    hit = t < 3.0e38
    return (o + d * np.where(hit, t, 0.0)[:, None]).astype(np.float32), hit


def edge_rays(kind: str, accel, table, n: int, seed: int):
    """(org, dirs) (n, 3) f32 numpy rays of one kind (the module's
    docstring) on the accel of the mesh whose brute table is ``table``."""
    r = np.random.default_rng(seed)
    lo, hi = local_boxes(accel)
    pick = r.integers(0, lo.shape[0], n)
    idx = np.arange(n)
    if kind == "random":
        o = r.uniform(ROOM_LO, ROOM_HI, (n, 3))
        d = _unit(r.normal(size=(n, 3)))
    elif kind in ("coherent", "surface", "on_surface"):
        o = np.asarray([50.0, 52.0, 155.0]) + r.uniform(-0.5, 0.5, (n, 3))
        d = _unit(np.asarray([0.0, -0.04, -1.0])
                  + r.uniform(-0.08, 0.08, (n, 3)))
    elif kind == "grazing":
        rows = table.cpu().numpy()
        live = np.nonzero((rows[:, 12] > 0.5)
                          & (np.abs(rows[:, 9:12]).sum(axis=1) > 0))[0]
        row = rows[r.choice(live, n)].astype(np.float64)
        a, b = r.uniform(0, 1, n), r.uniform(0, 1, n)
        out = a + b > 1
        a[out], b[out] = 1 - a[out], 1 - b[out]
        p = row[:, 0:3] + a[:, None] * row[:, 3:6] + b[:, None] * row[:, 6:9]
        nh = _unit(row[:, 9:12])
        tan = r.normal(size=(n, 3))
        tan = _unit(tan - (tan * nh).sum(axis=1, keepdims=True) * nh)
        cos = np.asarray([0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2,
                          0.0])[idx % 8]
        d = _unit(tan + (cos * np.sign(r.normal(size=n)))[:, None] * nh)
        o = p - r.uniform(0.5, 30.0, (n, 1)) * d
    elif kind == "axis_parallel":
        o = r.uniform(ROOM_LO, ROOM_HI, (n, 3))
        o[::4] = ((lo + hi) / 2)[pick[::4]]
        d = r.normal(size=(n, 3))
        zero = r.integers(0, 3, n)
        d[idx, zero] = np.where(idx % 3, 0.0, -0.0)
        odd = idx[1::2]
        d[odd, (zero[odd] + 1) % 3] = -0.0
        d = _unit(d)
    elif kind == "box_faces":
        axis, side = r.integers(0, 3, n), r.integers(0, 2, n)
        o = r.uniform(lo[pick], hi[pick])
        d = _unit(r.normal(size=(n, 3)))
        d[idx, axis] = np.where(idx % 3 == 0, 0.0,
                                np.where(idx % 3 == 1, 1e-6, d[idx, axis]))
        d = _unit(d)
        face = np.where(side, hi[pick, axis], lo[pick, axis])
        o = o.astype(np.float32)
        o[idx, axis] = face  # on the face in f32 too
    elif kind == "inside_box":
        o = r.uniform(lo[pick], hi[pick])
        d = _unit(r.normal(size=(n, 3)))
    elif kind == "nan_inf":
        o = r.uniform(ROOM_LO, ROOM_HI, (n, 3))
        d = _unit(r.normal(size=(n, 3)))
        bad = np.asarray([np.nan, np.inf, -np.inf])
        k = idx[::4]
        which, axis = r.integers(0, 2, k.size), r.integers(0, 3, k.size)
        o[k[which == 0], axis[which == 0]] = bad[k[which == 0] % 3]
        d[k[which == 1], axis[which == 1]] = bad[k[which == 1] % 3]
    elif kind == "one_lane_misses":
        aim = (lo[0] + hi[0]) / 2  # inside the first local chunk's box
        o = aim + np.asarray([0.0, 0.0, 4.0]) + r.uniform(-0.05, 0.05,
                                                          (n, 3))
        d = _unit(aim - o)
        o[37], d[37] = (50.0, 40.0, 1e4), (0.0, 0.0, 1.0)
    else:
        raise ValueError(f"unknown ray kind {kind!r}")
    o, d = o.astype(np.float32), d.astype(np.float32)
    if kind in ("surface", "on_surface"):
        p, hit = _first_hits(o, d, table)
        back = np.float32(0.999 if kind == "surface" else 1.0)
        o = np.where(hit[:, None], o + (p - o) * back, o).astype(np.float32)
        d = _unit(r.normal(size=(n, 3))).astype(np.float32)
    return o, d
