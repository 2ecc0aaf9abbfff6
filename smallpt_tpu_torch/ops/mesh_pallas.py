"""The closest-hit triangle kernel K6 and its host side (port of
smallpt_tpu/ops/mesh_pallas.py, whose Pallas body ``_mesh_kernel``
becomes the CUDA kernel csrc/closest_tri.cu; the module keeps its name so a
reader finds the counterpart).

The mesh is packed on the host into a (T_pad, 16) f32 table of rows
[v0(3) e1(3) e2(3) n(3) valid 0 0 0], n = cross(e1, e2), padded with zero
rows (valid 0) to a multiple of 32 (``build_tri_table``). Per ray the kernel
finds the first row of least t in iq's formulation (triIntersect,
scene.cpp:52-70):

    q = cross(rov0, d);  inv = 1 / dot(d, n)
    u = -dot(q, e2) * inv;  v = dot(q, e1) * inv;  t = -dot(n, rov0) * inv
    inside iff 0 <= u, 0 <= v, u + v <= 1

and returns (t, tri, u, v); the hit's position and normal are completed
from them (ops/intersect.py::complete_mesh_hit).

``closest_tri`` launches K6 on a CUDA tensor (and counts the launch in
``closest_tri.launches``) or raises; on a CPU tensor it runs
``closest_tri_plain``, the same function in the kernel's op order.
``intersect_mesh_pallas`` is the drop-in for ops/intersect.py's
``intersect_mesh``. Not in this module yet: K7, the grid-culled sweep
(``intersect_mesh_culled``, ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smallpt_tpu_torch.core.scene import MeshScene
from smallpt_tpu_torch.ops.intersect import Hit, complete_mesh_hit
from smallpt_tpu_torch.ops.intersect_pallas import (
    _check_rays, _chunk_rows, fold_rows,
)
from smallpt_tpu_torch.ops.megakernel import _BIG

# The table pads to whole chunks of this many rows, as the JAX table does.
_T_CHUNK = 32

# (library name, csrc/ source) of the kernel of this module
LIBRARY = ("smallpt_closest_tri", "closest_tri.cu")


def build_tri_table(scene: MeshScene, device=None) -> torch.Tensor:
    """(T_pad, 16) f32 rows [v0 e1 e2 n=cross(e1,e2) valid 0 0 0] on
    ``device`` (None: the CPU), built on the host in float32. The cross
    product is torch's on the CPU, whose roundings are the JAX package's
    on XLA:CPU (both contract a*b - c*d into a fused multiply-add), so the
    table equals the JAX package's value for value."""
    pos = scene.positions.detach().cpu().to(torch.float32)
    idx = scene.indices.detach().cpu().long()
    v0, v1, v2 = (pos.index_select(0, idx[:, k]) for k in range(3))
    e1 = v1 - v0
    e2 = v2 - v0
    t = scene.n_triangles
    rows = torch.zeros((t + (-t) % _T_CHUNK, 16), dtype=torch.float32)
    rows[:t, 0:3] = v0
    rows[:t, 3:6] = e1
    rows[:t, 6:9] = e2
    rows[:t, 9:12] = torch.linalg.cross(e1, e2)
    rows[:t, 12] = 1.0
    return rows.to(device or "cpu")


def _kernel_lib():
    """The entry point of the K6 library (built at first use)."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    fn = load_library(*LIBRARY).smallpt_closest_tri
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10
        fn.restype = ctypes.c_int
    return fn


def closest_tri(org: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
                n_rows: int | None = None, eps: float = 0.0):
    """Closest triangle of every ray over the first n_rows rows of the table
    (None: all of them), rejecting t <= eps.

    org, dirs: (3, N) f32 ray planes; table: (rows, 16) f32
    (``build_tri_table``). Returns (t, tri, u, v), each (N,): the least t
    (3e38 where nothing is hit), the first row attaining it (int32, 0 on a
    miss), and that row's barycentric u and v (0 on a miss), exactly as the
    JAX kernel returns them.

    A CUDA tensor launches csrc/closest_tri.cu (and counts the launch in
    ``closest_tri.launches``); a CPU tensor runs ``closest_tri_plain``."""
    n = _check_rays(org, dirs, table, 16)
    n_rows = table.shape[0] if n_rows is None else n_rows
    if not 0 <= n_rows <= table.shape[0]:
        raise ValueError(f"n_rows={n_rows} for a {table.shape[0]}-row table")
    if table.device.type == "cpu":
        return closest_tri_plain(org, dirs, table, n_rows, eps)
    fn = _kernel_lib()
    dev = table.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    ints = np.array([n, n_rows], np.int32)
    floats = np.array([eps], np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), table.data_ptr(),
                 t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"closest_tri launch failed: CUDA error {err}")
    closest_tri.launches += 1
    return t, tri, u, v


closest_tri.launches = 0


def _tri_tuv(ox, oy, oz, dx, dy, dz, row, eps):
    """Candidate (t, u, v) of the triangle rows ``row`` (C, 16) for every
    ray (lanes (N, 1), rows broadcast (1, C)): the JAX kernel's arithmetic,
    op for op, with t = _BIG where the ray misses (outside the barycentric
    bounds, a padding row, a parallel ray, or t <= eps)."""
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny,
     nz, valid) = (row[:, k][None, :] for k in range(13))
    rx = ox - v0x
    ry = oy - v0y
    rz = oz - v0z
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dn = dx * nx + dy * ny + dz * nz
    inv = torch.ones_like(dn) / torch.where(dn == 0.0, torch.ones_like(dn),
                                            dn)
    u = -(qx * e2x + qy * e2y + qz * e2z) * inv
    v = (qx * e1x + qy * e1y + qz * e1z) * inv
    t = -(nx * rx + ny * ry + nz * rz) * inv
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & ((u + v) <= 1.0)
    hit = inside & (valid > 0.5) & (dn != 0.0) & (t > eps)
    return torch.where(hit, t, _BIG), u, v


def closest_tri_plain(org: torch.Tensor, dirs: torch.Tensor,
                      table: torch.Tensor, n_rows: int | None = None,
                      eps: float = 0.0):
    """The plain PyTorch version of K6: the same function in the kernel's
    op order (each sum written out left to right, the reciprocal a tensor
    division), swept over the rows in chunks so (rays x rows) never
    materialises whole. Rows with valid 0 (the padding) are skipped, as the
    kernel skips them: they never win. Returns (t, tri, u, v) as
    ``closest_tri``."""
    n = org.shape[1]
    n_rows = table.shape[0] if n_rows is None else n_rows
    lane = [x[:, None] for x in (*org, *dirs)]
    live = torch.nonzero(table[:n_rows, 12] > 0.5)[:, 0]
    rows = table.index_select(0, live)
    zero = torch.zeros((n,), dtype=torch.float32, device=org.device)
    bt, bi, bu, bv = fold_rows(
        n, org.device, live.shape[0], _chunk_rows(n),
        lambda lo, hi: _tri_tuv(*lane, rows[lo:hi], eps), init=(zero, zero))
    if live.numel():
        bi = torch.where(bt < _BIG, live.to(torch.int32)[bi.long()], 0)
    return bt, bi, bu, bv


def intersect_mesh_pallas(org, dirs, scene: MeshScene, eps: float = 0.0,
                          table=None) -> Hit:
    """Closest triangle hit through K6 — the drop-in for
    ops/intersect.py::intersect_mesh (rejects t <= eps like the reference's
    t <= 0 check, scene.cpp:105). org, dirs: (N, 3) on the device of the
    scene's tensors. table: the ``build_tri_table`` result on that device,
    built once by the caller (None: built here)."""
    if table is None:
        table = build_tri_table(scene, device=org.device)
    t, tri, u, v = closest_tri(org.T.contiguous(), dirs.T.contiguous(),
                               table, eps=float(eps))
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    return complete_mesh_hit(scene, t, tri, u.to(org.dtype),
                             v.to(org.dtype))
