"""Cameras and primary-ray generation (PyTorch port of
smallpt_tpu/core/camera.py).

- ``LegacyCamera``: smallpt's frame camera — position (50,52,295.6), direction
  normalize(0,-0.042612,-1), cx = (w*0.5135/h,0,0), cy = normalize(cx x d) *
  0.5135, with ray origins pushed 140 units forward (smallpt.cpp:277-279,333).
- ``MatrixCamera``: the current engine's 4x4 localToWorld camera
  (smallpt.cpp:607-624) whose ray direction is M * (clipX, clipY, near, 0)
  (smallpt.cpp:626-641).

Camera fields are float32 tensors on the CPU. ``generate_rays`` works on a
flat sample batch on any device; the megakernel instead reads the camera
packed into one (16,) vector (ops/megakernel.py::build_camera_vec).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core.math import fdiv


class LegacyCamera(NamedTuple):
    origin: torch.Tensor  # (3,)
    direction: torch.Tensor  # (3,) normalized
    fov_scale: torch.Tensor  # scalar, smallpt's 0.5135
    push_forward: torch.Tensor  # scalar, smallpt's 140


class MatrixCamera(NamedTuple):
    local_to_world: torch.Tensor  # (4, 4)
    near_plane: torch.Tensor  # scalar


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x)).to(torch.float32)


def camera_from_arrays(origin=None, direction=None, fov_scale=None,
                       push_forward=None, local_to_world=None,
                       near_plane=None):
    """Build the port's camera from array-likes, e.g. the fields of a JAX
    package camera passed through ``np.asarray``: a MatrixCamera when
    ``local_to_world`` is given, else a LegacyCamera."""
    if local_to_world is not None:
        return MatrixCamera(_f32(local_to_world).reshape(4, 4),
                            _f32(near_plane).reshape(()))
    return LegacyCamera(
        origin=_f32(origin).reshape(3),
        direction=_f32(direction).reshape(3),
        fov_scale=_f32(fov_scale).reshape(()),
        push_forward=_f32(push_forward).reshape(()),
    )


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v * (1 / |v|) over the last axis, as the megakernel normalizes (its
    camera, csrc/lane.cuh): so the flat sample set's rays, which the
    replay differentiator traces, are the rays the recording kernel
    traced."""
    return v * (1.0 / _norm(v))[..., None]


def smallpt_camera(dtype=torch.float32) -> LegacyCamera:
    """The hardcoded cpuRender camera (smallpt.cpp:277)."""
    d = torch.tensor([0.0, -0.042612, -1.0], dtype=dtype)
    d = d / _norm(d)
    return LegacyCamera(
        origin=torch.tensor([50.0, 52.0, 295.6], dtype=dtype),
        direction=d,
        fov_scale=torch.tensor(0.5135, dtype=dtype),
        push_forward=torch.tensor(140.0, dtype=dtype),
    )


def matrix_camera_from_frame(vx, vy, vz, org, near_plane=1.0,
                             dtype=torch.float32) -> MatrixCamera:
    """Build a MatrixCamera from an orthonormal frame + origin, matching the
    Camera ctor's column layout (smallpt.cpp:609-617)."""
    m = torch.zeros((4, 4), dtype=dtype)
    m[:3, 0] = torch.as_tensor(np.asarray(vx, np.float64)).to(dtype)
    m[:3, 1] = torch.as_tensor(np.asarray(vy, np.float64)).to(dtype)
    m[:3, 2] = torch.as_tensor(np.asarray(vz, np.float64)).to(dtype)
    m[:3, 3] = torch.as_tensor(np.asarray(org, np.float64)).to(dtype)
    m[3, 3] = 1.0
    return MatrixCamera(local_to_world=m,
                        near_plane=torch.tensor(near_plane, dtype=dtype))


def default_matrix_camera(dtype=torch.float32) -> MatrixCamera:
    """The interactive app's camera: vx=(1,0,0), vz=(0,0,-1),
    vy = normalize(vx x vz), org=(0,-1,0), near=1 (smallpt.cpp:885-899)."""
    vx = np.array([1.0, 0.0, 0.0])
    vz = np.array([0.0, 0.0, -1.0])
    vy = np.cross(vx, vz)
    vy = vy / np.linalg.norm(vy)
    return matrix_camera_from_frame(vx, vy, vz, (0.0, -1.0, 0.0), 1.0, dtype)


def sample_indices(config: RenderConfig, n_pixels: int, device=None):
    """Decompose flat sample ids into (sample_id, pixel, col, row, cell_x,
    cell_y).

    Sample layout matches indexInImage = pixelIdx * sppPerPixel +
    (groupIdx * sppPerCell + s) with groupIdx = sy*jitter+sx
    (smallpt.cpp:715-719)."""
    spp = config.spp
    sample_id = torch.arange(n_pixels * spp, dtype=torch.int32, device=device)
    pixel = sample_id // spp
    in_pixel = sample_id % spp
    group = in_pixel // config.spp_per_cell
    cell_x = group % config.jitter_size
    cell_y = group // config.jitter_size
    col = pixel % config.width
    row = pixel // config.width
    return sample_id, pixel, col, row, cell_x, cell_y


def filter_offsets(u: torch.Tensor, config: RenderConfig, cell_x, cell_y):
    """Map per-sample uniforms u (N,2) to sub-pixel offsets in pixel space,
    centered on 0.

    BOX (smallpt.cpp:745-758): jitter the uniform into the sample's cell,
    then 0.5*(2r-1) over the whole pixel. TENT (smallpt.cpp:327-333):
    smallpt's tent filter per cell, relative to the pixel center."""
    js = config.jitter_size
    cell = torch.stack([cell_x, cell_y], -1).to(u.dtype)
    if config.filter == Filter.BOX:
        jittered = fdiv(cell + u, js)
        return 0.5 * (2.0 * jittered - 1.0)
    if config.filter == Filter.TENT:
        r = 2.0 * u
        d = torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                        1.0 - torch.sqrt(torch.clamp(2.0 - r, min=0.0)))
        return fdiv(cell + 0.5 + d, js) - 0.5
    raise ValueError(config.filter)


def _thin_lens(org, dirs, right, up, config: RenderConfig, u_lens):
    """Thin-lens depth of field: jitter the origin on the aperture disk and
    re-aim at the along-ray focus point (pinhole when aperture == 0)."""
    r = config.aperture * torch.sqrt(u_lens[:, 0])
    theta = 2.0 * np.pi * u_lens[:, 1]
    lx = (r * torch.cos(theta))[:, None]
    ly = (r * torch.sin(theta))[:, None]
    focus = org + dirs * config.focal_distance
    org2 = org + right[None, :] * lx + up[None, :] * ly
    return org2, _unit(focus - org2)


def generate_rays(camera, u: torch.Tensor, config: RenderConfig, col, row,
                  cell_x, cell_y, u_lens=None):
    """Primary rays for a flat sample batch.

    u: (N,2) uniforms; u_lens: (N,2) aperture uniforms (required when
    config.aperture > 0). Returns (origins (N,3), dirs (N,3) normalized)."""
    dev, dt = u.device, u.dtype
    offset = filter_offsets(u, config, cell_x, cell_y)
    if config.camera_model == CameraModel.LEGACY:
        if not isinstance(camera, LegacyCamera):
            raise TypeError("LEGACY camera_model needs a LegacyCamera")
        w, h = config.width, config.height
        sx = fdiv(col.to(dt) + 0.5 + offset[:, 0], w) - 0.5
        sy = fdiv(row.to(dt) + 0.5 + offset[:, 1], h) - 0.5
        cx, cy = _legacy_frame(camera, config, dt)
        cx, cy = cx.to(dev), cy.to(dev)
        cd = camera.direction.to(dev, dt)
        d = sx[:, None] * cx[None, :] + sy[:, None] * cy[None, :] + cd[None, :]
        org = (camera.origin.to(dev, dt)[None, :]
               + d * camera.push_forward.to(dev, dt))
        dirs = _unit(d)
        if config.aperture > 0.0:
            return _thin_lens(org, dirs, _unit(cx), _unit(cy), config,
                              u_lens)
        return org, dirs
    if config.camera_model == CameraModel.MATRIX:
        if not isinstance(camera, MatrixCamera):
            raise TypeError("MATRIX camera_model needs a MatrixCamera")
        m = camera.local_to_world.to(dev, dt)
        raster = torch.stack([col.to(dt) + 0.5 + offset[:, 0],
                              row.to(dt) + 0.5 + offset[:, 1]], -1)
        pixel_size = torch.tensor([1.0 / config.width, 1.0 / config.height],
                                  dtype=dt, device=dev)
        clip = 2.0 * raster * pixel_size[None, :] - 1.0
        n = clip.shape[0]
        local = torch.cat([
            clip,
            camera.near_plane.to(dev, dt).expand(n, 1),
            torch.zeros((n, 1), dtype=dt, device=dev),
        ], dim=-1)
        d = (local @ m.T)[:, :3]
        dirs = _unit(d)
        org = m[:3, 3][None, :].expand(n, 3)
        if config.aperture > 0.0:
            return _thin_lens(org, dirs, _unit(m[:3, 0]), _unit(m[:3, 1]),
                              config, u_lens)
        return org, dirs
    raise ValueError(config.camera_model)


def _legacy_frame(camera: LegacyCamera, config: RenderConfig,
                  dtype=torch.float32):
    """smallpt's cx = (w*fov/h, 0, 0) and cy = normalize(cx x d) * fov
    (smallpt.cpp:278-279), in ``dtype`` (the path's)."""
    fov = camera.fov_scale.to(dtype)
    zero = torch.zeros((), dtype=dtype)
    cx = torch.stack([config.width * fov / config.height, zero, zero])
    cy_raw = torch.linalg.cross(cx, camera.direction.to(dtype))
    return cx, cy_raw / _norm(cy_raw) * fov
