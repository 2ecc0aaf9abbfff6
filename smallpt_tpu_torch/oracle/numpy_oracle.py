"""NumPy float64 oracle (the port's copy of
smallpt_tpu/oracle/numpy_oracle.py): an independent scalar transliteration
of the *intended* reference behavior.

The reference ships no tests (SURVEY.md §4); its verification style is
cross-checking independent backends (CPUIntersector vs OptixIntersector,
analytic vs mesh sphere intersection). This oracle plays that role for the
port: a direct scalar recursion implementing the dead-but-complete BSDF code
in shadePaths (smallpt.cpp:185-263), original smallpt's normal flip
(restored, see SURVEY.md Appendix A), the analytic sphere intersection
(scene.cpp:129-140), both pixel filters (smallpt.cpp:327-333, 753-755) and
both cameras (smallpt.cpp:277-279, 607-641).

It consumes the *same* per-decision uniforms as the renderer — keyed by
(sample, path-history, depth), or by (pixel, ip, depth) on the streaming
keying — drawn by the port's core/rng.py on ``device`` (the card by
default) and widened to float64, so at matching configuration the two
implementations follow identical decision trees and the images agree to
float tolerance path for path, not just in expectation. The arithmetic is
the JAX package's oracle's, operation for operation: on one machine the two
give the same bits. One change of speed is exact by construction: the
sphere loop runs over the spheres a conservative float64 screen keeps
(``Oracle._screen``), in index order, so its winner is the full loop's.
"""

from __future__ import annotations

import numpy as np
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.ops.wavefront import U_BSDF_1, U_BSDF_2, U_CHOICE, U_RR
from smallpt_tpu_torch.utils.device import resolve_device

# The sphere screen's margin, relative to the magnitudes a sphere's det and
# root are made of. The vectorised b, op.op and det differ from the scalar
# loop's (np.dot's summation order) by at most ~20 ulp of those magnitudes
# (2.2e-15); this margin is ~450 times that, so the screen can keep a sphere
# the loop rejects but never drop one the loop accepts.
_SCREEN_REL = 1e-12


def _numpy(x, dtype=np.float64) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array of dtype
    (float32 widens to float64 exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class UniformProvider:
    """Uniforms from the exact keying the renderer uses (core/rng.py),
    drawn one sample at a time on ``device`` (None or "cuda": the card;
    "cpu"). The draws are integer hashes and one exact conversion, so the
    card's equal the CPU's bit for bit."""

    def __init__(self, seed_or_key, device="cuda"):
        if isinstance(seed_or_key, int):
            self.key = prng.base_key(seed_or_key)
        else:
            self.key = seed_or_key
        self.device = resolve_device(device)

    def _i32(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    def _full(self, n: int, value: int) -> torch.Tensor:
        return torch.full((n,), value, dtype=torch.int32, device=self.device)

    def camera(self, sample_id: int) -> np.ndarray:
        u = prng.camera_uniforms(self.key, self._i32([sample_id]))
        return _numpy(u)[0]

    def shade(self, sample_id: int, hist: int, depth: int) -> np.ndarray:
        u = prng.shade_uniforms(
            self.key, self._i32([sample_id]), self._i32([hist]),
            self._i32([depth]),
        )
        return _numpy(u)[0]

    def lens(self, sample_id: int) -> np.ndarray:
        u = prng.lens_uniforms(self.key, self._i32([sample_id]))
        return _numpy(u)[0]

    def nee(self, sample_id: int, hist: int, depth: int, slot: int) -> np.ndarray:
        u = prng.nee_uniforms(
            self.key, self._i32([sample_id]), self._i32([hist]),
            self._i32([depth]), slot,
        )
        return _numpy(u)[0]


class PrecomputedUniformProvider(UniformProvider):
    """Same streams, but vectorized: camera uniforms fetched in one call and
    shade uniforms fetched lazily one (hist, depth) plane at a time — makes
    whole-image oracle renders tractable."""

    def __init__(self, seed_or_key, n_samples: int | None = None, sids=None,
                 device="cuda"):
        """Either n_samples (dense sids 0..n-1, whole-frame renders) or an
        explicit sids array (sparse pixel-subsample renders at large
        resolutions — the mid-res statistical gates)."""
        super().__init__(seed_or_key, device)
        if sids is None:
            sids = np.arange(n_samples, dtype=np.int32)
            self._idx = None
        else:
            sids = np.asarray(sids, np.int32)
            self._idx = {int(s): i for i, s in enumerate(sids)}
        self.n = sids.shape[0]
        self._sids = self._i32(sids)
        self._cam = _numpy(prng.camera_uniforms(self.key, self._sids))
        self._shade = {}

    def _slot(self, sample_id: int) -> int:
        return sample_id if self._idx is None else self._idx[int(sample_id)]

    def camera(self, sample_id: int) -> np.ndarray:
        return self._cam[self._slot(sample_id)]

    def shade(self, sample_id: int, hist: int, depth: int) -> np.ndarray:
        plane = self._shade.get((hist, depth))
        if plane is None:
            plane = _numpy(prng.shade_uniforms(
                self.key, self._sids, self._full(self.n, hist),
                self._full(self.n, depth),
            ))
            self._shade[(hist, depth)] = plane
        return plane[self._slot(sample_id)]

    def lens(self, sample_id: int) -> np.ndarray:
        plane = self._shade.get("lens")
        if plane is None:
            plane = _numpy(prng.lens_uniforms(self.key, self._sids))
            self._shade["lens"] = plane
        return plane[self._slot(sample_id)]

    def nee(self, sample_id: int, hist: int, depth: int, slot: int) -> np.ndarray:
        plane = self._shade.get(("nee", hist, depth, slot))
        if plane is None:
            plane = _numpy(prng.nee_uniforms(
                self.key, self._sids, self._full(self.n, hist),
                self._full(self.n, depth), slot,
            ))
            self._shade[("nee", hist, depth, slot)] = plane
        return plane[self._slot(sample_id)]


class StreamUniformProvider(PrecomputedUniformProvider):
    """Uniforms from the STREAMING sample keying (core/rng.py v2: PCG4D
    words (pixel, ip) instead of the packed global sid) — the streams the
    continuous-wavefront and grid-binned schedulers draw in-kernel
    (ops/megakernel.py). With this provider the oracle replays a streaming/
    binned render's exact decision tree.

    sid convention is unchanged (sid = pixel * spp + ip; the per-pass drain
    gives each pixel ip in [0, spp)), so Oracle.render_pixels works as-is.
    Valid for the schedulers' actual envelope: single stream, inflight=1
    (ip_offset 0), split_budget == 1 (hist stays 0 — streaming never
    splits)."""

    def __init__(self, seed_or_key, config: RenderConfig, sids,
                 device="cuda"):
        UniformProvider.__init__(self, seed_or_key, device)
        sids = np.asarray(sids, np.int64)
        self._idx = {int(s): i for i, s in enumerate(sids)}
        self.n = sids.shape[0]
        spp = config.spp
        self._pix = self._i32(sids // spp)
        self._ip = self._i32(sids % spp)
        self._sids = self._i32(sids)
        self._cam = _numpy(prng.stream_camera_uniforms(self.key, self._pix,
                                                     self._ip))
        self._shade = {}

    def shade(self, sample_id: int, hist: int, depth: int) -> np.ndarray:
        if hist != 0:
            raise NotImplementedError(
                "streaming keying has no split-history word "
                "(split_budget == 1)"
            )
        plane = self._shade.get(depth)
        if plane is None:
            plane = _numpy(prng.stream_shade_uniforms(
                self.key, self._pix, self._ip, self._full(self.n, depth),
            ))
            self._shade[depth] = plane
        return plane[self._slot(sample_id)]

    def lens(self, sample_id: int) -> np.ndarray:
        plane = self._shade.get("lens")
        if plane is None:
            plane = _numpy(prng.stream_lens_uniforms(self.key, self._pix,
                                                   self._ip))
            self._shade["lens"] = plane
        return plane[self._slot(sample_id)]

    def nee(self, sample_id: int, hist: int, depth: int, slot: int) -> np.ndarray:
        if hist != 0:
            raise NotImplementedError(
                "streaming keying has no split-history word"
            )
        plane = self._shade.get(("nee", depth, slot))
        if plane is None:
            plane = _numpy(prng.stream_nee_uniforms(
                self.key, self._pix, self._ip, self._full(self.n, depth),
                slot,
            ))
            self._shade[("nee", depth, slot)] = plane
        return plane[self._slot(sample_id)]


def _norm(v):
    return v / np.linalg.norm(v)


class Oracle:
    def __init__(self, scene, camera, config: RenderConfig, uniforms):
        """scene/camera: the port's SphereScene or MeshScene and
        LegacyCamera or MatrixCamera (tensors on any device, converted to
        numpy float64 here). uniforms: provider with camera()/shade()."""
        self.config = config
        self.u = uniforms
        self.is_mesh = hasattr(scene, "indices")
        if self.is_mesh:
            # mesh transport mirror (the CPUIntersector/convertHits slot for
            # triangle scenes, smallpt.cpp:598-603 + scene.cpp:73-93): the
            # SAME iq-form algebra as the triangle kernels, evaluated in f64
            pos = _numpy(scene.positions)
            idx = _numpy(scene.indices, np.int64)
            self.positions = pos
            self.vnormals = _numpy(scene.normals)
            self.indices = idx
            self.tri_inst = _numpy(scene.tri_inst, np.int64)
            self.tv0 = pos[idx[:, 0]]
            self.te1 = pos[idx[:, 1]] - self.tv0
            self.te2 = pos[idx[:, 2]] - self.tv0
            self.tn = np.cross(self.te1, self.te2)
            if config.nee_lights:
                # triangle AREA lights: per-light instance triangle tables
                # with area CDFs — the f64 mirror of
                # engine/renderer.py::_mesh_nee_for
                emission = _numpy(scene.material.emission)
                self.tri_lights = []
                for li in config.nee_lights:
                    tris = np.nonzero(self.tri_inst == li)[0]
                    if tris.size == 0:
                        raise ValueError(f"nee light {li} has no triangles")
                    a = pos[idx[tris, 0]]
                    b = pos[idx[tris, 1]]
                    c = pos[idx[tris, 2]]
                    cross = np.cross(b - a, c - a)
                    area2 = np.linalg.norm(cross, axis=1)
                    n = cross / area2[:, None]
                    areas = 0.5 * area2
                    total = float(areas.sum())
                    cdf = np.cumsum(areas) / total
                    cdf[-1] = 1.0
                    self.tri_lights.append(
                        (a, b, c, n, cdf, total, emission[li], int(li))
                    )
        else:
            self.center = _numpy(scene.center)
            self.radius = _numpy(scene.radius)
            # the screen's per-sphere terms (Oracle._screen)
            self._r2 = self.radius * self.radius
            self._eps = np.maximum(config.intersect_eps,
                                   config.intersect_eps_rel * self.radius)
        self.emission = _numpy(scene.material.emission)
        self.albedo = _numpy(scene.material.albedo)
        self.refl = _numpy(scene.material.refl, np.int64)
        # the camera's fields as float64 arrays (camera_ray reads them)
        self.camera = type(camera)(*(_numpy(f) for f in camera))
        if config.split_budget not in (1,) and config.split_budget < 2 ** (
            config.split_depth + 1
        ):
            raise ValueError(
                "oracle supports split_budget=1 (no splitting) or a budget "
                ">= 2^(split_depth+1) (splits always succeed); intermediate "
                "budgets depend on wavefront slot occupancy"
            )
        self.splitting = config.split_budget > 1

    # -- mesh intersection: iq-form ray/triangle over ALL triangles
    # (vectorized f64), winner = lexicographic (t, tri id) — the fold the
    # culled kernel tie-breaks to and the brute ascending sweep's
    # first-min behavior
    def intersect_mesh(self, o, d):
        r = o[None, :] - self.tv0                       # (T, 3)
        q = np.cross(r, d[None, :])
        dn = self.tn @ d                                # (T,)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dn
            u = -(q * self.te2).sum(axis=1) * inv
            v = (q * self.te1).sum(axis=1) * inv
            t = -(self.tn * r[:, :]).sum(axis=1) * inv
            ok = (
                (dn != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                & (u + v <= 1.0) & (t > 0.0)
            )
        t = np.where(ok, t, np.inf)
        if not np.isfinite(t).any():
            return np.inf, -1, 0.0, 0.0
        best = int(np.argmin(t))  # argmin takes the FIRST minimum: (t, id)
        return float(t[best]), best, float(u[best]), float(v[best])

    def _screen(self, o, d) -> list:
        """The spheres, in index order, that ``intersect``'s loop could
        accept: a vectorised float64 test of det and the larger root, each
        widened by _SCREEN_REL of its magnitudes. It keeps every sphere the
        loop accepts (and those with a non-finite term); the loop decides.
        The loop's fold is a strict < in index order over per-sphere
        decisions, so looping over the kept spheres gives the full loop's
        (t, i) bit for bit (tests/test_torch_oracle.py)."""
        with np.errstate(over="ignore", invalid="ignore"):
            op = self.center - o
            prod = op * d
            b = prod.sum(axis=1)
            sb = np.abs(prod).sum(axis=1)          # >= |b|
            oo = (op * op).sum(axis=1)
            mag = sb * sb + oo + self._r2
            det = b * b - oo + self._r2
            slack = _SCREEN_REL * mag
            hi = (b + np.sqrt(np.maximum(det + slack, 0.0))
                  + _SCREEN_REL * (sb + np.sqrt(oo + self._r2)))
            keep = (det >= -slack) & (hi > self._eps)
            keep |= ~(np.isfinite(hi) & np.isfinite(mag))
        return np.flatnonzero(keep).tolist()

    # -- intersection (scene.cpp:129-140 + closest-hit loop smallpt.cpp:54-70)
    def intersect(self, o, d):
        best_t, best_i = np.inf, -1
        for i in self._screen(o, d):
            # per-sphere root eps, matching ops/intersect.py
            eps = max(
                self.config.intersect_eps,
                self.config.intersect_eps_rel * float(self.radius[i]),
            )
            op = self.center[i] - o
            b = float(np.dot(op, d))
            det = b * b - float(np.dot(op, op)) + float(self.radius[i] ** 2)
            if det < 0:
                continue
            sq = np.sqrt(det)
            t = b - sq
            if t <= eps:
                t = b + sq
                if t <= eps:
                    continue
            if t < best_t:
                best_t, best_i = t, i
        return best_t, best_i

    # -- primary ray (both cameras/filters)
    def camera_ray(self, sample_id, col, row, cell_x, cell_y):
        cfg = self.config
        u = self.u.camera(sample_id)
        js = cfg.jitter_size
        if cfg.filter == Filter.BOX:
            jittered = (np.array([cell_x, cell_y], np.float64) + u) / js
            off = 0.5 * (2.0 * jittered - 1.0)
        else:
            r = 2.0 * u
            dxy = np.where(r < 1.0, np.sqrt(r) - 1.0, 1.0 - np.sqrt(np.maximum(2.0 - r, 0.0)))
            off = (np.array([cell_x, cell_y], np.float64) + 0.5 + dxy) / js - 0.5
        if cfg.camera_model == CameraModel.LEGACY:
            c = self.camera
            w, h = cfg.width, cfg.height
            camd = np.asarray(c.direction, np.float64)
            fov = float(c.fov_scale)
            cx = np.array([w * fov / h, 0.0, 0.0])
            cy = _norm(np.cross(cx, camd)) * fov
            sx = (col + 0.5 + off[0]) / w - 0.5
            sy = (row + 0.5 + off[1]) / h - 0.5
            d = cx * sx + cy * sy + camd
            org = np.asarray(c.origin, np.float64) + d * float(c.push_forward)
            org, d = org, _norm(d)
            right, up = _norm(cx), _norm(cy)
        else:
            m = np.asarray(self.camera.local_to_world, np.float64)
            near = float(self.camera.near_plane)
            raster = np.array([col + 0.5 + off[0], row + 0.5 + off[1]])
            clip = 2.0 * raster / np.array([cfg.width, cfg.height]) - 1.0
            d4 = m @ np.array([clip[0], clip[1], near, 0.0])
            org, d = m[:3, 3].copy(), _norm(d4[:3])
            right, up = _norm(m[:3, 0]), _norm(m[:3, 1])
        if cfg.aperture > 0.0:
            ul = self.u.lens(sample_id)
            r = cfg.aperture * np.sqrt(ul[0])
            theta = 2.0 * np.pi * ul[1]
            focus = org + d * cfg.focal_distance
            org = org + right * (r * np.cos(theta)) + up * (r * np.sin(theta))
            d = _norm(focus - org)
        return org, d

    # -- next-event estimation: smallpt-explicit's cone sample of one light
    def _nee_direct(self, x, nl, f, sample_id, hist, depth):
        """(direct-light contribution, suppression mask for the next hit)."""
        cfg = self.config
        e = np.zeros(3)
        sup = 0
        for slot, li in enumerate(cfg.nee_lights):
            if self.is_mesh:
                # triangle AREA light — exact f64 mirror of the engine's
                # uniform-by-area sampler (ops/wavefront.py mesh branch):
                # CDF pick reusing the pick uniform's conditional
                # remainder, sqrt warp, two-sided cos_y, |t - d| visibility
                a, b, c, n_t, cdf, total, le, inst = self.tri_lights[slot]
                u = self.u.nee(sample_id, hist, depth, slot)
                j = min(int(np.searchsorted(cdf, u[0], side="right")),
                        cdf.shape[0] - 1)
                lo = cdf[j - 1] if j > 0 else 0.0
                u0r = min(max((u[0] - lo) / max(cdf[j] - lo, 1e-12), 0.0),
                          1.0)
                su = np.sqrt(u0r)
                y = (1.0 - su) * a[j] + su * (
                    (1.0 - u[1]) * b[j] + u[1] * c[j]
                )
                sw = y - x
                d2 = max(float(np.dot(sw, sw)), 1e-12)
                dist = np.sqrt(d2)
                l = sw / dist
                sup |= 1 << slot  # sampled: suppress its emission next hit
                ts, tri, _, _ = self.intersect_mesh(x, l)
                if not (
                    np.isfinite(ts)
                    and int(self.tri_inst[tri]) == inst
                    and ts >= dist * (1.0 - 1e-3)
                ):
                    continue  # shadowed
                cos_x = max(float(np.dot(l, nl)), 0.0)
                cos_y = abs(float(np.dot(l, n_t[j])))
                e = e + f * le * (cos_x * cos_y * total / d2 / np.pi)
                continue
            lc, lr = self.center[li], float(self.radius[li])
            sw = lc - x
            d2 = float(np.dot(sw, sw))
            if d2 <= lr * lr:
                continue  # inside the light shell: plain path tracing
            cos_a_max = np.sqrt(max(1.0 - lr * lr / d2, 0.0))
            u = self.u.nee(sample_id, hist, depth, slot)
            cos_a = 1.0 - u[0] + u[0] * cos_a_max
            sin_a = np.sqrt(max(1.0 - cos_a * cos_a, 0.0))
            phi = 2.0 * np.pi * u[1]
            swn = sw / np.sqrt(d2)
            up = (np.array([0.0, 1.0, 0.0]) if abs(swn[0]) > 0.1
                  else np.array([1.0, 0.0, 0.0]))
            su = _norm(np.cross(up, swn))
            sv = np.cross(swn, su)
            l = _norm(su * np.cos(phi) * sin_a + sv * np.sin(phi) * sin_a
                      + swn * cos_a)
            sup |= 1 << slot  # sampled: suppress its emission next hit
            ts, idx = self.intersect(x, l)
            if idx != li:
                continue  # shadowed
            omega = 2.0 * np.pi * (1.0 - cos_a_max)
            cosine = max(float(np.dot(l, nl)), 0.0)
            e = e + f * self.emission[li] * (cosine * omega / np.pi)
        return e, sup

    # -- recursive radiance following the wavefront's decision tree
    def _env_contrib(self, weight):
        """Escaped-ray environment pickup — the hook the reference leaves
        unimplemented at smallpt.cpp:168 (``// Here we could accumulate
        path.weight * envContrib``). FULL transport only: the AOV debug
        modes skip misses exactly like the reference's `continue`."""
        cfg = self.config
        if cfg.mode == Mode.FULL and cfg.has_env:
            return weight * np.asarray(cfg.env_emission, np.float64)
        return np.zeros(3)

    def radiance(self, o, d, depth, hist, weight, sample_id, suppress=0):
        cfg = self.config
        if depth >= cfg.max_depth:
            # wavefront lanes die unprocessed once the bounce cap is reached
            return np.zeros(3)
        if self.is_mesh:
            t, tri, bu, bv = self.intersect_mesh(o, d)
            if not np.isfinite(t):
                return self._env_contrib(weight)
            iv = self.indices[tri]
            bw = 1.0 - bu - bv
            # barycentric hit construction EXACTLY as complete_mesh_hit
            # (scene.cpp:73-93 convention): position interpolated from
            # vertices, normal interpolated UNNORMALIZED from vertex normals
            x = (bw * self.positions[iv[0]] + bu * self.positions[iv[1]]
                 + bv * self.positions[iv[2]])
            n = (bw * self.vnormals[iv[0]] + bu * self.vnormals[iv[1]]
                 + bv * self.vnormals[iv[2]])
            i = int(self.tri_inst[tri])
        else:
            t, i = self.intersect(o, d)
            if not np.isfinite(t):
                return self._env_contrib(weight)
            x = o + t * d
            n = _norm(x - self.center[i])
        nl = n if (np.dot(n, d) < 0 or not cfg.flip_normals) else -n

        if cfg.mode == Mode.NORMAL:
            return nl.copy()
        if cfg.mode == Mode.UV:
            if self.is_mesh:
                return np.array([bu, bv, 0.0])
            # spherical parameterization of the UNFLIPPED normal, matching
            # ops/intersect.py::sphere_uv (the makeSphereTriMesh lat/long
            # grid, scene.cpp:3-48)
            phi = float(np.arctan2(n[0], n[2])) % (2.0 * np.pi)
            v = float(np.arcsin(np.clip(n[1], -1.0, 1.0))) / np.pi + 0.5
            return np.array([phi / (2.0 * np.pi), v, 0.0])
        if cfg.mode == Mode.EMISSION:
            # first-hit emission AOV (the commented smallpt.cpp:179 line)
            return weight * self.emission[i]
        if cfg.mode == Mode.INST_ID:
            # _int2color false-coloring (smallpt.cpp:24-29). fract(sin(x)*
            # 43758.5453) amplifies a 1-ulp sin difference ~4e4-fold, so
            # cross-compiler/precision parity is meaningless — mirror the
            # formula but don't gate engine colors against it bitwise.
            tri_or_inst = tri if self.is_mesh else i
            x = np.sin((float(tri_or_inst) + 1.0)
                       * np.array([12.9898, 78.233, 56.128])) * 43758.5453
            return x - np.trunc(x)

        emission = self.emission[i]
        if cfg.nee_lights and i in cfg.nee_lights:
            slot = cfg.nee_lights.index(i)
            if (suppress >> slot) & 1:
                emission = np.zeros(3)
        out = weight * emission
        u = self.u.shade(sample_id, hist, depth)
        f = self.albedo[i].copy()
        p = float(np.max(f))
        if depth > cfg.rr_depth:
            if u[U_RR] < p:
                f = f / p
            else:
                return out
        # continuation-origin offsets matching ops/wavefront.py: +nl on the
        # reflected side, -nl for transmitted rays
        x_refl = x + cfg.shading_eps * nl
        x_trans = x - cfg.shading_eps * nl

        refl = int(self.refl[i])
        if refl == 0:  # DIFF (smallpt.cpp:208-216)
            nee_e = np.zeros(3)
            sup = 0
            if cfg.nee_lights:
                nee_e, sup = self._nee_direct(x_refl, nl, f, sample_id, hist, depth)
            r1 = 2 * np.pi * u[U_BSDF_1]
            r2 = u[U_BSDF_2]
            r2s = np.sqrt(r2)
            w = nl
            up = np.array([0.0, 1.0, 0.0]) if abs(w[0]) > 0.1 else np.array([1.0, 0.0, 0.0])
            uu = _norm(np.cross(up, w))
            vv = np.cross(w, uu)
            nd = _norm(uu * np.cos(r1) * r2s + vv * np.sin(r1) * r2s + w * np.sqrt(max(1 - r2, 0.0)))
            return (out + weight * nee_e
                    + self.radiance(x_refl, nd, depth + 1, hist, weight * f,
                                    sample_id, suppress=sup))

        refl_dir = d - n * 2.0 * np.dot(n, d)
        if refl == 1:  # SPEC (smallpt.cpp:218-223)
            return out + self.radiance(x_refl, refl_dir, depth + 1, hist, weight * f, sample_id)

        # REFR (smallpt.cpp:225-263)
        into = np.dot(n, nl) > 0
        nc, nt = 1.0, cfg.ior
        nnt = nc / nt if into else nt / nc
        ddn = np.dot(d, nl)
        cos2t = 1 - nnt * nnt * (1 - ddn * ddn)
        if cos2t < 0:  # total internal reflection
            return out + self.radiance(x_refl, refl_dir, depth + 1, hist, weight * f, sample_id)
        tdir = _norm(d * nnt - n * ((1 if into else -1) * (ddn * nnt + np.sqrt(cos2t))))
        a, b = nt - nc, nt + nc
        r0 = a * a / (b * b)
        c = 1 - (-ddn if into else np.dot(tdir, n))
        re = r0 + (1 - r0) * c**5
        tr = 1 - re
        if self.splitting and depth <= cfg.split_depth:
            # split (smallpt.cpp:248-254); children keyed 2h+1 / 2h+2
            return (
                out
                + self.radiance(x_refl, refl_dir, depth + 1, 2 * hist + 1, weight * f * re, sample_id)
                + self.radiance(x_trans, tdir, depth + 1, 2 * hist + 2, weight * f * tr, sample_id)
            )
        pp = 0.25 + 0.5 * re
        if u[U_CHOICE] < pp:
            return out + self.radiance(x_refl, refl_dir, depth + 1, hist, weight * f * re / pp, sample_id)
        return out + self.radiance(x_trans, tdir, depth + 1, hist, weight * f * tr / (1 - pp), sample_id)

    def render_pixels(self, pixels) -> np.ndarray:
        """Summed radiance (P, 3) for an arbitrary pixel-id subset — the
        sparse analog of render() for mid-res statistical gates where a
        full-frame oracle render is intractable. Use
        PrecomputedUniformProvider(key, sids=<the subset's sids>)."""
        cfg = self.config
        spp = cfg.spp
        out = np.zeros((len(pixels), 3))
        for k, pixel in enumerate(pixels):
            row, col = divmod(int(pixel), cfg.width)
            for ip in range(spp):
                group = ip // cfg.spp_per_cell
                cell_x = group % cfg.jitter_size
                cell_y = group // cfg.jitter_size
                sid = int(pixel) * spp + ip
                o, d = self.camera_ray(sid, col, row, cell_x, cell_y)
                out[k] += self.radiance(o, d, 0, 0, np.ones(3), sid)
        return out

    def render(self) -> np.ndarray:
        """Full-frame pass: (H,W,3) summed radiance over config.spp samples
        per pixel — same contract as engine.renderer.render."""
        cfg = self.config
        img = np.zeros((cfg.height, cfg.width, 3))
        spp = cfg.spp
        for row in range(cfg.height):
            for col in range(cfg.width):
                pixel = row * cfg.width + col
                for ip in range(spp):
                    group = ip // cfg.spp_per_cell
                    cell_x = group % cfg.jitter_size
                    cell_y = group // cfg.jitter_size
                    sid = pixel * spp + ip
                    o, d = self.camera_ray(sid, col, row, cell_x, cell_y)
                    img[row, col] += self.radiance(o, d, 0, 0, np.ones(3), sid)
        return img
