"""K1a's and K1c's redesign (csrc/megakernel.cu), emulated in plain PyTorch
and held bit for bit to the plain version it must equal,
ops/megakernel.py, on the CPU at toy sizes.

- K1's own sphere test (k1_tt): the stable form to det; a miss decided
  there (det < 0 or NaN, or r not > 0) returns 3e38 before the second and
  third square roots and the division; where q = b*b + pp < r*r (both as
  the test rounds them) and eps >= 0 the inside path returns denom > eps ?
  denom : 3e38, skipping opn's square root, cc and the division; every
  other pair takes the whole test. The emulation feeds NaN to the parts of
  the test that a path skips, so a result taken past its decision would
  show. It is held, as int32, to ``mk._sphere_tt`` (the whole test) on the
  rays of the plain version's own sweeps and shadow sweeps over the
  Cornell, two-sphere and 2,048-sphere tables, and on constructed inputs:
  an origin exactly on a wall (cc == 0), q one ulp either side of the
  guard and r one ulp either side of the origin's distance, tangent rays
  (det exactly 0), r = 0, r < 0, NaN radius and origin, eps 0 and -0, r =
  1e-20 and 2e19 (r*r underflowing and overflowing), a ray from inside a
  ball; without its eps >= 0 check the inside path would part from the
  whole test under a negative eps.
- The bound's counts: ``mk._count_pairs`` (the plain version's counts of
  the kernel's tests by class) against a loop over the kernel's sweep and
  its shadow sweep's early exit.
- The lane queue's premise: a lane's planes after a launch depend on its
  own planes and the launch's arguments alone, so a streaming launch run
  in two row bands under a cap that cuts lanes mid-path gives the whole
  launch's planes, without and with NEE, depth and sup of lanes idle in
  both aside (chip_smoke.py::k1_strict holds the kernel so on the card).
- chip_smoke.py::lane_utilisation on constructed rays planes.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import LegacyCamera, smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene, two_sphere_scene,
)
from smallpt_tpu_torch.ops import megakernel as mk

BIG = 3.0e38
NAN = float("nan")
_CFG = RenderConfig(width=32, height=24, spp_per_cell=1, max_depth=24,
                    camera_model=CameraModel.LEGACY, filter=Filter.TENT)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# -- the emulation --------------------------------------------------------


def k1_tt(lane, c, eps, check_eps=True):
    """The kernel's k1_tt: (tt, miss, inside) for every pair, broadcasting
    the lanes' (ox oy oz dx dy dz) against the spheres' (cx cy cz r) and
    eps (check_eps False: an inside path without its eps >= 0 check)."""
    ox, oy, oz, dx, dy, dz = lane
    cx, cy, cz, r = c
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    b = opx * dx + opy * dy + opz * dz
    fx = opx - b * dx
    fy = opy - b * dy
    fz = opz - b * dz
    pp = fx * fx + fy * fy + fz * fz
    sp = torch.sqrt(pp)
    det = (r - sp) * (r + sp)
    miss = ~((det >= 0.0) & (r > 0.0))
    # past the early miss: NaN where it has returned
    det, b, pp = (torch.where(miss, NAN, x) for x in (det, b, pp))
    s = torch.sqrt(torch.clamp(det, min=0.0))
    denom = b + s
    q = b * b + pp
    inside = ~miss & (q < r * r)
    if check_eps:
        inside = inside & (eps >= 0.0)
    tt_inside = torch.where(denom > eps, denom, BIG)
    # the whole test: NaN where the inside path has returned
    q = torch.where(inside, NAN, q)
    opn = torch.sqrt(q)
    cc = (opn - r) * (opn + r)
    one = torch.ones_like(denom)
    t_near = torch.where(denom > 0.0,
                         cc / torch.where(denom == 0.0, one, denom), -BIG)
    tt_whole = torch.where(t_near > eps, t_near,
                           torch.where(denom > eps, denom, BIG))
    tt = torch.where(inside, tt_inside, tt_whole)
    return torch.where(miss, BIG, tt), miss, inside


def _pairs(lane, cols):
    """Every (lane, sphere) pair: the lanes' six (n,) tensors against the
    (S, 5) columns, as (n, S) operands of k1_tt and mk._sphere_tt."""
    lanes = [v.reshape(-1)[:, None] for v in lane]
    c = [cols[:, k][None, :] for k in range(5)]
    return lanes, c


def _held(lane, cols):
    """k1_tt against the whole test on every pair, bit for bit; returns
    the (miss, inside) counts."""
    lanes, c = _pairs(lane, cols)
    got, miss, inside = k1_tt(lanes, c[:4], c[4])
    want = mk._sphere_tt(*lanes, *c)
    assert torch.equal(_bits(got), _bits(want))
    m2, i2 = mk._k1_classes(*lanes, *c)
    assert torch.equal(miss, m2) and torch.equal(inside, i2)
    return int(miss.sum()), int(inside.sum())


def _sweeps(scene, cfg, seed=3):
    """The rays of the plain version's sweeps and shadow sweeps on scene
    (one pass of cfg), each with the columns it swept."""
    table = mk.build_scene_table(scene, cfg)
    cam = mk.build_camera_vec(smallpt_camera(), cfg)
    seen, real = [], mk._sweep

    def spy(ox, oy, oz, dx, dy, dz, cols, skip=None):
        seen.append(((ox, oy, oz, dx, dy, dz), cols))
        return real(ox, oy, oz, dx, dy, dz, cols, skip)

    mk._sweep = spy
    try:
        mk.render_pass_plain(table, cam, cfg, *rng.key_words(
            rng.base_key(seed)), n_spheres=scene.n_spheres)
    finally:
        mk._sweep = real
    return seen


# -- K1's sphere test -------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell_nee", "two_sphere",
                                  "procedural2048"])
def test_k1_test_equals_the_whole_test_on_the_plain_sweeps(name):
    scene, cfg = {
        "cornell_nee": (cornell_box_scene(), _CFG.replace(nee_lights=(8,))),
        "two_sphere": (two_sphere_scene(), _CFG.replace(max_depth=12)),
        "procedural2048": (procedural_sphere_scene(2048), _CFG.replace(
            width=8, height=6, max_depth=8)),
    }[name]
    miss = inside = pairs = 0
    for lane, cols in _sweeps(scene, cfg):
        m, i = _held(lane, cols)
        miss, inside = miss + m, inside + i
        pairs += lane[0].numel() * cols.shape[0]
    # the early miss and the whole test are taken, and the inside path
    # wherever rays start inside a sphere (not in the two-sphere scene,
    # whose camera and ball lie outside both spheres)
    assert 0 < miss < pairs and inside < pairs - miss
    assert (inside > 0) == (name != "two_sphere")
    if name == "cornell_nee":
        # every ray starts inside the six walls (the inside path's share is
        # near 6/9 of every pair, the light's shell adding to it)
        assert inside > 0.6 * pairs


def test_origin_exactly_on_a_wall():
    """Rays from (1, 40.8, 81.6), on the left wall (its centre 1e5 away on
    x, r = 1e5): q lands within an ulp of r*r = 1e10 on both sides of the
    guard, and the whole test meets cc == 0."""
    g = np.random.default_rng(7)
    d = g.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lane = [_f32(np.full(4096, v)) for v in (1.0, 40.8, 81.6)]
    lane += [_f32(d[:, k]) for k in range(3)]
    cols = _f32([[1e5 + 1, 40.8, 81.6, 1e5, 1e-4]])
    miss, inside = _held(lane, cols)
    assert 0 < inside < 4096 - miss
    lanes, c = _pairs(lane, cols)
    opx, opy, opz = (c[k] - lanes[k] for k in range(3))
    b = opx * lanes[3] + opy * lanes[4] + opz * lanes[5]
    fx, fy, fz = (op - b * lanes[3 + k] for k, op in enumerate((opx, opy,
                                                                opz)))
    opn = torch.sqrt(b * b + (fx * fx + fy * fy + fz * fz))
    assert bool((((opn - c[3]) * (opn + c[3])) == 0.0).any())


@pytest.mark.parametrize("side", ["below", "at", "above"])
def test_q_one_ulp_either_side_of_the_guard(side):
    """On the axis through the centre, pp = 0 and q = z * z exactly as the
    test rounds it: z one ulp below 5 takes the inside path of r = 5, z =
    5 and one ulp above take the whole test; r one ulp either side of the
    origin's distance likewise."""
    z = {"below": np.nextafter(np.float32(5), np.float32(0)),
         "at": np.float32(5),
         "above": np.nextafter(np.float32(5), np.float32(10))}[side]
    ds = [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0.6, 0.0, 0.8),
          (0.0, 0.8, -0.6)]
    lane = [_f32([0.0] * 4), _f32([0.0] * 4), _f32([-z] * 4)]
    lane += [_f32([d[k] for d in ds]) for k in range(3)]
    r5 = np.float32(5)
    radii = [r5, np.nextafter(r5, np.float32(0)),
             np.nextafter(r5, np.float32(10))]
    cols = _f32([[0.0, 0.0, 0.0, r, 1e-4] for r in radii])
    _held(lane, cols)
    lanes, c = _pairs(lane, cols)
    inside = k1_tt(lanes, c[:4], c[4])[2]
    # the axis ray against r = 5: the guard decides on q = z * z alone
    assert bool(inside[0, 0]) == (side == "below")


def test_tangent_rays_and_degenerate_spheres():
    """det exactly 0 (a ray at distance r from the centre), r = 0, r < 0,
    NaN radius, NaN origin, eps 0 and -0, a ray from inside a ball."""
    lane = [_f32(v) for v in (
        [-10.0, -10.0, NAN, 27.0, 0.0],
        [5.0, 0.0, 0.0, 16.5, 0.0],
        [0.0, 0.0, 0.0, 47.0, 0.0],
        [1.0, 1.0, 1.0, 0.6, 1.0],
        [0.0, 0.0, 0.0, 0.8, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0])]
    cols = _f32([
        [0.0, 0.0, 0.0, 5.0, 1e-4],
        [0.0, 0.0, 0.0, 0.0, 1e-4],
        [0.0, 0.0, 0.0, -5.0, 1e-4],
        [0.0, 0.0, 0.0, NAN, 1e-4],
        [27.0, 16.5, 47.0, 16.5, 0.0],
        [27.0, 16.5, 47.0, 16.5, -0.0],
        [27.0, 16.5, 47.0, 16.5, 1e-4],
    ])
    miss, inside = _held(lane, cols)
    assert miss and inside
    lanes, c = _pairs(lane, cols)
    # det == 0: the ray grazes the sphere at t = b
    assert float(mk._sphere_tt(*lanes, *c)[0, 0]) == pytest.approx(10.0)


@pytest.mark.parametrize("r", [1e-20, 2e19])
def test_r_squared_underflowing_and_overflowing(r):
    """r = 1e-20: r*r is subnormal, and origins a fraction of r off the
    centre still take the inside path exactly; r = 2e19: r*r overflows to
    inf, every finite q is inside, and an origin whose b*b overflows takes
    the whole test."""
    g = np.random.default_rng(11)
    n = 512
    scale = np.float32(r)
    o = (g.uniform(-1.5, 1.5, size=(n, 3)) * scale).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lane = [_f32(o[:, k]) for k in range(3)] + [_f32(d[:, k])
                                                 for k in range(3)]
    cols = _f32([[0.0, 0.0, 0.0, r, 0.0], [0.0, 0.0, 0.0, r, 1e-4]])
    miss, inside = _held(lane, cols)
    assert inside > 0
    rr = _f32(r) * _f32(r)
    assert (float(rr) == math.inf) == (r > 1e19)


def test_the_eps_check_is_needed():
    """An origin inside the sphere under a negative eps: the whole test
    returns t_near (< 0, > eps), so an inside path that did not check eps
    would return denom and part from it; k1_tt keeps the whole test."""
    lane = [_f32([0.0]), _f32([0.0]), _f32([0.0]), _f32([0.0]), _f32([0.0]),
            _f32([1.0])]
    cols = _f32([[0.0, 0.0, 1.0, 5.0, -1e30]])
    _held(lane, cols)
    lanes, c = _pairs(lane, cols)
    whole = float(mk._sphere_tt(*lanes, *c))
    assert whole < 0.0
    _, _, inside = k1_tt(lanes, c[:4], c[4])
    assert not bool(inside.any())
    unchecked = k1_tt(lanes, c[:4], c[4], check_eps=False)
    assert bool(unchecked[2].all()) and float(unchecked[0]) != whole


# -- the bound's counts -----------------------------------------------------


@pytest.mark.parametrize("shadow", [False, True])
def test_count_pairs_follows_the_kernels_sweeps(shadow):
    """mk._count_pairs against a loop over the kernel's sweep: every row,
    or for a shadow sweep the rows in order, the light's row skipped, up
    to the first one nearer than the light."""
    scene = cornell_box_scene()
    cols = mk.build_scene_table(scene, _CFG)[:scene.n_spheres, :5]
    g = np.random.default_rng(5)
    n = 300
    o = np.stack([g.uniform(2, 98, n), g.uniform(1, 80, n),
                  g.uniform(1, 160, n)], 1).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = [_f32(o[:, k]) for k in range(3)] + [_f32(d[:, k])
                                               for k in range(3)]
    mask = torch.as_tensor(g.uniform(size=n) < 0.7)
    li = 8
    t_stop = _f32(g.uniform(1, 200, n))
    counts = {}
    kw = dict(skip=li, t_stop=t_stop) if shadow else {}
    mk._count_pairs(counts, "x_", ray, cols, mask, **kw)
    lanes, c = _pairs(ray, cols)
    tt, miss, inside = k1_tt(lanes, c[:4], c[4])
    want = dict.fromkeys(mk.PAIR_CLASSES, 0)
    for j in range(n):
        if not bool(mask[j]):
            continue
        for s in range(cols.shape[0]):
            if shadow and s == li:
                continue
            cls = ("miss" if miss[j, s] else "inside" if inside[j, s]
                   else "full")
            want[cls] += 1
            if shadow and float(tt[j, s]) < float(t_stop[j]):
                break
    assert {k: counts[f"x_pairs_{k}"] for k in mk.PAIR_CLASSES} == want


def test_plain_counts_cover_every_live_ray():
    """Each live ray of the plain version's sweeps tests every sphere once:
    the three classes sum to rays x spheres."""
    scene = cornell_box_scene()
    table = mk.build_scene_table(scene, _CFG)
    cam = mk.build_camera_vec(smallpt_camera(), _CFG)
    counts = {}
    _, rays = mk.render_pass_plain(table, cam, _CFG, *rng.key_words(
        rng.base_key(4)), n_spheres=scene.n_spheres, counts=counts)
    total = sum(counts[f"pairs_{k}"] for k in mk.PAIR_CLASSES)
    assert total == int(rays.sum()) * scene.n_spheres


# -- the lane queue's premise ---------------------------------------------


@pytest.mark.parametrize("n_iters", [5, 40])
@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_a_capped_launch_in_two_bands_equals_the_whole(nee, n_iters):
    cfg = _CFG.replace(nee_lights=(8,)) if nee else _CFG
    scene = cornell_box_scene()
    table = mk.build_scene_table(scene, cfg)
    cam = mk.build_camera_vec(smallpt_camera(), cfg)
    k0, k1 = rng.key_words(rng.base_key(31))
    f, i = mk.init_stream_state(cfg, device="cpu")
    mk.set_sample_budget(i, 3, cfg)
    _, _, rays = mk.stream_step_plain(table, cam, cfg, k0, k1, f, i,
                                      n_iters, n_spheres=scene.n_spheres)
    fw, iw = mk._planes(f, i)
    half, w = cfg.height // 2, cfg.width
    band_rays = 0
    for b in range(2):
        fb, ib = mk.init_stream_state(cfg, n_rows=half, device="cpu")
        mk.set_sample_budget(ib, 3, cfg, n_rows=half)
        _, _, r = mk.stream_step_plain(table, cam, cfg, k0, k1, fb, ib,
                                       n_iters, row_offset=b * half,
                                       n_rows=half,
                                       n_spheres=scene.n_spheres)
        band_rays += int(r)
        fb, ib = mk._planes(fb, ib)
        lanes = slice(b * half * w, (b + 1) * half * w)
        g = half * w
        assert torch.equal(_bits(fb[:, :g]), _bits(fw[:, lanes]))
        idle = (ib[2, :g] == 0) & (iw[2, lanes] == 0)
        for k, name in enumerate(mk._I_PLANES):
            differ = ib[k, :g] != iw[k, lanes]
            if name in ("depth", "sup"):
                differ &= ~idle
            assert not bool(differ.any()), name
    assert band_rays == int(rays) > 0
    if n_iters == 5:
        # the cap stops lanes mid-path
        assert bool((iw[mk._I_ALIVE, :cfg.n_pixels] == 1).any())


def test_a_camera_on_the_wall_reaches_both_sides_of_the_guard():
    """chip_smoke.py's on-wall camera (k1_constructed_launches): every
    camera ray starts exactly on the left wall, and its test of that wall
    takes the inside path on some rays and the whole test on others."""
    d = np.array([1.0, 0.0, -1.0], np.float32)
    cam = LegacyCamera(origin=torch.tensor([1.0, 40.8, 81.6]),
                       direction=torch.tensor(d / np.linalg.norm(d)),
                       fov_scale=torch.tensor(0.5135),
                       push_forward=torch.tensor(0.0))
    cfg = _CFG.replace(width=64, height=48)
    camv = mk.build_camera_vec(cam, cfg).reshape(-1).tolist()
    lane = torch.arange(cfg.n_pixels)
    kk = torch.full((cfg.n_pixels,), 5, dtype=torch.int64)
    wa = lane.to(torch.int64)
    o, dd = mk._camera_rays(cfg, camv, lane % cfg.width, lane // cfg.width,
                            torch.zeros_like(lane), wa, kk, kk)
    assert bool((o[0] == 1.0).all())
    cols = mk.build_scene_table(cornell_box_scene(), cfg)[:1, :5]
    lanes, c = _pairs([*o, *dd], cols)
    _, miss, inside = k1_tt(lanes, c[:4], c[4])
    assert bool(inside.any()) and bool((~inside & ~miss).any())
    _held([*o, *dd], cols)


# -- lane utilisation -------------------------------------------------------


@pytest.mark.parametrize("rays,want", [
    ([3] * 64, 1.0),
    ([1] * 31 + [9] + [1] * 32, (40 + 32) / (32 * 9 + 32)),
    ([2] * 33, 66 / (32 * 2 + 32 * 2)),
    ([0] * 32, 1.0),
])
def test_lane_utilisation(rays, want):
    assert chip_smoke.lane_utilisation(torch.tensor(rays)) == pytest.approx(
        want)
