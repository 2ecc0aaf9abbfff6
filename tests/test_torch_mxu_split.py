"""K5's redesigned sweep (csrc/closest_hit_mxu.cu: only the live slots
staged, in slot order, part A's rows through the early-miss stable test and
each live small sphere through its non-zero coefficients with the miss
decided at det; the slots cut into ranges; the partials merged in range
order; several rays a thread), emulated in plain PyTorch and held bit for
bit to the plain version it must equal, ops/intersect_pallas.py::
closest_hit_mxu_plain, on the CPU at toy sizes.

The emulation follows the kernel's design, not its code. The rays are
padded to whole blocks of 128 threads x rays_per_thread with the kernel's
finite dummy ray. Each range of slots keeps its live slots in slot order
(a part-A row whose radius is > 0, a small sphere whose det row holds a
non-zero column 7) and folds them one slot at a time from (3e38, slot 0)
with the strict <: a part-A slot through the early-miss stable form
(tests/test_torch_hit_split.py's emulation of lane.cuh::early_stable_tt), a
small one through b = ((cx dx + cy dy) + cz dz) - od, e = (((2cx ox + 2cy
oy) + 2cz oz) + (-q)) - oo, det = b b + e, decided at det >= 0 (NaN fed to
the rest of the test where it has returned, so a result taken past a miss
would show). The ranges' partials (t, slot) are folded in range order
with the strict <. The cut is a parameter: one range, one slot a range,
ragged ranges, ranges split at the A/B boundary, and whole 256-slot chunks
as the kernel cuts.

Gates: t and slot of every ray bit for bit (t compared as int32) on
procedural_sphere_scene(300) and the Cornell box, rays from inside and
outside; 1, 2 and 4 rays a thread and a ragged block; twin spheres, where
a merge that takes ties (<=) fails; tangent rays (det exactly 0 in both
forms); origins inside spheres; rays that miss everything; masked rows;
a zero and a NaN radius among part A's rows. The non-zero-term form equals
the 8-term dots summed left to right with their zero terms (the form the
kernel had before) bit for bit in det and in the candidate t on finite
features, origins and directions with zero components included, b up to
the sign of a zero (which differs on a ray built for it).
"""

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene, sphere_scene_from_arrays,
)
from smallpt_tpu_torch.ops import intersect_pallas as ip
from test_torch_hit_split import stable_tt

BIG = 3.0e38
BLOCK = 128  # the kernel's threads a block
CHUNK = 256  # the kernel's slots a staged chunk
EPS = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _nan_past(go, x):
    return torch.where(go, x, float("nan"))


# -- the emulation --------------------------------------------------------


def coef_tt(feats, coef, eps):
    """closest_hit_mxu.cu::coef_tt over broadcast pairs: feats (ox, oy, oz,
    dx, dy, dz, od, oo), coef [cx cy cz 2cx 2cy 2cz -q]; (go, tt)."""
    ox, oy, oz, dx, dy, dz, od, oo = feats
    cx, cy, cz, tx, ty, tz, nq = coef
    b = cx * dx + cy * dy + cz * dz - od
    e = tx * ox + ty * oy + tz * oz + nq - oo
    det = b * b + e
    go = det >= 0.0
    det, b = _nan_past(go, det), _nan_past(go, b)
    s = torch.sqrt(det)
    t0 = b - s
    t1 = b + s
    tt = torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, BIG))
    return go, torch.where(go, tt, BIG)


def _pad_rays(org, dirs, rays_per_thread):
    n = org.shape[1]
    per_block = BLOCK * rays_per_thread
    n_pad = -(-max(n, 1) // per_block) * per_block
    o = torch.zeros((3, n_pad))
    d = torch.zeros((3, n_pad))
    d[0] = 1.0
    o[:, :n], d[:, :n] = org, dirs
    return o, d


def _slots(stable, mxu, n_a, n_b):
    """Every slot's staging: (live (S,) bool, is_a (S,) bool, stable rows
    (S, 5), coefficients (S, 7)), S = n_a + n_b, as the kernel reads them
    from the two tables."""
    rows = mxu[:2 * n_b].view(-1, 2, 64, 8)
    row1 = rows[:, 0].reshape(-1, 8)
    row2 = rows[:, 1].reshape(-1, 8)
    live = torch.cat([stable[:n_a, 3] > 0.0, row2[:, 7] != 0.0])
    is_a = torch.arange(n_a + n_b) < n_a
    st = torch.cat([stable[:n_a, :5], torch.zeros((n_b, 5))])
    coef = torch.cat([torch.zeros((n_a, 7)),
                      torch.cat([row1[:, 0:3], row2[:, 3:7]], dim=1)])
    return live, is_a, st, coef


def _range_sweep(lane, feats, ids, is_a, st, coef, eps):
    """One unit's fold over its live slots ids from (3e38, slot 0) with the
    strict <: the running best before each slot is the least t of the
    slots before it (cummin); the winner is the last slot taken."""
    n = lane[0].shape[0]
    if not ids.numel():
        return torch.full((n,), BIG), torch.zeros((n,), dtype=torch.int32)
    tt = torch.empty((n, ids.numel()))
    a = is_a[ids]
    if bool(a.any()):
        _, tt[:, a] = stable_tt(lane, [st[ids[a], k][None, :]
                                       for k in range(5)])
    if bool((~a).any()):
        _, tt[:, ~a] = coef_tt(feats, [coef[ids[~a], k][None, :]
                                       for k in range(7)], eps)
    run = torch.cummin(tt, dim=1).values
    before = torch.cat([torch.full((n, 1), BIG), run[:, :-1]], dim=1)
    take = tt < before
    last = (take * torch.arange(1, ids.numel() + 1)).amax(dim=1) - 1
    hit = last >= 0
    at = last.clamp(min=0)
    return (torch.where(hit, tt.gather(1, at[:, None])[:, 0], BIG),
            torch.where(hit, ids.to(torch.int32)[at], 0))


def split_sweep(org, dirs, stable, mxu, n_a, n_b, eps, bounds,
                rays_per_thread=4, strict=True):
    """The emulated K5 launch: (t, slot) for (3, N) ray planes over slots
    [0, n_a + n_b), cut at ``bounds``, the ranges' partials merged in range
    order with the strict < (<= where not strict)."""
    n = org.shape[1]
    o, d = _pad_rays(org, dirs, rays_per_thread)
    lane = [x[:, None] for x in (*o, *d)]
    ox, oy, oz, dx, dy, dz = lane
    feats = (ox, oy, oz, dx, dy, dz, (ox * dx + oy * dy) + oz * dz,
             (ox * ox + oy * oy) + oz * oz)
    live, is_a, st, coef = _slots(stable, mxu, n_a, n_b)
    e = float(np.float32(eps))
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ids = torch.nonzero(live[lo:hi])[:, 0] + lo
        parts.append(_range_sweep(lane, feats, ids, is_a, st, coef, e))
    best = parts[0]
    for p in parts[1:]:
        take = p[0] < best[0] if strict else p[0] <= best[0]
        best = tuple(torch.where(take, a, b) for a, b in zip(p, best))
    return tuple(x[:n] for x in best)


def _cuts(n_slots: int, n_a: int) -> dict:
    ragged = sorted({0, n_slots, *np.random.default_rng(n_slots).integers(
        1, max(n_slots, 2), 5).tolist()})
    return {
        "one_range": [0, n_slots],
        "one_slot_a_range": list(range(n_slots + 1)),
        "ragged": ragged,
        "ab_boundary": sorted(set(ragged) | {min(n_a, n_slots)}),
        "chunks": list(range(0, n_slots, CHUNK)) + [n_slots],
    }


def _diff(got, want) -> list:
    return [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]


def _tables(scene):
    stable, mxu, _, nbc, nsc, eps, shift = ip.build_sphere_table_mxu(scene)
    return stable, mxu, 64 * nbc, 64 * nsc, eps, shift


def _planes(o, d, shift=None):
    o = np.asarray(o, np.float32)
    if shift is not None:
        o = (o - shift.numpy()[None]).astype(np.float32)
    d = np.asarray(d, np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(o.T)),
            torch.from_numpy(np.ascontiguousarray(d.T)))


def _check(org, dirs, tabs, cuts=None, rays_per_thread=4):
    stable, mxu, n_a, n_b, eps, _ = tabs
    want = ip.closest_hit_mxu_plain(org, dirs, stable, mxu, n_a, n_b, eps)
    for name, bounds in _cuts(n_a + n_b, n_a).items():
        if cuts is None or name in cuts:
            got = split_sweep(org, dirs, stable, mxu, n_a, n_b, eps, bounds,
                              rays_per_thread)
            assert _diff(got, want) == [0, 0], name
    return want


def _random_rays(n, seed, inside):
    r = np.random.default_rng(seed)
    lo, hi = ([5, 5, 20], [95, 75, 150]) if inside else (
        [-40, -40, 170], [140, 120, 320])
    return r.uniform(lo, hi, (n, 3)), r.normal(size=(n, 3))


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        scene = (procedural_sphere_scene(300) if name == "procedural300"
                 else cornell_box_scene())
        _SCENES[name] = (scene, _tables(scene))
    return _SCENES[name]


# -- the gates ------------------------------------------------------------


@pytest.mark.parametrize("cut", ["one_range", "one_slot_a_range", "ragged",
                                 "ab_boundary", "chunks"])
@pytest.mark.parametrize("inside", [True, False])
@pytest.mark.parametrize("name", ["procedural300", "cornell"])
def test_every_cut(name, inside, cut):
    """procedural_sphere_scene(300) (part A full of small spheres, which
    the small class holds again) and the Cornell box (1e5 walls, a
    chunk of masked padding) on rays from inside and from outside: every
    cut gives closest_hit_mxu_plain's bits."""
    _, tabs = _scene(name)
    org, dirs = _planes(*_random_rays(96, 1 + inside, inside), tabs[5])
    want = _check(org, dirs, tabs, cuts=(cut,))
    assert float((want[0] < BIG).float().mean()) > 0.3


@pytest.mark.parametrize("rays_per_thread", [1, 2, 4])
def test_rays_per_thread_and_ragged_block(rays_per_thread):
    """77 rays fill no whole block: the dummy rays change no real ray's
    result, whatever the rays a thread."""
    _, tabs = _scene("procedural300")
    org, dirs = _planes(*_random_rays(77, 3, True), tabs[5])
    _check(org, dirs, tabs, cuts=("ragged", "chunks"),
           rays_per_thread=rays_per_thread)


def _twin():
    """procedural_sphere_scene(300) with its sphere 200 twice (the copy
    appended: slot n_a + 300, 100 slots after the original's), and 160
    rays aimed at it."""
    s = procedural_sphere_scene(300)
    m = s.material
    pick = [*range(300), 200]
    twin = sphere_scene_from_arrays(s.center[pick], s.radius[pick],
                                    m.emission[pick], m.albedo[pick],
                                    m.refl[pick])
    tabs = _tables(twin)
    r = np.random.default_rng(5)
    c = s.center[200].numpy()
    o = c[None] + r.uniform(-12, 12, (160, 3))
    d = c[None] + r.uniform(-0.5, 0.5, (160, 3)) * float(s.radius[200]) - o
    return tabs, _planes(o, d, tabs[5])


@pytest.mark.parametrize("cut", ["chunks", "ragged", "one_slot_a_range"])
def test_twin_spheres(cut):
    """Two identical small spheres: their coefficients are the same, so
    every hit on one ties with the other; the strict merge keeps the first
    slot, the sequential fold's, under every cut."""
    tabs, (org, dirs) = _twin()
    n_a = tabs[2]
    want = _check(org, dirs, tabs, cuts=(cut,))
    assert int((want[1] == n_a + 200).sum()) > 40
    assert not bool((want[1] == n_a + 300).any())


def test_nonstrict_merge_fails():
    """A merge that takes ties (<=) picks the later twin: the slot differs
    from the sequential fold's, t does not."""
    tabs, (org, dirs) = _twin()
    stable, mxu, n_a, n_b, eps, _ = tabs
    got = split_sweep(org, dirs, stable, mxu, n_a, n_b, eps,
                      _cuts(n_a + n_b, n_a)["one_slot_a_range"],
                      strict=False)
    diff = _diff(got, ip.closest_hit_mxu_plain(org, dirs, stable, mxu, n_a,
                                               n_b, eps))
    assert diff[1] > 0 and diff[0] == 0


def _made_tables(c, r):
    """The tables of a few spheres with no recentring (shift 0), so that
    a constructed ray's arithmetic stays exact."""
    c = np.asarray(c, np.float32)
    r = np.asarray(r, np.float32)
    stable, mxu, _, n_sc = ip._mxu_tables(c, r, np.zeros(3, np.float32),
                                          EPS, 5e-7, ip.STABLE_RADIUS)
    return (torch.from_numpy(stable), torch.from_numpy(mxu), 128, 64 * n_sc,
            EPS, torch.zeros(3))


def test_tangent_rays_det_exactly_zero():
    """Rays that graze a unit sphere (both its part-A and its small-class
    copy): det is exactly 0 in the coefficient form (b = 5, e = -25) and
    in the stable form, and in the stable form on a 1e5 sphere; each is a
    hit at the tangent point, under every cut."""
    tabs = _made_tables([(0, 0, 0), (0, -1e5 - 5, 0)], [1.0, 1e5])
    org, dirs = _planes([(-5, 1, 0), (-5, -1, 0), (-7, 0, 1), (-3, 0, -1),
                         (-9, -5, 0)], np.tile([1.0, 0, 0], (5, 1)))
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*org, *dirs))
    feats = (ox, oy, oz, dx, dy, dz, (ox * dx + oy * dy) + oz * dz,
             (ox * ox + oy * oy) + oz * oz)
    _, _, _, coef = _slots(*tabs[:4])
    go, tt = coef_tt(feats, [coef[128, k] for k in range(7)], EPS)
    assert bool(go[:4].all())
    np.testing.assert_array_equal(tt[:4, 0].numpy(), [5, 5, 7, 3])
    want = _check(org, dirs, tabs)
    assert bool((want[0] < BIG).all())


def test_rays_from_inside_a_sphere():
    """Origins inside small spheres and a 1e5 sphere: the near root is
    behind the origin, so each takes the far one, under every cut."""
    tabs = _made_tables([(0, 0, 0), (30, 0, 0), (0, 1e5 + 50, 0)],
                        [10.0, 4.0, 1e5])
    r = np.random.default_rng(7)
    o = np.concatenate([r.uniform(-3, 3, (60, 3)),
                        np.float32([30, 0, 0]) + r.uniform(-1, 1, (60, 3))])
    org, dirs = _planes(o, r.normal(size=(120, 3)))
    want = _check(org, dirs, tabs)
    assert bool((want[0] > 0.5).all()) and bool((want[0] < BIG).all())


def test_rays_that_miss_everything():
    """Rays from far beyond the scene pointing away: (3e38, 0) each, under
    every cut."""
    _, tabs = _scene("procedural300")
    r = np.random.default_rng(6)
    d = r.normal(size=(130, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    org, dirs = _planes(np.tile([50, 40, 1e6], (130, 1)), d, tabs[5])
    want = _check(org, dirs, tabs)
    assert bool((want[0] == BIG).all()) and int(want[1].abs().sum()) == 0


def test_masked_rows_are_left_out():
    """Live small spheres masked as the big spheres and the padding are (q
    = 1e30, a 0 in column 7): left out as the slots are staged, never a
    winner; the rest of their chunks fold as before."""
    _, (stable, mxu, n_a, n_b, eps, shift) = _scene("procedural300")
    r = np.random.default_rng(9)
    live = ip.mxu_live_rows(mxu, n_b)[0]
    drop = live[torch.from_numpy(r.choice(live.numel(), 60, replace=False))]
    rows2 = (drop // 64) * 128 + 64 + drop % 64
    masked = mxu.clone()
    masked[rows2, 6] = -1e30
    masked[rows2, 7] = 0.0
    assert ip.mxu_live_rows(masked, n_b)[0].numel() == live.numel() - 60
    org, dirs = _planes(*_random_rays(160, 10, True), shift)
    tabs = (stable, masked, n_a, n_b, eps, shift)
    want = _check(org, dirs, tabs)
    assert not bool(torch.isin(want[1], (drop + n_a).to(torch.int32)).any())
    before = ip.closest_hit_mxu_plain(org, dirs, stable, mxu, n_a, n_b, eps)
    assert bool(torch.isin(before[1], (drop + n_a).to(torch.int32)).any())


def test_zero_and_nan_radius_in_part_a():
    """Part-A rows given a zero or a NaN radius are left out as the slots
    are staged (a NaN radius is not > 0) and never win."""
    _, (stable, mxu, n_a, n_b, eps, shift) = _scene("procedural300")
    st = stable.clone()
    st[[2, 50, 51], 3] = 0.0
    st[[7, 90], 3] = float("nan")
    org, dirs = _planes(*_random_rays(160, 11, True), shift)
    want = _check(org, dirs, (st, mxu, n_a, n_b, eps, shift))
    assert not bool(torch.isin(want[1], torch.tensor(
        [2, 50, 51, 7, 90], dtype=torch.int32)).any())


def _dot8(rows, feats):
    """rows (M, 8) . feats (8, each (N, 1)): the eight products summed left
    to right, zero terms included (the kernel's form before this
    design)."""
    p = rows[None, :, 0] * feats[0]
    for k in range(1, 8):
        p = p + rows[None, :, k] * feats[k]
    return p


@pytest.mark.parametrize("eps", [EPS, 0.0])
def test_nonzero_terms_equal_the_8_term_dots(eps):
    """On finite features the non-zero-term form gives the 8-term dots'
    det and candidate t bit for bit, and their b up to the sign of a zero,
    for every small row, masked rows included (a miss in both, |o| far
    below 1e15): isotropic rays, and origins and directions with zero
    components (-0 included), where the zero terms meet zero sums."""
    _, (stable, mxu, n_a, n_b, _, shift) = _scene("procedural300")
    o, d = _random_rays(200, 12, True)
    o = (o - shift.numpy()[None]).astype(np.float32)
    o[:40, :2] = 0.0
    o[40:60] = 0.0
    o[60:70, 1] = -0.0
    d[70:110] = np.eye(3)[np.arange(40) % 3] * np.where(
        np.arange(40)[:, None] % 2, 1.0, -1.0)
    d[110:120, 0] = -0.0
    # an origin at -0 with a direction below 0 on every axis: od = +0,
    # while a masked row's (c = 0) first three products sum to -0
    o[120:125] = -0.0
    d[120:125] = (-0.6, -0.8, -0.0)
    org, dirs = _planes(o, d)
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*org, *dirs))
    od = (ox * dx + oy * dy) + oz * dz
    oo = (ox * ox + oy * oy) + oz * oz
    rows = mxu[:2 * n_b].view(-1, 2, 64, 8)
    row1 = rows[:, 0].reshape(-1, 8)
    row2 = rows[:, 1].reshape(-1, 8)
    f = (dx, dy, dz, ox, oy, oz, torch.ones_like(ox), oo)
    b8 = _dot8(row1, f) - od
    det8 = b8 * b8 + _dot8(row2, f)
    s8 = torch.sqrt(det8)
    tt8 = torch.where(b8 - s8 > eps, b8 - s8,
                      torch.where(b8 + s8 > eps, b8 + s8, BIG))
    coef = [row1[None, :, 0], row1[None, :, 1], row1[None, :, 2],
            row2[None, :, 3], row2[None, :, 4], row2[None, :, 5],
            row2[None, :, 6]]
    b = coef[0] * dx + coef[1] * dy + coef[2] * dz - od
    e = coef[3] * ox + coef[4] * oy + coef[5] * oz + coef[6] - oo
    det = b * b + e
    _, tt = coef_tt((ox, oy, oz, dx, dy, dz, od, oo), coef, eps)
    assert torch.equal(b, b8)  # == holds +0 and -0 alike
    nz = b != 0.0
    assert torch.equal(_bits(b[nz]), _bits(b8[nz]))
    # the zeros' signs do differ there
    assert bool((_bits(b[120:125]) != _bits(b8[120:125])).any())
    assert torch.equal(_bits(det), _bits(det8))
    assert torch.equal(_bits(tt), _bits(tt8))
    masked = row2[:, 7] == 0.0
    assert bool(masked.any()) and bool((tt8[:, masked] == BIG).all())
    assert int((tt < BIG).sum()) > 20
