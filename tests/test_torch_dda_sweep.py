"""K3's redesigned walk (csrc/stream_dda.cu), emulated in plain PyTorch and
held bit for bit to the plain version it must equal,
ops/stream_dda.py::stream_step_dda_plain, on the CPU at toy sizes.

The emulation follows the design, not the code.
- The tables: each cell's count of filled slots (``slot_count``) and its
  slots' [cx cy cz r] (``slot_geom``), derived once from the (C, K, 8) cell
  table that the plain version reads.
- A counted cell sweep: a ray in cell c tests slots 0 .. count[c] - 1 in
  unroll groups of 2 or 4 and a tail of single slots, the groups and the
  slots in them also taken in other orders, since the fold's result must
  not depend on the order (the per-thread sweep measured and left out on
  the card). Each slot goes through the early-miss stable test (det
  decided first; NaN fed to the rest of the test where it has returned,
  so a result taken past a miss would show); a miss is dropped before the
  fold. The fold keeps the least t and the slot attaining it with the
  strict <, and on a tie (t equal and below 3e38) reads both slots' ids
  and keeps the lesser; the winner's id is read after the sweep.
- The kernel's warp sweep: each thread of a warp (32 wide, and 4 wide so
  that a cell wraps several times) folds the slots of its index modulo
  the width as above, and the warp keeps the least t and, among equal
  ones, the least id, as two minima of the floats' bits taken as int32
  (the kernel's REDUX; t > eps >= 0 and the ids are whole numbers >= 0).
- The plain version's cell fold (the least t over every slot of the cell,
  then the least id among the slots attaining it, ops/stream_dda.py's walk
  step) is replicated here as it stands.
- The lane queue: a lane's planes after a launch depend on its own planes
  and the launch's arguments alone, so a launch whose lanes are run in
  two parts (two row bands, ``row_offset`` and ``n_rows``) under the same
  cap gives the whole launch's planes.

Gates: the derived tables equal what the cell table holds on
procedural_sphere_scene(300) at occ_target 16, (10000) at the default grid
and the overflow build nb=(2, 2, 2), k_max=32; both sweeps equal the plain
fold bit for bit (t compared as int32) where the plain fold's t is below
3e38 (elsewhere the running fold takes nothing from the cell, and the
sweeps must find nothing either), on the builds' own cells and on
constructed ones: two identical spheres (the least id must win, within an
unroll group, across a group's boundary and in one thread of a warp), an
empty cell and a full one of K slots, tangent rays (det exactly 0), a ray
from inside a sphere, a zero and a NaN radius among the slots; a fold that
takes ties with <= fails on the twins; the early-miss test equals
``mk._sphere_tt`` on edge inputs; the two bands' planes equal the whole
launch's bit for bit (f32 planes as int32), depth and sup of lanes idle in
both aside, as chip_smoke.py::k3_strict holds the kernel on the card; the
launcher refuses a negative eps, under which the REDUX order would not
hold.
"""

import itertools

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import procedural_sphere_scene
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.ops import stream_dda as sd

BIG = 3.0e38
BIGID = 3.0e38
EPS = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


# -- the emulation --------------------------------------------------------


def early_tt(lane, c, eps):
    """lane.cuh::early_stable_tt: the stable form to det, then, only where det
    >= 0 and r > 0, the rest of the test; (go, tt) with tt 3e38 where it
    has returned. lane: six (n,) tensors; c: four (n,) tensors."""
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
    go = (det >= 0.0) & (r > 0.0)
    nan = float("nan")
    det, b, pp = (torch.where(go, x, nan) for x in (det, b, pp))
    s = torch.sqrt(torch.clamp(det, min=0.0))
    opn = torch.sqrt(b * b + pp)
    cc = (opn - r) * (opn + r)
    denom = b + s
    one = torch.ones_like(denom)
    t_near = torch.where(denom > 0.0,
                         cc / torch.where(denom == 0.0, one, denom), -BIG)
    tt = torch.where(t_near > eps, t_near, torch.where(denom > eps, denom,
                                                       BIG))
    return go, torch.where(go, tt, BIG)


def kernel_order(count: int, unroll: int, groups=None, within=None) -> list:
    """The slots a cell of count filled slots sweeps, in order: the full
    unroll groups (in the order groups gives, by default their own), each
    group's slots in the order within gives (a permutation of
    range(unroll); by default their own), then the tail's single slots."""
    n_full = count // unroll
    groups = range(n_full) if groups is None else groups(n_full)
    within = range(unroll) if within is None else within
    order = [g * unroll + u for g in groups for u in within]
    return order + list(range(n_full * unroll, count))


def counted_sweep(geom, count, cells, lin, lane, eps, order, ties="id"):
    """The kernel's cell sweep for rays in cells lin: (m, idc), the cell's
    least t and its least id (3e38, 3e38 where nothing is hit). order(cnt)
    -> the slots swept for a cell of cnt filled slots. ties "id": the
    kernel's fold (strict <, a tie resolved on the ids); "le": a fold that
    takes the later slot on a tie (<=), which must fail on twins."""
    n = lin.shape[0]
    m = torch.full((n,), BIG)
    bq = torch.zeros((n,), dtype=torch.int64)
    cnt = count[lin].long()
    ids = cells[..., 4]
    for c in torch.unique(cnt).tolist():
        rows = torch.nonzero(cnt == c)[:, 0]
        sub = tuple(v[rows] for v in lane)
        for q in order(c):
            g = geom[lin[rows], q]
            go, tt = early_tt(sub, g.unbind(1), eps)
            mr, br = m[rows], bq[rows]
            if ties == "le":
                take = go & (tt <= mr)
                tie = torch.zeros_like(take)
            else:
                take = go & (tt < mr)
                tie = (go & (tt == mr) & (tt < BIG)
                       & (ids[lin[rows], q] < ids[lin[rows], br]))
            m[rows] = torch.where(take, tt, mr)
            bq[rows] = torch.where(take | tie, q, br)
    idc = torch.where(m < BIG, ids[lin, bq], BIGID)
    return m, idc


def warp_sweep(geom, count, cells, lin, lane, eps, width=32, ties="id"):
    """The kernel's warp sweep of a ray's cell: thread w of a warp of width
    threads tests slots w, w + width, ... below the cell's count, folding
    them with the strict < (the id read where its best changes; on a tie
    below 3e38 the lesser id kept); then the warp's REDUX minima: the least
    t as int32 bits over the threads, then the least id's bits over the
    threads holding it. (m, idc) as counted_sweep's. ties "le": each
    thread's fold takes the later slot on a tie, which must fail on twins
    that one thread sweeps."""
    n = lin.shape[0]
    m = torch.full((width, n), BIG)
    idc = torch.full((width, n), BIGID)
    cnt = count[lin].long()
    ids = cells[..., 4]
    for q in range(int(cnt.max()) if n else 0):
        w = q % width
        go, tt = early_tt(lane, geom[lin, q].unbind(1), eps)
        go = go & (q < cnt)
        idq = ids[lin, q]
        if ties == "le":
            take, tie = go & (tt <= m[w]), torch.zeros_like(go)
        else:
            take = go & (tt < m[w])
            tie = go & (tt == m[w]) & (tt < BIG) & (idq < idc[w])
        m[w] = torch.where(take, tt, m[w])
        idc[w] = torch.where(take | tie, idq, idc[w])
    mb = _bits(m).min(dim=0).values
    ib = torch.where(_bits(m) == mb, _bits(idc),
                     torch.iinfo(torch.int32).max).min(dim=0).values
    m, idc = mb.view(torch.float32), ib.view(torch.float32)
    return m, torch.where(m < BIG, idc, BIGID)


def plain_fold(cells, lin, lane, eps):
    """The plain version's cell fold, as ops/stream_dda.py's walk step
    takes it: (the least t of the cell's slots, the least id among the
    slots attaining it)."""
    slots = cells[lin]
    tt = mk._sphere_tt(*(v[:, None] for v in lane), slots[..., 0],
                       slots[..., 1], slots[..., 2], slots[..., 3], eps)
    mc = tt.min(dim=1).values
    idc = torch.where(tt <= mc[:, None], slots[..., 4],
                      BIGID).min(dim=1).values
    return mc, idc


def _orders(unroll: int) -> dict:
    perm = list(reversed(range(unroll)))
    return {
        "kernel": lambda c: kernel_order(c, unroll),
        "groups_reversed": lambda c: kernel_order(
            c, unroll, groups=lambda g: reversed(range(g))),
        "slots_reversed": lambda c: kernel_order(c, unroll, within=perm),
        "everything_reversed": lambda c: list(reversed(kernel_order(
            c, unroll))),
    }


def _check_sweep(cells, lin, lane, eps=EPS, unroll=4, ties="id"):
    """Every sweep order and the warp sweep (32 threads, and 4 so that a
    cell's slots wrap several times) against the plain fold."""
    count, geom = sd.slot_tables(cells)
    want_m, want_id = plain_fold(cells, lin, lane, eps)
    hit = want_m < BIG
    got = {name: counted_sweep(geom, count, cells, lin, lane, eps, order,
                               ties)
           for name, order in _orders(unroll).items()}
    for width in (32, 4):
        got[f"warp{width}"] = warp_sweep(geom, count, cells, lin, lane, eps,
                                         width, ties)
    for name, (m, idc) in got.items():
        assert torch.equal(m < BIG, hit), name
        assert torch.equal(_bits(m[hit]), _bits(want_m[hit])), name
        assert torch.equal(idc[hit], want_id[hit]), name
    return hit


# -- constructed cells ----------------------------------------------------

K = 8  # slots a constructed cell
P = np.float32([-512.0, -512.0, -512.0])  # far from everything; exact


def _cells(spheres_per_cell) -> torch.Tensor:
    """(C, K, 8) cells, each a list of (centre offset from P, r, id),
    filled from the front and padded as bin_local_spheres pads."""
    cells = np.zeros((len(spheres_per_cell), K, 8), np.float32)
    cells[:, :, 4] = BIGID
    for c, spheres in enumerate(spheres_per_cell):
        for q, (off, r, sid) in enumerate(spheres):
            cells[c, q, 0:3] = P + np.float32(off)
            cells[c, q, 3] = r
            cells[c, q, 4] = sid
    return torch.from_numpy(cells)


def _rays(rays) -> tuple:
    """Six (n,) tensors from (origin offset from P, direction) pairs; the
    directions are normalized in float32."""
    o = torch.from_numpy(np.stack([P + np.float32(a) for a, _ in rays]))
    d = torch.from_numpy(np.stack([np.float32(b) for _, b in rays]))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return (*o.unbind(1), *d.unbind(1))


def _random_rays(n, seed, spread=6.0) -> tuple:
    g = np.random.default_rng(seed)
    o = g.uniform(-spread, spread, (n, 3))
    d = g.normal(size=(n, 3))
    return _rays(list(zip(o, d)))


def _twins(a: int, b: int, id_a: float, id_b: float):
    """A cell of K slots, two identical unit spheres at slots a and b (ids
    id_a and id_b), the others small spheres away from the rays."""
    spheres = [((30.0 + 3 * q, 30.0, 30.0), 0.5, 100.0 + q) for q in range(K)]
    spheres[a] = ((0.0, 0.0, 0.0), 1.0, id_a)
    spheres[b] = ((0.0, 0.0, 0.0), 1.0, id_b)
    return spheres


def _twin_rays():
    """Rays that hit the twins (from outside and from inside), 64 of
    them."""
    g = np.random.default_rng(17)
    far = g.normal(size=(48, 3))
    far = 6.0 * far / np.linalg.norm(far, axis=1, keepdims=True)
    aim = g.uniform(-0.3, 0.3, (48, 3))
    inside = g.uniform(-0.4, 0.4, (16, 3))
    dirs = g.normal(size=(16, 3))
    return _rays([(o, a - o) for o, a in zip(far, aim)]
                 + list(zip(inside, dirs)))


@pytest.mark.parametrize("unroll", [2, 4])
@pytest.mark.parametrize("slots", [(0, 1), (3, 4), (1, 5), (6, 7)],
                         ids=["first_group", "group_boundary", "apart",
                              "last_slots"])
def test_two_identical_spheres_the_least_id_wins(unroll, slots):
    """The later slot holds the lesser id, so the slot order alone would
    pick the wrong twin; the fold must keep the least id, however the
    groups fall."""
    a, b = slots
    cells = _cells([_twins(a, b, 9.0, 7.0)])
    lane = _twin_rays()
    lin = torch.zeros(lane[0].shape[0], dtype=torch.int64)
    hit = _check_sweep(cells, lin, lane, unroll=unroll)
    assert bool(hit.all())
    _, want = plain_fold(cells, lin, lane, EPS)
    assert bool((want == 7.0).all())


def test_a_fold_that_takes_ties_fails_on_the_twins():
    cells = _cells([_twins(3, 4, 7.0, 9.0)])
    lane = _twin_rays()
    lin = torch.zeros(lane[0].shape[0], dtype=torch.int64)
    count, geom = sd.slot_tables(cells)
    _, want = plain_fold(cells, lin, lane, EPS)
    _, got = counted_sweep(geom, count, cells, lin, lane, EPS,
                           _orders(4)["kernel"], ties="le")
    assert bool((want == 7.0).all())
    assert bool((got != want).any())
    _check_sweep(cells, lin, lane)
    # a thread of a 4-wide warp that takes ties with <= keeps slot 7's id
    # over slot 3's
    cells = _cells([_twins(3, 7, 7.0, 9.0)])
    count, geom = sd.slot_tables(cells)
    _, got = warp_sweep(geom, count, cells, lin, lane, EPS, width=4,
                        ties="le")
    assert bool((got != 7.0).any())
    _check_sweep(cells, lin, lane)


def test_empty_and_full_cells():
    """Cell 0 has no sphere (count 0: nothing tested, nothing found); cell
    1 all K slots filled; cell 2 a ragged 5 (a full group of 4 and one
    tail slot)."""
    g = np.random.default_rng(3)
    full = [(tuple(g.uniform(-4, 4, 3)), float(g.uniform(0.3, 1.5)),
             float(q + 1)) for q in range(K)]
    cells = _cells([[], full, full[:5]])
    count, _ = sd.slot_tables(cells)
    assert count.tolist() == [0, K, 5]
    lane = _random_rays(300, 4)
    lin = torch.arange(300) % 3
    hit = _check_sweep(cells, lin, lane)
    assert not bool(hit[lin == 0].any())
    assert bool(hit[lin == 1].any()) and bool(hit[lin == 2].any())
    for unroll in (2, 4):
        _check_sweep(cells, lin, lane, unroll=unroll)


def test_tangent_rays_det_exactly_zero():
    """Rays along x at y = +-1 from x = -5 graze the unit sphere at P:
    op = (5, -+1, 0), b = 5, det = (1 - 1) (1 + 1) = 0 exactly, a hit at
    t = 5; rays at y = +-(1 + 2^-10) miss it."""
    cells = _cells([[((0.0, 0.0, 0.0), 1.0, 4.0),
                     ((0.0, 40.0, 0.0), 1.0, 5.0)]])
    ys = (1.0, -1.0, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10)
    lane = _rays([((-5.0, y, 0.0), (1.0, 0.0, 0.0)) for y in ys])
    lin = torch.zeros(4, dtype=torch.int64)
    go, _ = early_tt(lane, tuple(cells[0, 0, k].expand(4) for k in range(4)),
                     EPS)
    assert go.tolist() == [True, True, False, False]
    hit = _check_sweep(cells, lin, lane)
    assert hit.tolist() == [True, True, False, False]


def test_a_ray_from_inside_a_sphere():
    """An origin inside a radius-3 sphere, a unit sphere beyond its far
    side and one inside it: t_near <= eps, so the far root counts."""
    cells = _cells([[((0.0, 0.0, 0.0), 3.0, 2.0),
                     ((6.0, 0.0, 0.0), 1.0, 3.0),
                     ((1.5, 0.0, 0.0), 0.25, 6.0)]])
    g = np.random.default_rng(5)
    lane = _rays([((0.1, -0.2, 0.05), (1.0, 0.0, 0.0))]
                 + [(tuple(g.uniform(-1, 1, 3)), tuple(g.normal(size=3)))
                    for _ in range(63)])
    lin = torch.zeros(64, dtype=torch.int64)
    hit = _check_sweep(cells, lin, lane)
    assert bool(hit.all())


def test_zero_and_nan_radius_among_the_slots():
    """Filled slots (ids below 3e38, counted) whose radius is 0 or NaN are
    never hit; a ray through a zero-radius sphere's centre included."""
    cells = _cells([[((0.0, 0.0, 0.0), 0.0, 1.0),
                     ((2.0, 0.0, 0.0), float("nan"), 2.0),
                     ((4.0, 0.0, 0.0), 1.0, 3.0),
                     ((0.0, 3.0, 0.0), 0.0, 4.0),
                     ((0.0, 0.0, 3.0), float("nan"), 5.0)]])
    count, _ = sd.slot_tables(cells)
    assert count.tolist() == [5]
    lane = _rays([((-5.0, 0.0, 0.0), (1.0, 0.0, 0.0))]
                 + list(zip(np.random.default_rng(6).uniform(-6, 6, (63, 3)),
                            np.random.default_rng(7).normal(size=(63, 3)))))
    lin = torch.zeros(64, dtype=torch.int64)
    hit = _check_sweep(cells, lin, lane)
    assert bool(hit[0])
    _, want = plain_fold(cells, lin, lane, EPS)
    assert bool((want[hit] == 3.0).all())


def _edge_inputs():
    """(lane, sphere, eps) columns over every mix of edge origins,
    directions, spheres and eps: tangent, inside, through a centre, NaN
    and inf among them."""
    origins = [(-5, 1, 0), (-5, 0, 0), (0, 0, 0), (0.5, 0, 0), (1, 0, 0),
               (np.nan, 0, 0), (np.inf, 0, 0), (-5, 1 + 2 ** -10, 0)]
    dirs = [(1, 0, 0), (0, 1, 0), (-1, 0, 0), (0.6, 0.8, 0), (np.nan, 0, 0)]
    spheres = [((0, 0, 0), 1.0), ((0, 0, 0), 0.0), ((0, 0, 0), np.nan),
               ((0, 0, 0), np.inf), ((3, 4, 0), 5.0), ((0, 0, 0), -1.0),
               ((0, -1e5 - 1, 0), 1e5)]
    rows = list(itertools.product(origins, dirs, spheres, (EPS, np.nan)))
    with np.errstate(all="ignore"):
        o = np.stack([P + np.float32(a) for a, _, _, _ in rows])
        d = np.stack([np.float32(b) for _, b, _, _ in rows])
        c = np.stack([P + np.float32(s[0]) for _, _, s, _ in rows])
    r = np.float32([s[1] for _, _, s, _ in rows])
    eps = np.float32([e for *_, e in rows])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    lane = tuple(t(o[:, k]) for k in range(3)) + tuple(t(d[:, k])
                                                       for k in range(3))
    return lane, tuple(t(c[:, k]) for k in range(3)) + (t(r),), t(eps)


def test_early_miss_test_equals_the_whole_test():
    lane, c, eps = _edge_inputs()
    go, got = early_tt(lane, c, eps)
    want = mk._sphere_tt(*lane, *c, eps)
    assert torch.equal(_bits(got), _bits(want))
    assert bool(go.any()) and not bool(go.all())


# -- the tables -----------------------------------------------------------

_BUILDS = {
    "procedural300_occ16": (300, dict(occ_target=16.0)),
    "procedural10000_default": (10000, {}),
    "overflow_nb222_k32": (300, dict(nb=(2, 2, 2), k_max=32)),
}
_CFG = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=6,
                    camera_model=CameraModel.LEGACY, filter=Filter.TENT)


@pytest.fixture(scope="module")
def tables():
    return {name: sd.build_stream_dda_tables(
        procedural_sphere_scene(n), _CFG, device="cpu", **kw)
        for name, (n, kw) in _BUILDS.items()}


@pytest.mark.parametrize("build", list(_BUILDS))
def test_derived_tables_equal_the_cells(tables, build):
    t = tables[build]
    cells = t.cells
    filled = cells[..., 4] < BIGID
    assert t.slot_count.dtype == torch.int32
    assert t.slot_count.shape == (t.n_cells,)
    assert torch.equal(t.slot_count.long(), filled.sum(dim=1))
    slot = torch.arange(t.k)
    assert torch.equal(filled, slot[None, :] < t.slot_count[:, None])
    assert t.slot_geom.shape == (t.n_cells, t.k, 4)
    assert t.slot_geom.is_contiguous()
    assert torch.equal(_bits(t.slot_geom), _bits(cells[..., :4]))
    assert not bool(cells[..., 3][~filled].any())
    assert int(t.slot_count.max()) <= t.k
    if build == "overflow_nb222_k32":
        assert t.n_overflow > 0 and int(t.slot_count.max()) == t.k


@pytest.mark.parametrize("build", list(_BUILDS))
def test_counted_sweep_on_the_scenes_cells(tables, build):
    """The counted sweep against the plain fold on random rays in random
    cells of each build (the cells as they are: ids in slot order)."""
    t = tables[build]
    lo, cell = np.float32(t.lo), np.float32(t.cell)
    g = np.random.default_rng(8)
    lin = torch.from_numpy(g.integers(0, t.n_cells, 512))
    nx, ny, nz = t.nb
    idx = np.stack([lin // (ny * nz), (lin // nz) % ny, lin % nz], 1)
    o = lo + (idx + g.uniform(0, 1, (512, 3))) * cell
    d = g.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lane = tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (*o.T, *d.T))
    hit = _check_sweep(t.cells, lin, lane, eps=float(np.float32(EPS)))
    assert bool(hit.any())


def test_slot_tables_refuse_gaps():
    cells = _cells([[((0.0, 0.0, 0.0), 1.0, 1.0),
                     ((3.0, 0.0, 0.0), 1.0, 2.0)]])
    cells[0, 0, 4] = BIGID
    with pytest.raises(ValueError, match="front"):
        sd.slot_tables(cells)


# -- the lane queue: lanes are independent --------------------------------


def _planes(f, i, cfg):
    nf = sd._nf_d(cfg)
    return f.reshape(nf, -1), i.reshape(sd._NI_D, -1)


@pytest.mark.parametrize("n_iters", [7, 40])
@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_a_launch_in_two_bands_equals_the_whole(nee, n_iters):
    cfg = _CFG.replace(nee_lights=(8,)) if nee else _CFG
    scene = procedural_sphere_scene(300)
    tb = sd.build_stream_dda_tables(scene, cfg, device="cpu",
                                    occ_target=16.0)
    cam = mk.build_camera_vec(smallpt_camera(), cfg, "cpu")
    k0, k1 = rng.key_words(rng.base_key(21))
    f, i = sd.init_stream_dda_state(cfg, device="cpu")
    mk.set_sample_budget(i, 3, cfg)
    _, _, rays = sd.stream_step_dda_plain(tb, cam, cfg, k0, k1, f, i, n_iters)
    fw, iw = _planes(f, i, cfg)
    half, w = cfg.height // 2, cfg.width
    band_rays = 0
    for b in range(2):
        fb, ib = sd.init_stream_dda_state(cfg, n_rows=half, device="cpu")
        mk.set_sample_budget(ib, 3, cfg, n_rows=half)
        _, _, r = sd.stream_step_dda_plain(tb, cam, cfg, k0, k1, fb, ib,
                                           n_iters, row_offset=b * half,
                                           n_rows=half)
        band_rays += int(r)
        fb, ib = _planes(fb, ib, cfg)
        lanes = slice(b * half * w, (b + 1) * half * w)
        g = half * w
        assert torch.equal(_bits(fb[:, :g]), _bits(fw[:, lanes]))
        idle = (ib[2, :g] == 0) & (iw[2, lanes] == 0)
        for k, name in enumerate(mk._I_PLANES + sd._I_WALK_PLANES):
            differ = ib[k, :g] != iw[k, lanes]
            if name in ("depth", "sup"):
                differ &= ~idle
            assert not bool(differ.any()), name
    assert band_rays == int(rays) > 0
    if n_iters == 7:
        # the cap stops lanes mid-walk
        assert bool((iw[sd._I_WALK, :cfg.n_pixels] == 1).any())


def test_launch_refuses_a_negative_eps():
    """The kernel orders its candidates' t (> eps) as int32 bits, which
    holds for eps >= 0; its launcher refuses other tables before reaching
    for the card."""
    tb = sd.build_stream_dda_tables(procedural_sphere_scene(300), _CFG,
                                    device="cpu", occ_target=16.0)
    tb.eps_local = -1e-4
    cam = mk.build_camera_vec(smallpt_camera(), _CFG, "cpu")
    f, i = sd.init_stream_dda_state(_CFG, device="cpu")
    with pytest.raises(ValueError, match="eps_local >= 0"):
        sd._launch(tb, cam, _CFG, rng.base_key(0), f, i, 4)
