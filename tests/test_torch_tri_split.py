"""K6's redesigned sweep (csrc/closest_tri.cu: the rows that can never be
a candidate left out as they are staged, the rows cut into ranges, the
partials and their merge in range order, several rays a thread), and the
staged test that decides each pair on dn and t first (measured on the
card and left out of the kernel: PERF.md, PR 15), emulated in plain
PyTorch and held bit for bit to the plain version they must equal,
ops/mesh_pallas.py::closest_tri_plain, on the CPU at toy sizes.

The emulation follows the kernel's design, not its code. The rays are
padded to whole blocks of 128 threads x rays_per_thread with the kernel's
finite dummy ray, thread k of a block holding rays k, k + 128, ... of it.
Each range of rows keeps its live rows in row order (valid, and n not
(0, 0, 0)) and folds them one row at a time from (3e38, row 0): the whole
test and the fold's <, as the kernel runs them, or the staged test: dn
first, the pair dropped where dn == 0; then inv and t, dropped unless
eps < t < bt (bt the ray's running best); then q, u, v and the
barycentric bounds, a survivor taken. The ranges' partials (t, row, u, v)
are folded in range order with the strict <. The cut is a parameter
(the kernel's own policy is not copied here): one range, one row a range,
ragged ranges, and whole 256-row chunks as the kernel cuts.

Gates: t, tri, u and v of every ray bit for bit (floats compared as
int32). The cases: duplicate triangles whose tie crosses a range boundary,
rays that hit nothing, rays parallel to every triangle (dn == 0), a t
exactly at eps, padding rows inside a range, n_rows below the table's
rows, and procedural_mesh_scene(60, seed=3) on camera and first-bounce
rays. A merge that takes ties (<=) must fail on the duplicates.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import procedural_mesh_scene
from smallpt_tpu_torch.engine.renderer import make_intersect_fn
from smallpt_tpu_torch.ops import mesh_pallas as mp

BIG = 3.0e38
BLOCK = 128  # the kernel's threads a block
CHUNK = 256  # the kernel's rows a staged chunk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad_rays(org, dirs, rays_per_thread: int):
    """The rays padded to whole blocks with the kernel's dummy ray (origin
    0, direction +x), in the order the kernel's threads hold them."""
    n = org.shape[1]
    per_block = BLOCK * rays_per_thread
    n_pad = -(-max(n, 1) // per_block) * per_block
    o = torch.zeros((3, n_pad), dtype=torch.float32)
    d = torch.zeros((3, n_pad), dtype=torch.float32)
    d[0] = 1.0
    o[:, :n], d[:, :n] = org, dirs
    return o, d


def _range_sweep(o, d, rows, ids, eps, classes, n_real, staged):
    """One unit's fold over its live rows (rows (R, 16) in row order, ids
    their table rows) from (3e38, row 0): tri_candidate's whole test and
    the fold's <, or (staged) the pair dropped on dn and t first and the
    rest of the test used only where it goes on (its u and v NaN
    elsewhere). The running best before each row is the least candidate t
    of the rows before it (the sequential fold's, by cummin); the winner is
    the last row taken. classes counts the pairs of the first n_real rays
    by where the staged test decides them: at dn, at t, by the whole
    test."""
    n = o.shape[1]
    if not rows.shape[0]:
        return (torch.full((n,), BIG), torch.zeros((n,), dtype=torch.int32),
                torch.zeros((n,)), torch.zeros((n,)))
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*o, *d))
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz) = (
        rows[:, k][None, :] for k in range(12))
    rx = ox - v0x
    ry = oy - v0y
    rz = oz - v0z
    dn = dx * nx + dy * ny + dz * nz
    one = torch.ones_like(dn)
    inv = one / torch.where(dn == 0.0, one, dn)
    t = -(nx * rx + ny * ry + nz * rz) * inv
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    u = -(qx * e2x + qy * e2y + qz * e2z) * inv
    v = (qx * e1x + qy * e1y + qz * e1z) * inv

    def inside(u, v):
        return (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & ((u + v) <= 1.0)

    cand = inside(u, v) & (dn != 0.0) & (t > eps)
    run = torch.cummin(torch.where(cand, t, BIG), dim=1).values
    before = torch.cat([torch.full((n, 1), BIG), run[:, :-1]], dim=1)
    at_t = (dn != 0.0) & ~((eps < t) & (t < before))
    go = (dn != 0.0) & ~at_t
    if staged:
        u = torch.where(go, u, float("nan"))
        v = torch.where(go, v, float("nan"))
        take = go & inside(u, v)
    else:
        take = cand & (t < before)
    last = (take * torch.arange(1, rows.shape[0] + 1)).amax(dim=1) - 1
    hit = last >= 0
    at = last.clamp(min=0)[:, None]
    classes["dn"] += int((dn == 0.0)[:n_real].sum())
    classes["t"] += int(at_t[:n_real].sum())
    classes["full"] += int(go[:n_real].sum())
    return (torch.where(hit, t.gather(1, at)[:, 0], BIG),
            torch.where(hit, ids.to(torch.int32)[last.clamp(min=0)], 0),
            torch.where(hit, u.gather(1, at)[:, 0], 0.0),
            torch.where(hit, v.gather(1, at)[:, 0], 0.0))


def split_sweep(org, dirs, table, n_rows, eps, bounds, rays_per_thread=2,
                strict=True, classes=None, staged=False):
    """The emulated K6 launch: (t, tri, u, v) for (3, N) ray planes over
    the first n_rows rows, the rows cut at ``bounds`` (0 = b0 < b1 < ... =
    n_rows), each pair through the whole test as the kernel runs it (or
    the staged test), merged in range order with the strict < (<= where
    not strict)."""
    n = org.shape[1]
    o, d = _pad_rays(org, dirs, rays_per_thread)
    classes = {"dn": 0, "t": 0, "full": 0} if classes is None else classes
    rows = table[:n_rows]
    live = (rows[:, 12] > 0.5) & (rows[:, 9:12] != 0.0).any(dim=1)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ids = torch.nonzero(live[lo:hi])[:, 0] + lo
        parts.append(_range_sweep(o, d, rows[ids], ids, eps, classes, n,
                                  staged))
    best = parts[0]
    for p in parts[1:]:
        take = p[0] < best[0] if strict else p[0] <= best[0]
        best = tuple(torch.where(take, a, b) for a, b in zip(p, best))
    return tuple(x[:n] for x in best)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _diff(got, want) -> list:
    """The rays on which each of t, tri, u, v differs in its bits."""
    return [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]


CUTS = {
    "one_range": lambda n: [0, n],
    "one_row_a_range": lambda n: list(range(n + 1)),
    "ragged": lambda n: sorted({0, n, *np.random.default_rng(n).integers(
        1, max(n, 2), 5).tolist()}),
    "chunks": lambda n: list(range(0, n, CHUNK)) + [n],
}


def _planes(o, d):
    return (torch.from_numpy(np.ascontiguousarray(o.T, np.float32)),
            torch.from_numpy(np.ascontiguousarray(d.T, np.float32)))


def _rays(n, seed, lo=(5, 5, 20), hi=(95, 75, 150)):
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _quad_table(n_quads: int, z: float, seed: int) -> torch.Tensor:
    """A table of n_quads unit squares (two triangles each) in the plane
    z = const, n along z, at seeded places, padded to 32 rows."""
    r = np.random.default_rng(seed)
    rows = []
    for x, y in r.uniform(0, 20, (n_quads, 2)):
        for e1, e2 in (((1, 0, 0), (1, 1, 0)), ((1, 1, 0), (0, 1, 0))):
            n = np.cross(e1, e2)
            rows.append([x, y, z, *e1, *e2, *n, 1, 0, 0, 0])
    t = np.zeros((-(-len(rows) // 32) * 32, 16), np.float32)
    t[:len(rows)] = rows
    return torch.from_numpy(t)


def _mesh60_rays(w=16, h=12):
    """procedural_mesh_scene(60, seed=3), its table, and its camera and
    first-bounce rays at w x h (one sample a pixel)."""
    scene = procedural_mesh_scene(60, seed=3)
    cfg = RenderConfig(width=w, height=h, camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    cam, bounce = chip_smoke.camera_and_bounce_rays(
        scene, cfg, smallpt_camera(), rng.fold_in(rng.base_key(0), 1001),
        make_intersect_fn(scene, cfg), "cpu")
    planes = [(o.T.contiguous(), d.T.contiguous()) for o, d in (cam, bounce)]
    return mp.build_tri_table(scene), planes


@pytest.fixture(scope="module")
def mesh60():
    return _mesh60_rays()


@pytest.mark.parametrize("rays", ["camera", "bounce"])
@pytest.mark.parametrize("cut,test", [
    ("one_range", "whole"), ("ragged", "whole"), ("chunks", "whole"),
    ("one_row_a_range", "whole"), ("one_range", "staged"),
    ("ragged", "staged"), ("chunks", "staged")])
def test_mesh60_every_cut(mesh60, rays, cut, test):
    """procedural_mesh_scene(60, seed=3) on camera and first-bounce rays:
    every cut gives closest_tri_plain's bits, with the whole test on every
    pair (the kernel) and with the staged test, which drops pairs at t and
    takes the rest through the whole test."""
    table, planes = mesh60
    org, dirs = planes[rays == "bounce"]
    n_rows = table.shape[0]
    classes = {"dn": 0, "t": 0, "full": 0}
    got = split_sweep(org, dirs, table, n_rows, 0.0, CUTS[cut](n_rows),
                      classes=classes, staged=test == "staged")
    want = mp.closest_tri_plain(org, dirs, table)
    assert _diff(got, want) == [0, 0, 0, 0], (cut, rays)
    assert classes["t"] and classes["full"], classes
    assert 0.3 < float((want[0] < BIG).float().mean())


@pytest.mark.parametrize("rays_per_thread", [1, 2, 4])
def test_rays_per_thread_and_ragged_block(rays_per_thread):
    """A ray count that fills no whole block: the dummy rays change no
    real ray's result, whatever the rays a thread."""
    table = mp.build_tri_table(procedural_mesh_scene(8, seed=1))
    org, dirs = _planes(*_rays(77, 3))
    n_rows = table.shape[0]
    got = split_sweep(org, dirs, table, n_rows, 0.0,
                      CUTS["ragged"](n_rows), rays_per_thread)
    assert _diff(got, mp.closest_tri_plain(org, dirs, table)) == [0] * 4


def _duplicated(table: torch.Tensor) -> torch.Tensor:
    """The live rows twice, the copy after the originals (and after a
    padding row), padded to 32 rows: every hit ties with its copy in a
    later range of any cut with a boundary between them."""
    live = table[table[:, 12] > 0.5]
    rows = torch.cat([live, torch.zeros((1, 16)), live])
    return torch.cat([rows, torch.zeros(((-rows.shape[0]) % 32, 16))])


@pytest.mark.parametrize("cut", ["ragged", "chunks", "one_row_a_range"])
def test_duplicate_tie_across_ranges(cut):
    """Each hit ties with its copy in a later range: the strict merge keeps
    the first row, as the sequential fold does, and every hit names an
    original row."""
    table = _duplicated(mp.build_tri_table(procedural_mesh_scene(8, seed=1)))
    org, dirs = _planes(*_rays(200, 4))
    n_rows = table.shape[0]
    bounds = CUTS[cut](n_rows)
    half = n_rows // 2
    if cut == "ragged":
        bounds = sorted(set(bounds) | {half})
    got = split_sweep(org, dirs, table, n_rows, 0.0, bounds)
    want = mp.closest_tri_plain(org, dirs, table)
    assert _diff(got, want) == [0] * 4
    hit = want[0] < BIG
    assert int(hit.sum()) > 20 and bool((want[1][hit] < half).all())


def test_nonstrict_merge_fails():
    """A merge that takes ties (<=) picks the later copy: tri differs
    from the sequential fold, t does not."""
    table = _duplicated(mp.build_tri_table(procedural_mesh_scene(8, seed=1)))
    org, dirs = _planes(*_rays(200, 4))
    n_rows = table.shape[0]
    got = split_sweep(org, dirs, table, n_rows, 0.0,
                      CUTS["chunks"](n_rows), strict=False)
    diff = _diff(got, mp.closest_tri_plain(org, dirs, table))
    assert diff[1] > 0 and diff[0] == 0


def test_rays_that_hit_nothing():
    """Rays from outside the scene pointing away: (3e38, 0, 0, 0) each,
    under every cut, though half their pairs reach the full test (no
    running best ever drops a pair beyond it)."""
    table = mp.build_tri_table(procedural_mesh_scene(8, seed=1))
    o, d = _rays(130, 6)
    o[:] = (50.0, 40.0, 1e4)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org, dirs = _planes(o, d)
    n_rows = table.shape[0]
    want = mp.closest_tri_plain(org, dirs, table)
    assert bool((want[0] == BIG).all()) and int(want[1].abs().sum()) == 0
    for cut in ("one_range", "chunks", "ragged"):
        classes = {"dn": 0, "t": 0, "full": 0}
        got = split_sweep(org, dirs, table, n_rows, 0.0, CUTS[cut](n_rows),
                          classes=classes)
        assert _diff(got, want) == [0] * 4, cut
        assert classes["full"] > 0


def test_rays_parallel_to_every_triangle():
    """Quads in a plane z = const and rays with dz = 0 exactly: dn == 0 on
    every pair, every ray a miss; rays that cross the plane hit."""
    table = _quad_table(40, 5.0, 7)
    o, d = _rays(150, 8, lo=(0, 0, 0), hi=(20, 20, 10))
    flat = np.arange(150) < 100
    d[flat, 2] = 0.0
    # the others from above a quad's corner, down across the plane
    o[~flat, :2] = table[:50, :2].numpy() + 0.25
    o[~flat, 2] = 9.0
    d[~flat] = (0.01, 0.02, -1.0)
    org, dirs = _planes(o, d)
    n_rows = table.shape[0]
    want = mp.closest_tri_plain(org, dirs, table)
    for staged in (False, True):
        classes = {"dn": 0, "t": 0, "full": 0}
        got = split_sweep(org, dirs, table, n_rows, 0.0,
                          CUTS["ragged"](n_rows), classes=classes,
                          staged=staged)
        assert _diff(got, want) == [0] * 4
        assert classes["dn"] == 100 * 80
    assert bool((want[0][:100] == BIG).all())
    assert bool((want[0][100:] < BIG).any())


def test_t_exactly_at_eps():
    """eps set to the t of a ray's winning pair: that pair is dropped at
    the t test (t > eps fails), and the ray takes its next hit or none,
    as the plain version does."""
    table = mp.build_tri_table(procedural_mesh_scene(8, seed=1))
    org, dirs = _planes(*_rays(200, 9))
    n_rows = table.shape[0]
    t0 = mp.closest_tri_plain(org, dirs, table)[0]
    eps = float(t0[t0 < BIG][3])
    want = mp.closest_tri_plain(org, dirs, table, eps=eps)
    assert bool((t0 == eps).any()) and not bool((want[0] == eps).any())
    for cut in ("one_range", "chunks", "one_row_a_range"):
        for staged in (False, True):
            got = split_sweep(org, dirs, table, n_rows, eps,
                              CUTS[cut](n_rows), staged=staged)
            assert _diff(got, want) == [0] * 4, (cut, staged)


def test_padding_rows_inside_a_range_and_n_rows_below_the_table():
    """Padding rows (valid 0) scattered through the table, and n_rows
    short of the table's rows (not on a chunk boundary): the rows past
    n_rows never win, a padding row never does."""
    table = mp.build_tri_table(procedural_mesh_scene(8, seed=1)).clone()
    r = np.random.default_rng(10)
    pad = torch.from_numpy(r.random(table.shape[0]) < 0.2)
    table[pad, 12] = 0.0
    org, dirs = _planes(*_rays(200, 11))
    for n_rows in (table.shape[0], 300, 77):
        want = mp.closest_tri_plain(org, dirs, table, n_rows)
        hit = want[0] < BIG
        assert bool((want[1][hit] < n_rows).all())
        assert not bool(pad[want[1][hit].long()].any())
        for cut in ("one_range", "ragged", "chunks"):
            got = split_sweep(org, dirs, table, n_rows, 0.0,
                              CUTS[cut](n_rows))
            assert _diff(got, want) == [0] * 4, (n_rows, cut)


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_bound_counts_the_emulated_decisions(mesh60, rays):
    """chip_smoke.py::k6_pairs, which prices K6's bound, counts the pairs
    the emulated sweep decides at dn, at t and by the full test, uncut,
    and the rows it leaves out as it stages them."""
    table, planes = mesh60
    org, dirs = planes[rays == "bounce"]
    classes = {"dn": 0, "t": 0, "full": 0}
    split_sweep(org, dirs, table, table.shape[0], 0.0,
                CUTS["one_range"](table.shape[0]), classes=classes)
    pairs = chip_smoke.k6_pairs(org, dirs, table)
    assert {k: pairs[k] for k in classes} == classes
    degenerate = (table[:, 9:12] == 0.0).all(dim=1) & (table[:, 12] > 0.5)
    assert pairs["left_out"] == table.shape[0] - pairs["live"] > int(
        degenerate.sum()) > 0
