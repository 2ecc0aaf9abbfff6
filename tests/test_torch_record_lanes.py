"""K1b's redesign (csrc/megakernel.cu's recording kernel on the lane queue),
emulated in plain PyTorch and held bit for bit to the plain version it must
equal, ops/megakernel.py::record_pass_plain, on the CPU at toy sizes.

- The lane queue's premise: a recording lane's radiance, rays and winners
  depend on its own sample and the launch's arguments alone, so the band
  run in any split of its rows (1 row, 3 rows, ragged), the parts in any
  order, gives the whole launch's outputs; and one launch over a band's k
  in-pixel samples, lane = pixel * k + s, gives the per-sample launches'
  outputs in the replay's FLAT lane order (the stack and reshape the
  recorder made before), its radiance summed over s in order.
- The winner plane's stores: a lane is live at iteration t exactly while t
  < its rays (one sample, one ray a bounce), at depth t. The kernel's two
  ways of writing the plane from the sweeps' winners, -1 everywhere first
  and then only the hits (kFillPlane), or every bounce's winner and -1 at
  each depth the path never reached, both give the plain plane.
- K1's own sphere test (k1_tt, emulated in tests/test_torch_mega_lanes.py)
  against the whole test as int32 on the record's own sweeps and shadow
  sweeps: Cornell, Cornell with the thin lens and the environment light,
  with NEE on the light, and 2,048 spheres.
- The bound's counts: the record's tests by class cover every live ray.
"""

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.ops import megakernel as mk
from test_torch_mega_lanes import _held

_CFG = RenderConfig(width=12, height=13, spp_per_cell=1, max_depth=10,
                    camera_model=CameraModel.LEGACY, filter=Filter.TENT)
_CASES = {
    "cornell": (cornell_box_scene, _CFG),
    "cornell_lens_env": (cornell_box_scene, _CFG.replace(
        aperture=4.0, focal_distance=120.0, env_emission=(0.2, 0.3, 0.4))),
    "cornell_nee": (cornell_box_scene, _CFG.replace(nee_lights=(8,))),
    "procedural2048": (lambda: procedural_sphere_scene(2048), _CFG.replace(
        width=6, height=5, max_depth=6)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _inputs(name):
    make, cfg = _CASES[name]
    scene = make()
    # the rows the kernel sweeps: the scene's, not the table's padding
    table = mk.build_scene_table(scene, cfg)[:scene.n_spheres].contiguous()
    cam = mk.build_camera_vec(smallpt_camera(), cfg)
    return scene, cfg, table, cam, rng.key_words(rng.base_key(17))


def _record(table, cam, cfg, kw, ip_offset=0, row_offset=0, n_rows=None,
            **extra):
    return mk.record_pass_plain(table, cam, cfg, *kw, ip_offset, row_offset,
                                n_rows, n_spheres=table.shape[0], **extra)


def _equal(got, want):
    rad, rays, rec = got
    assert torch.equal(_bits(rad), _bits(want[0]))
    assert torch.equal(rays, want[1])
    assert torch.equal(rec, want[2])


# -- the lane queue's premise ----------------------------------------------


@pytest.mark.parametrize("split", ["rows1", "rows3", "ragged"])
@pytest.mark.parametrize("name", ["cornell", "cornell_nee"])
def test_bands_in_any_order_equal_the_whole(name, split):
    scene, cfg, table, cam, kw = _inputs(name)
    whole = _record(table, cam, cfg, kw, ip_offset=2)
    cuts = {"rows1": list(range(cfg.height + 1)),
            "rows3": list(range(0, cfg.height, 3)) + [cfg.height],
            "ragged": [0, 5, 6, 11, cfg.height]}[split]
    bands = list(zip(cuts[:-1], cuts[1:]))
    order = np.random.default_rng(len(bands)).permutation(len(bands))
    parts = {}
    for b in order:
        lo, hi = bands[b]
        parts[b] = _record(table, cam, cfg, kw, ip_offset=2, row_offset=lo,
                           n_rows=hi - lo)
    got = [torch.cat([parts[b][k] for b in range(len(bands))],
                     dim=1 if k == 2 else 0) for k in range(3)]
    _equal(got, whole)


@pytest.mark.parametrize("k,band", [(1, None), (4, None), (2, (4, 6)),
                                    (3, (7, 13))])
def test_k_samples_in_one_launch_equal_the_stacked_launches(k, band):
    """One launch over k samples, ip_offset 1.. , against one launch a
    sample stacked and reshaped to FLAT order; the recorder's image sums
    the lanes' radiance over s in order, as it summed the launches'."""
    scene, cfg, table, cam, kw = _inputs("cornell_lens_env")
    lo, hi = band or (0, cfg.height)
    got = _record(table, cam, cfg, kw, 1, lo, hi - lo, k_samples=k)
    per = [_record(table, cam, cfg, kw, 1 + s, lo, hi - lo)
           for s in range(k)]
    g = (hi - lo) * cfg.width
    want = (torch.stack([p[0] for p in per], dim=1).reshape(g * k, 3),
            torch.stack([p[1] for p in per], dim=1).reshape(g * k),
            torch.stack([p[2] for p in per], dim=2).reshape(
                cfg.max_depth, g * k))
    _equal(got, want)
    img, winners, rays = mk.render_record_megakernel(
        scene, smallpt_camera(), cfg, rng.base_key(17), ip_offset=1,
        row_offset=lo, n_rows=hi - lo, k_samples=k, device="cpu")
    total = torch.zeros((g, 3))
    for p in per:
        total = total + p[0]
    assert torch.equal(_bits(img.reshape(g, 3)), _bits(total))
    assert torch.equal(winners, want[2])
    assert int(rays) == int(want[1].sum())


# -- the winner plane's stores ------------------------------------------------


def _sweep_winners(table, cam, cfg, kw, k_samples=1):
    """The plain version's outputs and the winners of its closest-hit
    sweeps, one (lanes,) tensor an iteration."""
    seen, real = [], mk._sweep

    def spy(ox, oy, oz, dx, dy, dz, cols, skip=None):
        bt, bi = real(ox, oy, oz, dx, dy, dz, cols, skip)
        if skip is None:
            seen.append(bi.clone())
        return bt, bi

    mk._sweep = spy
    try:
        out = _record(table, cam, cfg, kw, k_samples=k_samples)
    finally:
        mk._sweep = real
    return out, seen


@pytest.mark.parametrize("fill", [True, False], ids=["fill", "per_depth"])
@pytest.mark.parametrize("name,k", [("cornell", 1), ("cornell_nee", 3),
                                    ("cornell_lens_env", 2)])
def test_the_kernels_plane_stores_give_the_plain_plane(name, k, fill):
    scene, cfg, table, cam, kw = _inputs(name)
    (_, rays, want), winners = _sweep_winners(table, cam, cfg, kw, k)
    n = rays.shape[0]
    lane = torch.arange(n)
    rays = rays.long()
    plane = torch.full((cfg.max_depth, n), -1 if fill else 7,
                       dtype=torch.int32)
    for t, bi in enumerate(winners):
        live = rays > t
        store = live & (bi >= 0) if fill else live
        plane[t, lane[store]] = bi[store].to(torch.int32)
    if not fill:
        for d in range(cfg.max_depth):
            plane[d, lane[rays <= d]] = -1
    assert torch.equal(plane, want)
    # the fill form stores the hits, the per-depth form every entry
    assert 0 < int((want >= 0).sum()) <= int(rays.sum()) < want.numel()


# -- K1's sphere test on the record's sweeps --------------------------------


@pytest.mark.parametrize("name", sorted(_CASES))
def test_k1_test_equals_the_whole_test_on_the_record_sweeps(name):
    scene, cfg, table, cam, kw = _inputs(name)
    cols = table[:, :5]
    seen, real = [], mk._sweep

    def spy(ox, oy, oz, dx, dy, dz, c, skip=None):
        seen.append((ox, oy, oz, dx, dy, dz))
        return real(ox, oy, oz, dx, dy, dz, c, skip)

    mk._sweep = spy
    try:
        _record(table, cam, cfg, kw, k_samples=2)
    finally:
        mk._sweep = real
    miss = inside = 0
    for lane in seen:
        m, i = _held(lane, cols)
        miss, inside = miss + m, inside + i
    # the early miss and the inside path are both taken (2,048 spheres:
    # some rays start inside a sphere)
    assert miss > 0 and inside > 0


# -- the bound's counts -------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "cornell_nee"])
def test_record_counts_cover_every_live_ray(name):
    scene, cfg, table, cam, kw = _inputs(name)
    counts = {}
    _, rays, _ = _record(table, cam, cfg, kw, k_samples=2, counts=counts)
    total = sum(counts[f"pairs_{c}"] for c in mk.PAIR_CLASSES)
    assert total == int(rays.sum()) * scene.n_spheres
    assert counts["iterations"] <= cfg.max_depth
    assert (counts.get("shadow_rays", 0) > 0) == name.endswith("_nee")
