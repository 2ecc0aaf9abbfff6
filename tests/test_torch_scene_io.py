"""Scene files (core/scene_io.py) against the JAX package's: the same
format, bit-exact round trips within the port and across the packages
(a file written by either loads in the other to equal arrays), the same
validation errors, and --scene-file through the port's CLI. No JAX
program is compiled: the JAX side only parses and writes."""

import json

import numpy as np
import pytest
import torch

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.core import scene_io as jio
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core import scene_io as tio
from smallpt_tpu_torch.utils import image as img_io

_SCENES = {
    "cornell": (jscene.cornell_box_scene, tscene.cornell_box_scene),
    "two_sphere": (jscene.two_sphere_scene, tscene.two_sphere_scene),
    "triangle": (jscene.single_triangle_scene, tscene.single_triangle_scene),
    "mesh2": (lambda: jscene.procedural_mesh_scene(2, subdiv_longitude=3),
              lambda: tscene.procedural_mesh_scene(2, subdiv_longitude=3)),
}


def _leaves(scene):
    out = []
    for x in scene:
        out += _leaves(x) if isinstance(x, tuple) else [np.asarray(x)]
    return out


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _tensors(scene):
    out = []
    for x in scene:
        out += _tensors(x) if isinstance(x, tuple) else [x]
    return out


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_roundtrip_within_the_port_is_bit_exact(name, tmp_path):
    scene = _SCENES[name][1]()
    path = str(tmp_path / "s.json")
    tio.save_scene(scene, path)
    loaded = tio.load_scene(path)
    assert type(loaded) is type(scene)
    for a, b in zip(_tensors(scene), _tensors(loaded), strict=True):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="cannot serialize"):
        tio.scene_to_dict(object())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(_SCENES))
def test_files_load_in_the_other_package(name, writer, tmp_path):
    js, ts = (f() for f in _SCENES[name])
    path = str(tmp_path / "s.json")
    if writer == "jax":
        jio.save_scene(js, path)
        got = tio.load_scene(path)
        _assert_same(type(js)(*_numpy(js)), type(js)(*_numpy(got)))
    else:
        tio.save_scene(ts, path)
        got = jio.load_scene(path)
        _assert_same(type(js)(*_numpy(js)), type(js)(*_numpy(got)))
    # the two packages write the same text for the same scene
    assert json.dumps(jio.scene_to_dict(js)) == json.dumps(
        tio.scene_to_dict(ts))


def _numpy(scene):
    return [tuple(np.asarray(y) for y in x) if isinstance(x, tuple)
            else np.asarray(x) for x in scene]


_BASE = {"format": "smallpt_tpu_scene", "version": 1}
_BAD = {
    "format": {"format": "other", "type": "spheres"},
    "version": {**_BASE, "version": 99, "type": "spheres"},
    "type": {**_BASE, "type": "nurbs"},
    "non-empty": {**_BASE, "type": "spheres", "spheres": []},
    "radii": {**_BASE, "type": "spheres",
              "spheres": [{"center": [0, 0, 0], "radius": -1}]},
    "refl": {**_BASE, "type": "spheres",
             "spheres": [{"center": [0, 0, 0], "radius": 1,
                          "refl": "GLOSSY"}]},
    "centers": {**_BASE, "type": "spheres",
                "spheres": [{"center": [0, 0], "radius": 1}]},
    "indices": {**_BASE, "type": "mesh", "positions": [[0, 0, 0]],
                "normals": [[0, 0, 1]], "indices": [[0, 1, 2]],
                "materials": [{"albedo": [1, 1, 1]}]},
    "tri_inst": {**_BASE, "type": "mesh",
                 "positions": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                 "normals": [[0, 0, 1]] * 3, "indices": [[0, 1, 2]],
                 "tri_inst": [3], "materials": [{"albedo": [1, 1, 1]}]},
    "triples": {**_BASE, "type": "spheres",
                "spheres": [{"center": [0, 0, 0], "radius": 1,
                             "albedo": [1, 1]}]},
}


@pytest.mark.parametrize("what", sorted(_BAD))
def test_validation_errors_match_jax(what):
    spec = _BAD[what]
    with pytest.raises(ValueError) as want:
        jio.scene_from_dict(spec)
    with pytest.raises(ValueError) as got:
        tio.scene_from_dict(spec)
    assert str(got.value) == str(want.value)
    assert what in str(got.value)


def test_handwritten_spec_loads_as_the_jax_package_loads_it():
    spec = {**_BASE, "type": "spheres", "spheres": [
        {"center": [50, 40.8, 81.6], "radius": 20,
         "albedo": [0.75, 0.25, 0.25]},
        {"center": [50, 681.33, 81.6], "radius": 600,
         "emission": [12, 12, 12], "refl": "spec"}]}
    got, want = tio.scene_from_dict(spec), jio.scene_from_dict(spec)
    _assert_same(type(want)(*_numpy(want)), type(want)(*_numpy(got)))
    assert got.material.refl.tolist() == [tscene.DIFF, tscene.SPEC]
    assert got.center.dtype == torch.float32


def test_cli_scene_file(tmp_path, monkeypatch):
    """--scene-file renders the file's scene byte-equal to the built-in
    scene it holds; the intersector default comes from the resolved scene
    (a mesh file of 64 triangles or more takes the triangle kernel)."""
    path = str(tmp_path / "cornell.json")
    tio.save_scene(tscene.cornell_box_scene(), path)
    common = ["4", "--width", "8", "--height", "6", "--max-depth", "4",
              "--device", "cpu", "--quiet"]
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    assert cli.main(common + ["--scene-file", path, "--out", a]) == 0
    assert cli.main(common + ["--scene", "cornell", "--out", b]) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    tri = str(tmp_path / "tri.json")
    tio.save_scene(tscene.single_triangle_scene(), tri)
    out = str(tmp_path / "tri.ppm")
    assert cli.main(common + ["--scene-file", tri, "--mode", "normal",
                              "--out", out]) == 0
    assert img_io.read_ppm(out).shape == (6, 8, 3)
    made = []
    real = cli.ProgressiveRenderer
    monkeypatch.setattr(cli, "ProgressiveRenderer",
                        lambda *a, **k: made.append(a[2]) or real(*a, **k))
    mesh = str(tmp_path / "mesh.json")
    tio.save_scene(_SCENES["mesh2"][1](), mesh)
    assert tio.load_scene(mesh).n_triangles >= 64
    assert cli.main(common + ["--scene-file", mesh, "--scheduler", "flat",
                              "--out", out]) == 0
    assert made[-1].intersector == cli.Intersector.PALLAS
