"""Declarative JSON scene files: load and save SphereScene and MeshScene
(PyTorch port of smallpt_tpu/core/scene_io.py, the same format and the same
validation errors, so a file written by either package loads in the other
to equal arrays).

Format (version 1):

    {"format": "smallpt_tpu_scene", "version": 1,
     "type": "spheres",
     "spheres": [
       {"center": [x, y, z], "radius": r,
        "albedo": [r, g, b], "emission": [r, g, b], "refl": "DIFF"},
       ...]}

    {"format": "smallpt_tpu_scene", "version": 1,
     "type": "mesh",
     "positions": [[x,y,z], ...], "normals": [[x,y,z], ...],
     "indices": [[a,b,c], ...], "tri_inst": [i, ...],
     "materials": [{"albedo": [...], "emission": [...], "refl": "DIFF"},
                   ...]}     # one entry per instance id

``refl`` takes the reference's enum names (scene.h:64); ``emission``
(default black) and ``refl`` (default "DIFF") are optional per entry.
Floats are written as Python floats, whose binary64 holds every float32
value, so arrays round-trip exactly.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from smallpt_tpu_torch.core.scene import (
    DIFF, REFR, SPEC, Material, MeshScene, SphereScene,
)

_REFL_NAMES = {"DIFF": DIFF, "SPEC": SPEC, "REFR": REFR}
_REFL_TAGS = {v: k for k, v in _REFL_NAMES.items()}
FORMAT = "smallpt_tpu_scene"
VERSION = 1


def _refl_tag(name) -> int:
    if isinstance(name, str):
        try:
            return _REFL_NAMES[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown refl {name!r} (expected DIFF/SPEC/REFR)") from None
    tag = int(name)
    if tag not in _REFL_TAGS:
        raise ValueError(f"unknown refl tag {tag}")
    return tag


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _material_from_entries(entries, dtype) -> Material:
    emission = np.asarray([e.get("emission", (0.0, 0.0, 0.0))
                           for e in entries], np.float64)
    albedo = np.asarray([e.get("albedo", (0.0, 0.0, 0.0)) for e in entries],
                        np.float64)
    refl = [_refl_tag(e.get("refl", "DIFF")) for e in entries]
    if emission.shape != (len(entries), 3) or albedo.shape != (len(entries),
                                                               3):
        raise ValueError("emission/albedo must be [r, g, b] triples")
    return Material(emission=_tensor(emission, dtype),
                    albedo=_tensor(albedo, dtype),
                    refl=torch.tensor(refl, dtype=torch.int32))


def scene_from_dict(spec: dict, dtype=torch.float32):
    """Lower a parsed scene spec to a scene of CPU tensors. Raises
    ValueError (or KeyError for a missing mesh field) on a malformed
    spec."""
    if not isinstance(spec, dict):
        raise ValueError("scene spec must be a JSON object")
    if spec.get("format", FORMAT) != FORMAT:
        raise ValueError(f"not a {FORMAT} file: format={spec.get('format')!r}")
    version = spec.get("version", VERSION)
    if version != VERSION:
        raise ValueError(f"unsupported scene version {version}")
    kind = spec.get("type")
    if kind == "spheres":
        entries = spec.get("spheres")
        if not entries:
            raise ValueError("spheres scene needs a non-empty 'spheres' list")
        centers = np.asarray([e["center"] for e in entries], np.float64)
        radii = np.asarray([e["radius"] for e in entries], np.float64)
        if centers.shape != (len(entries), 3):
            raise ValueError("sphere centers must be [x, y, z]")
        if not (np.isfinite(radii).all() and (radii > 0).all()):
            raise ValueError("sphere radii must be finite and > 0")
        return SphereScene(center=_tensor(centers, dtype),
                           radius=_tensor(radii, dtype),
                           material=_material_from_entries(entries, dtype))
    if kind == "mesh":
        positions = np.asarray(spec["positions"], np.float64)
        normals = np.asarray(spec["normals"], np.float64)
        indices = np.asarray(spec["indices"], np.int64)
        materials = spec["materials"]
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError("positions must be (V, 3)")
        if normals.shape != positions.shape:
            raise ValueError("normals must match positions' shape")
        if indices.ndim != 2 or indices.shape[1] != 3:
            raise ValueError("indices must be (T, 3)")
        if indices.size and (indices.min() < 0
                             or indices.max() >= positions.shape[0]):
            raise ValueError("indices out of range")
        tri_inst = np.asarray(spec.get("tri_inst", np.zeros(indices.shape[0])),
                              np.int64)
        if tri_inst.shape != (indices.shape[0],):
            raise ValueError("tri_inst must be (T,)")
        if tri_inst.size and (tri_inst.min() < 0
                              or tri_inst.max() >= len(materials)):
            raise ValueError("tri_inst out of range of materials")
        return MeshScene(positions=_tensor(positions, dtype),
                         normals=_tensor(normals, dtype),
                         indices=_tensor(indices, torch.int32),
                         tri_inst=_tensor(tri_inst, torch.int32),
                         material=_material_from_entries(materials, dtype))
    raise ValueError(f"unknown scene type {kind!r} (expected spheres|mesh)")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _material_entries(mat: Material):
    emission = _np(mat.emission).astype(np.float64)
    albedo = _np(mat.albedo).astype(np.float64)
    refl = _np(mat.refl)
    return [{"albedo": albedo[i].tolist(), "emission": emission[i].tolist(),
             "refl": _REFL_TAGS[int(refl[i])]}
            for i in range(refl.shape[0])]


def scene_to_dict(scene) -> dict:
    """Serialize a scene back to the JSON spec (exact for float32 values:
    binary64 JSON numbers hold every one)."""
    if isinstance(scene, SphereScene):
        centers = _np(scene.center).astype(np.float64)
        radii = _np(scene.radius).astype(np.float64)
        mats = _material_entries(scene.material)
        return {
            "format": FORMAT, "version": VERSION, "type": "spheres",
            "spheres": [{"center": centers[i].tolist(),
                         "radius": float(radii[i]), **mats[i]}
                        for i in range(radii.shape[0])],
        }
    if isinstance(scene, MeshScene):
        return {
            "format": FORMAT, "version": VERSION, "type": "mesh",
            "positions": _np(scene.positions).astype(np.float64).tolist(),
            "normals": _np(scene.normals).astype(np.float64).tolist(),
            "indices": _np(scene.indices).tolist(),
            "tri_inst": _np(scene.tri_inst).tolist(),
            "materials": _material_entries(scene.material),
        }
    raise TypeError(f"cannot serialize {type(scene).__name__}")


def load_scene(path: str, dtype=torch.float32):
    with open(path) as f:
        return scene_from_dict(json.load(f), dtype=dtype)


def save_scene(scene, path: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene), f)
        f.write("\n")
