"""The port stands alone: smallpt_tpu_torch and chip_smoke.py import with
JAX and the JAX package blocked, name neither in an import, keep their work
out of import time, and guard the kernel's build and ctypes binding."""

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "smallpt_tpu_torch"

_BLOCKED_IMPORTS = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["smallpt_tpu"] = None
sys.path.insert(0, {root!r})
import importlib, pkgutil
import smallpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(smallpt_tpu_torch.__path__,
                                               "smallpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {{"smallpt_tpu_torch.engine.streaming",
         "smallpt_tpu_torch.engine.quality",
         "smallpt_tpu_torch.engine.mesh_stream",
         "smallpt_tpu_torch.engine.binned",
         "smallpt_tpu_torch.ops.accel",
         "smallpt_tpu_torch.ops.mesh_accel",
         "smallpt_tpu_torch.ops.stream_dda",
         "smallpt_tpu_torch.ops.intersect",
         "smallpt_tpu_torch.ops.intersect_pallas",
         "smallpt_tpu_torch.ops.mesh_pallas",
         "smallpt_tpu_torch.ops.wavefront",
         "smallpt_tpu_torch.grad.diff",
         "smallpt_tpu_torch.grad.replay",
         "smallpt_tpu_torch.ops.dda",
         "smallpt_tpu_torch.core.scene_io",
         "smallpt_tpu_torch.interactive",
         "smallpt_tpu_torch.utils.native",
         "smallpt_tpu_torch.parallel",
         "smallpt_tpu_torch.parallel.shard",
         "smallpt_tpu_torch.parallel.stream_shard",
         "smallpt_tpu_torch.parallel.binned_shard",
         "smallpt_tpu_torch.parallel.replay_shard",
         "smallpt_tpu_torch.parallel.distributed"}} <= set(names)
from smallpt_tpu_torch.utils import nvcc
# importing every module (K8's wrapper and stream_binned.cu's library
# among them) builds and loads no kernel
assert not nvcc.builds and not nvcc._loaded
import chip_smoke
assert callable(chip_smoke.main)
assert not any(k.startswith("jax") and sys.modules[k] is not None
               for k in sys.modules)
print(len(names))
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    # every submodule imported, the streaming, wavefront, mesh streaming
    # and binned routes', K4's, the host surfaces' and the multi-device
    # modules among them
    assert int(proc.stdout.split()[-1]) >= 38


def _sources():
    # _build/ holds build outputs, never source
    files = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    return files


def test_no_jax_or_smallpt_tpu_imports():
    # "smallpt_tpu" followed by "_torch" has no word boundary: not matched
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|smallpt_tpu)\b", re.M)
    dotted = re.compile(r"\bsmallpt_tpu\.\w")
    for path in _sources():
        text = path.read_text()
        assert not bad.search(text), path
        code = [ln for ln in text.splitlines()
                if re.match(r"\s*(import|from)\s", ln)]
        assert not any(dotted.search(ln) for ln in code), path


def test_nothing_built_or_launched_at_import():
    for path in _sources():
        text = path.read_text()
        top = [ln for ln in text.splitlines()
               if re.match(r"(import|from)\s", ln)]
        assert not any("triton" in ln or "cpp_extension" in ln
                       for ln in top), path
    for src in (PORT / "csrc").iterdir():
        assert "torch/extension.h" not in src.read_text(), src


def test_kernel_binding_sets_pointer_argtypes(monkeypatch):
    """ctypes without argtypes passes Python ints as 32-bit C ints and cuts
    device pointers; every argument of the launch is a void pointer."""
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.utils import nvcc

    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.ops import stream_dda as sd

    fn = types.SimpleNamespace(argtypes=None, restype=None)
    mpfn = types.SimpleNamespace(argtypes=None, restype=None)
    rfn = types.SimpleNamespace(argtypes=None, restype=None)
    sfn = types.SimpleNamespace(argtypes=None, restype=None)
    dfn = types.SimpleNamespace(argtypes=None, restype=None)
    dpfn = types.SimpleNamespace(argtypes=None, restype=None)
    hfn = types.SimpleNamespace(argtypes=None, restype=None)
    hpfn = types.SimpleNamespace(argtypes=None, restype=None)
    tfn = types.SimpleNamespace(argtypes=None, restype=None)
    tpfn = types.SimpleNamespace(argtypes=None, restype=None)
    cfn = types.SimpleNamespace(argtypes=None, restype=None)
    bfn = types.SimpleNamespace(argtypes=None, restype=None)
    bwfn = types.SimpleNamespace(argtypes=None, restype=None)
    kfn = types.SimpleNamespace(argtypes=None, restype=None)
    kpfn = types.SimpleNamespace(argtypes=None, restype=None)
    xfn = types.SimpleNamespace(argtypes=None, restype=None)
    xpfn = types.SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(nvcc, "load_library",
                        lambda name, src: types.SimpleNamespace(
                            smallpt_mega_pass=fn, smallpt_mega_plan=mpfn,
                            smallpt_mega_record=rfn,
                            smallpt_stream_step=sfn,
                            smallpt_stream_dda=dfn,
                            smallpt_stream_dda_plan=dpfn,
                            smallpt_closest_hit=hfn,
                            smallpt_closest_hit_plan=hpfn,
                            smallpt_closest_tri=tfn,
                            smallpt_closest_tri_plan=tpfn,
                            smallpt_closest_tri_culled=cfn,
                            smallpt_stream_binned=bfn,
                            smallpt_stream_binned_scratch_words=bwfn,
                            smallpt_dda=kfn, smallpt_dda_plan=kpfn,
                            smallpt_closest_hit_mxu=xfn,
                            smallpt_closest_hit_mxu_plan=xpfn))
    assert mk._kernel_lib() is fn
    assert fn.argtypes == [ctypes.c_void_p] * 8
    assert fn.restype is ctypes.c_int
    assert mk._plan_lib() is mpfn
    assert mpfn.argtypes == [ctypes.c_int] * 4 + [ctypes.c_void_p]
    assert mpfn.restype is ctypes.c_int
    assert mk._record_lib() is rfn
    assert rfn.argtypes == [ctypes.c_void_p] * 9
    assert rfn.restype is ctypes.c_int
    assert mk._stream_lib() is sfn
    assert sfn.argtypes == [ctypes.c_void_p] * 9
    assert sfn.restype is ctypes.c_int
    assert sd._dda_lib() == (dfn, dpfn)
    assert dfn.argtypes == [ctypes.c_void_p] * 15
    assert dfn.restype is ctypes.c_int
    assert dpfn.argtypes == [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert dpfn.restype is ctypes.c_int
    assert ip._kernel_lib() == (hfn, hpfn)
    assert hfn.argtypes == [ctypes.c_void_p] * 8
    assert hfn.restype is ctypes.c_int
    assert hpfn.argtypes == [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert hpfn.restype is ctypes.c_int
    assert mp._kernel_lib() == (tfn, tpfn)
    assert tfn.argtypes == [ctypes.c_void_p] * 11
    assert tfn.restype is ctypes.c_int
    assert tpfn.argtypes == [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    assert tpfn.restype is ctypes.c_int
    assert mp._culled_lib() is cfn
    assert cfn.argtypes == [ctypes.c_void_p] * 17
    assert cfn.restype is ctypes.c_int
    assert mk._binned_lib() == (bfn, bwfn)
    assert bfn.argtypes == [ctypes.c_void_p] * 13
    assert bfn.restype is ctypes.c_int
    assert bwfn.argtypes == [ctypes.c_int, ctypes.c_int]
    assert bwfn.restype is ctypes.c_longlong
    assert dda._kernel_lib() == (kfn, kpfn)
    assert kfn.argtypes == [ctypes.c_void_p] * 13
    assert kfn.restype is ctypes.c_int
    assert kpfn.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert kpfn.restype is ctypes.c_int
    assert ip._mxu_lib() == (xfn, xpfn)
    assert xfn.argtypes == [ctypes.c_void_p] * 10
    assert xfn.restype is ctypes.c_int
    assert xpfn.argtypes == [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert xpfn.restype is ctypes.c_int


def test_build_key_covers_included_headers(monkeypatch, tmp_path):
    """The library's name hashes the source and every csrc/ header it
    includes, through the headers' own includes: an edit to lane.cuh gives
    every kernel a new library, an edit to tri.cuh the two triangle
    kernels', an edit to one source only its own."""
    from smallpt_tpu_torch.utils import nvcc

    for src in (PORT / "csrc").iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(nvcc, "CSRC_DIR", tmp_path)
    tri = ("closest_tri.cu", "closest_tri_culled.cu")
    start = {s: nvcc.source_digest(s) for s in (
        "megakernel.cu", "stream_dda.cu", "closest_hit.cu",
        "stream_binned.cu", "dda.cu", "closest_hit_mxu.cu", *tri)}
    with open(tmp_path / "tri.cuh", "a") as f:
        f.write("\n// an edit\n")
    before = {s: nvcc.source_digest(s) for s in start}
    assert all((before[s] != start[s]) == (s in tri) for s in start)
    assert b'#include "lane.cuh"' in (tmp_path / "stream_dda.cu").read_bytes()
    assert b'#include "lane.cuh"' in (tmp_path / "dda.cu").read_bytes()
    assert b'#include "lane.cuh"' in (
        tmp_path / "closest_hit_mxu.cu").read_bytes()
    with open(tmp_path / "lane.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = {s: nvcc.source_digest(s) for s in before}
    assert all(after[s] != before[s] for s in before)
    with open(tmp_path / "stream_dda.cu", "a") as f:
        f.write("\n// an edit\n")
    assert nvcc.source_digest("megakernel.cu") == after["megakernel.cu"]
    assert nvcc.source_digest("stream_dda.cu") != after["stream_dda.cu"]


def test_build_starts_every_nvcc_before_waiting(monkeypatch, tmp_path):
    """nvcc.build runs one nvcc per source, all started together, and
    raises with the failing command's output."""
    from smallpt_tpu_torch.utils import nvcc

    events = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.cmd, self.returncode = cmd, 0
            events.append(("start", cmd[-1]))

        def communicate(self, timeout=None):
            events.append(("wait", self.cmd[-1]))
            if "stream_dda" in self.cmd[-1]:
                self.returncode = 1
                return "", "error: a fault"
            pathlib.Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"")
            return "", "ptxas info    : Used 64 registers"

    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    with pytest.raises(RuntimeError, match="a fault"):
        nvcc.build({"a": "megakernel.cu", "b": "stream_dda.cu"})
    assert [e[0] for e in events] == ["start", "start", "wait", "wait"]
    assert nvcc.builds["a"]["ptxas"].endswith("64 registers")
    assert nvcc._library_path("a", "megakernel.cu").exists()
    assert not nvcc._library_path("b", "stream_dda.cu").exists()


def test_find_nvcc_reports_every_place_tried(monkeypatch, tmp_path):
    from smallpt_tpu_torch.utils import nvcc

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError) as err:
        nvcc.find_nvcc()
    msg = str(err.value)
    for part in ("CUDA_HOME", "CUDA_PATH", "PATH", "/usr/local/cuda/bin/nvcc"):
        assert part in msg
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(os, "access", lambda path, mode: path == str(fake))
    assert nvcc.find_nvcc() == str(fake)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    """No CUDA device (this machine), or a directory holding chip_smoke.py
    and nothing else of the repository: exit non-zero, print no result."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=str(cwd), env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
