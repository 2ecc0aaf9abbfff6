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
         "smallpt_tpu_torch.engine.quality"}} <= set(names)
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
    # every submodule imported, the streaming route's among them
    assert int(proc.stdout.split()[-1]) >= 17


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
    assert "torch/extension.h" not in (PORT / "csrc" / "megakernel.cu"
                                       ).read_text()


def test_kernel_binding_sets_pointer_argtypes(monkeypatch):
    """ctypes without argtypes passes Python ints as 32-bit C ints and cuts
    device pointers; every argument of the launch is a void pointer."""
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.utils import nvcc

    fn = types.SimpleNamespace(argtypes=None, restype=None)
    sfn = types.SimpleNamespace(argtypes=None, restype=None)
    monkeypatch.setattr(nvcc, "load_library",
                        lambda name, src: types.SimpleNamespace(
                            smallpt_mega_pass=fn, smallpt_stream_step=sfn))
    assert mk._kernel_lib() is fn
    assert fn.argtypes == [ctypes.c_void_p] * 7
    assert fn.restype is ctypes.c_int
    assert mk._stream_lib() is sfn
    assert sfn.argtypes == [ctypes.c_void_p] * 8
    assert sfn.restype is ctypes.c_int


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
