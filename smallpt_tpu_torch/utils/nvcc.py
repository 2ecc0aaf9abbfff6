"""Build a CUDA source into a shared library with plain ``nvcc`` and load it
with ``ctypes``.

The kernels of this package have a plain ``extern "C"`` interface and do not
include PyTorch's headers, so one ``nvcc`` call builds each in seconds. The
library goes to ``smallpt_tpu_torch/_build/``, named by a hash of the source,
the ``csrc/`` headers it includes and the flags, and is built at first use
in each checkout. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"

# --fmad=false keeps every multiply and add a separately rounded op, in the
# order the JAX package and the plain PyTorch versions round them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> {"cmd": [...], "seconds": float, "ptxas": str} for each library
# built by this process (a library found already built is not listed)
builds: dict[str, dict] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME or $CUDA_PATH, then PATH, then the default
    toolkit location; raises with every place tried."""
    tried = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            tried.append(f"${var}/bin/nvcc = {cand}")
            if os.access(cand, os.X_OK):
                return cand
        else:
            tried.append(f"${var} (unset)")
    found = shutil.which("nvcc")
    tried.append("nvcc on PATH")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    tried.append(default)
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError("nvcc not found; tried: " + "; ".join(tried))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_digest(source: str) -> str:
    """Hash of ``csrc/<source>``, of every ``csrc/`` header it includes
    (followed through the headers' own includes), and of the flags: an edit
    to a shared header gives the library a new name."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        text = (CSRC_DIR / name).read_bytes()
        h.update(name.encode() + b"\0" + text)
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def _library_path(name: str, source: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_digest(source)}.so"


def build(libraries: dict[str, str]) -> None:
    """Build every library {name: source} not built yet, with one nvcc
    process per source, all started together; raises if one fails. Each
    build's command, seconds and ptxas report go to ``builds``."""
    todo = {n: s for n, s in libraries.items()
            if not _library_path(n, s).exists()}
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in todo.items():
        out = _library_path(name, source)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs[name] = (cmd, tmp, out, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, out, t0, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}: "
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        builds[name] = {"cmd": cmd, "seconds": time.perf_counter() - t0,
                        "ptxas": stderr.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (once per source hash) and load it."""
    if name in _loaded:
        return _loaded[name]
    build({name: source})
    lib = ctypes.CDLL(str(_library_path(name, source)))
    _loaded[name] = lib
    return lib
