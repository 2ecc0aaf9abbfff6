"""Build a CUDA source into a shared library with plain ``nvcc`` and load it
with ``ctypes``.

The kernels of this package have a plain ``extern "C"`` interface and do not
include PyTorch's headers, so one ``nvcc`` call builds each in seconds. The
library goes to ``smallpt_tpu_torch/_build/``, named by a hash of the source
and the flags, and is built at first use in each checkout. Nothing is
compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def load_library(name: str, source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (once per source hash) and load it."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}_{digest}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        builds[name] = {"cmd": cmd, "seconds": time.perf_counter() - t0,
                        "ptxas": proc.stderr.strip()}
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
