"""Build a CUDA or C++ source of this package into a shared library at first
use.

``load("phase")`` compiles ``csrc/phase.cu`` with ``nvcc`` for Hopper
(``sm_90a``) into ``_build/phase-<hash>.so`` beside the sources, keyed by a
hash of the source, the headers of ``csrc/``, the flags and the defines
(``load("phase", defines=("PAMG_CHECKED",))`` builds the checked variant
into a library of its own), and loads it with ``ctypes``.  The library
has a plain C interface, so no PyTorch headers are compiled.
``load_host("mesh_accel")`` builds the host library ``csrc/mesh_accel.cpp``
the same way with the C++ compiler ``CXX``.  Processes that find a library
missing at once build it once, under a file lock.  There is no fallback:
a missing compiler or a failed build raises with the compiler's output.
Each load is the set-up stage ``pamg.setup.kernels``, counted in
``kernel_loads``, and each build that ran the compiler in
``kernel_builds`` (``utils.tracing``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from . import tracing

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX = "c++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda):"
                       " the CUDA kernels cannot be built")


def load(name: str, defines: tuple = ()):
    """Build (unless built already) and load ``csrc/<name>.cu``, with
    ``-D<define>`` for each of ``defines``.

    Returns (ctypes.CDLL, info) with info = {"path", "seconds", "cached",
    "log"}: the library path, the build's wall time (0 when cached) and
    the compiler's output, which includes ``-Xptxas -v``'s register and
    spill report.
    """
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    return _load(name, SRC_DIR / f"{name}.cu",
                 sorted(SRC_DIR.glob("*.cuh")), flags, nvcc_path)


def load_host(name: str):
    """Build (unless built already) and load the host library
    ``csrc/<name>.cpp`` with ``CXX`` and ``CXX_FLAGS``; returns
    (ctypes.CDLL, info) as ``load`` does."""
    return _load(name, SRC_DIR / f"{name}.cpp", [], CXX_FLAGS, lambda: CXX)


def _load(name: str, src: Path, headers: list, flags: tuple, compiler):
    """The library of src, keyed by its text, its headers' and the flags,
    built with compiler() when it is missing."""
    tracing.count("kernel_loads")
    with tracing.stage("pamg.setup.kernels"):
        return _find_or_build(name, src, headers, flags, compiler)


def _find_or_build(name: str, src: Path, headers: list, flags: tuple,
                   compiler):
    key = hashlib.sha256(
        b"".join(f.read_bytes() for f in [src] + headers)
        + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    info = {"path": str(out), "seconds": 0.0, "cached": out.exists(),
            "log": ""}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one build a library: processes that start together (the ranks of
        # a distributed run, the test workers) wait for the first one's;
        # the lock goes with the process that holds it
        with open(BUILD_DIR / f".{name}-{key}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            info["cached"] = out.exists()
            if not out.exists():
                _build(src, [compiler(), *flags], out, info)
    return ctypes.CDLL(str(out)), info


def _build(src: Path, command: list, out: Path, info: dict):
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    cmd = [*command, "-o", str(tmp), str(src)]
    tracing.count("kernel_builds")
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} cannot run ({e}) to build "
                           f"{src}") from e
    info["seconds"] = time.perf_counter() - t0
    info["log"] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}) building "
                           f"{src}:\n{info['log']}")
    os.replace(tmp, out)
