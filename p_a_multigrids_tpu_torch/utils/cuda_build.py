"""Build a CUDA source of this package into a shared library at first use.

``load("phase")`` compiles ``csrc/phase.cu`` with ``nvcc`` for Hopper
(``sm_90a``) into ``_build/phase-<hash>.so`` beside the sources, keyed by a
hash of the source, the headers of ``csrc/``, the flags and the defines
(``load("phase", defines=("PAMG_CHECKED",))`` builds the checked variant
into a library of its own), and loads it with ``ctypes``.  The library
has a plain C interface, so no PyTorch headers are compiled.  Processes
that find the library missing at once build it once, under a file lock.
There is no fallback: a missing compiler or a failed build raises.
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

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    src = SRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = hashlib.sha256(
        b"".join(f.read_bytes() for f in
                 [src] + sorted(SRC_DIR.glob("*.cuh")))
        + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    info = {"path": str(out), "seconds": 0.0, "cached": out.exists(),
            "log": ""}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one build a library: processes that start together (the ranks of
        # a distributed run) wait for the first one's; the lock goes with
        # the process that holds it
        with open(BUILD_DIR / f".{name}-{key}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            info["cached"] = out.exists()
            if not out.exists():
                _build(src, flags, out, info)
    return ctypes.CDLL(str(out)), info


def _build(src: Path, flags: tuple, out: Path, info: dict):
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    info["seconds"] = time.perf_counter() - t0
    info["log"] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{src}:\n{info['log']}")
    os.replace(tmp, out)
