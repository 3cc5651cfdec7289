"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library of
its own with a plain C interface (no PyTorch headers, so a build takes
seconds), which is loaded with ``ctypes``. Libraries land in ``_build/``
next to the sources, named by a hash of the sources and flags, so an edited
kernel never loads a stale binary. Nothing is built when a module is
imported: the first launch builds what it needs, and ``build_all`` builds
every kernel at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names():
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only where the CUDA "
        "toolkit is installed (set CUDA_HOME)"
    )


def _lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; returns
    its path. The compiler's resource report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``.log``."""
    out = _lib_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(os.path.splitext(out)[0] + ".log", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)  # write-then-rename: a concurrent build never sees half a file
    return out


def build_all() -> Dict[str, float]:
    """Build every kernel in parallel; returns seconds per kernel."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    names = kernel_names()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(pool.map(timed, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]


@contextlib.contextmanager
def sources_from(csrc: str):
    """Build and load every kernel from the sources in ``csrc`` (libraries
    under ``<csrc>/_build``) until the block exits, then return to the
    package's own. Lets a check show that it fails a deliberately broken
    copy of a kernel."""
    global CSRC, BUILD_DIR
    with _LOCK:
        saved = CSRC, BUILD_DIR, dict(_LIBS)
        CSRC, BUILD_DIR = csrc, os.path.join(csrc, "_build")
        _LIBS.clear()
    try:
        yield
    finally:
        with _LOCK:
            CSRC, BUILD_DIR = saved[:2]
            _LIBS.clear()
            _LIBS.update(saved[2])


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when this kernel was built."""
    with open(os.path.splitext(_lib_path(name))[0] + ".log") as f:
        return f.read()


def aligned(t):
    """``t`` as a contiguous tensor whose data starts on a 16-byte boundary,
    the widest vector load the kernels make."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
