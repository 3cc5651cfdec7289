"""Native host-side geometry code (C++ via ctypes).

Counterpart of ``sculptmate_tpu/geometry/native/__init__.py`` for the
libraries the port's paths need, copies of the JAX package's sources: the
wire decoders ``mc_wire.cpp`` (Lean) and ``mt_wire.cpp`` (SF3D), the
quadric decimator ``quadric_decimate.cpp``, the UV overlap painter
``unwrap_overlap.cpp`` and the isotropic remesher ``isotropic_remesh.cpp``
(``geometry/remesh.py``). They are host code, not GPU kernels: each is built
with ``g++`` on first use into the package's ignored ``_build/`` directory,
under a name that hashes its source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build(name: str) -> str:
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}.{digest}.so")
    if not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)  # a concurrent build never loads half a file
    return out


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """Compile (once) and load lib<name>.so from <name>.cpp; None when no
    compiler or loader is available (callers fall back to numpy)."""
    with _LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = ctypes.CDLL(_build(name))
            except (OSError, subprocess.CalledProcessError):
                _LIBS[name] = None
        return _LIBS[name]
