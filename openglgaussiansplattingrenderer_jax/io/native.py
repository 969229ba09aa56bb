"""ctypes binding to the native C++ PLY loader (``csrc/ply_loader.cpp``).

The native loader mmaps the file and activates splats across hardware
threads -- the JAX framework's counterpart of the reference's C++ loader
(ref ``src/Splats.cpp:174-344``). Falls back to the numpy path in
``io/ply.py`` when the shared library hasn't been built (``make -C csrc``)
or the file layout is non-standard.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "build", "libgsply.so")
_lib = None
_lib_checked = False


def _load_lib(auto_build: bool = True):
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    if not os.path.exists(_LIB_PATH) and auto_build:
        csrc = os.path.dirname(os.path.dirname(_LIB_PATH))
        try:
            subprocess.run(["make", "-C", csrc], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gs_open.restype = ctypes.c_long
    lib.gs_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
    lib.gs_read.restype = ctypes.c_int
    lib.gs_read.argtypes = [ctypes.c_long, ctypes.c_float] + [
        ctypes.POINTER(ctypes.c_float)] * 6
    lib.gs_close.restype = None
    lib.gs_close.argtypes = [ctypes.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load_lib() is not None


def load_splats(path: str, color_scale: float = 255.0
                ) -> Optional[Dict[str, np.ndarray]]:
    """Load + activate via the native library. None -> caller should fall
    back to the numpy parser."""
    lib = _load_lib()
    if lib is None:
        return None
    counts = (ctypes.c_long * 2)()
    handle = lib.gs_open(path.encode(), counts)
    if handle == 0:
        # missing file or non-standard layout; numpy path gives the real error
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None
    try:
        n, n_rest = int(counts[0]), int(counts[1])
        means = np.empty((n, 3), np.float32)
        colors = np.empty((n, 3), np.float32)
        opac = np.empty((n,), np.float32)
        scales = np.empty((n, 3), np.float32)
        quats = np.empty((n, 4), np.float32)
        sh_rest = np.empty((n, n_rest), np.float32) if n_rest else None

        def ptr(a):
            if a is None:
                return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

        rc = lib.gs_read(handle, ctypes.c_float(color_scale), ptr(means),
                         ptr(colors), ptr(opac), ptr(scales), ptr(quats),
                         ptr(sh_rest))
        if rc != 0:
            return None
        return {
            "means": means, "colors": colors, "opacities": opac,
            "scales": scales, "quats": quats,
            "sh_rest": sh_rest if sh_rest is not None
            else np.zeros((n, 0), np.float32),
        }
    finally:
        lib.gs_close(handle)
