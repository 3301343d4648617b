"""ctypes bindings + build for the native (C++) host components.

The device compute path is JAX/XLA; these native pieces fill the roles the
reference keeps in C++ (its trajectory integrator) for host-side work:
golden cross-validation of the jittable integrator and fast one-off solves
on CPU-only machines. Built on demand with g++ (no pybind11 dependency —
plain C ABI through ctypes).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "trajectory.cpp")
_LIB = os.path.join(_DIR, "libemri_native.so")

_lib = None


def build(force: bool = False) -> str:
    """Compile the shared library if missing/stale; returns its path."""
    if force or (not os.path.exists(_LIB)) or (
        os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
    ):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True,
        )
    return _LIB


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.integrate_inspiral.restype = ctypes.c_int64
        lib.integrate_inspiral.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.inspiral_duration.restype = ctypes.c_double
        lib.inspiral_duration.argtypes = [ctypes.c_double] * 4
        _lib = lib
    return _lib


def integrate_inspiral_native(
    p0: float,
    e0: float,
    nu: float,
    t_max_geo: float,
    *,
    rtol: float = 1e-11,
    atol: float = 1e-11,
    h_max_frac: float = 1.0 / 128.0,
    delta_p_stop: float = 0.12,
    max_steps: int = 2048,
):
    """C++ DP5(4) inspiral integration -> (t (n,), y (n, 4))."""
    lib = _load()
    t_out = np.zeros(max_steps)
    y_out = np.zeros((max_steps, 4))
    n = lib.integrate_inspiral(
        p0, e0, nu, t_max_geo, rtol, atol, h_max_frac, delta_p_stop,
        max_steps, t_out, y_out.reshape(-1),
    )
    if n < 1:
        raise RuntimeError("native integration failed")
    return t_out[:n], y_out[:n]


def inspiral_duration_native(p0: float, e0: float, nu: float, t_cap_geo: float) -> float:
    return float(_load().inspiral_duration(p0, e0, nu, t_cap_geo))


__all__ = ["build", "integrate_inspiral_native", "inspiral_duration_native"]
