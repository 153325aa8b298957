"""Native host solver for small reduced problems (C++ via ctypes).

On an accelerator the per-dispatch latency dwarfs the math of
cut-pursuit's reduced solves, whose size is the number of constant
components (typically 10..100).  ``pfdr_quadratic_d1_host`` runs the SAME
preconditioned forward-Douglas-Rachford iteration as
``solvers/pfdr_quadratic.py`` in C++ float64 on the host (``pfdr.cpp``,
compiled on first use by :mod:`..native_build`); cut-pursuit routes
reduced problems below a crossover size here when the main backend is not
the CPU (see ``CPOptions.host_small``).  The same library is the float64
reference the tests and ``chip_smoke.py`` check the device solvers against.
"""
from __future__ import annotations

import ctypes
import pathlib
import warnings

import numpy as np

from ..native_build import build_library

_DIR = pathlib.Path(__file__).resolve().parent
_SRCS = [_DIR / "pfdr.cpp", _DIR / "pfdr_simplex.cpp"]

_lib = None
_unavailable = False

_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")


def _get_lib():
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library("cppfdr", _SRCS)))
        lib.native_pfdr_quadratic_d1.restype = ctypes.c_int
        lib.native_pfdr_quadratic_d1.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,  # A (nullable)
            _F64, _I32, _I32, _F64,
            ctypes.c_void_p,  # la_l1 (nullable)
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p,  # lip_diag (nullable)
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            _F64, ctypes.POINTER(ctypes.c_int),
        ]
        lib.native_pfdr_loss_d1_simplex.restype = ctypes.c_int
        lib.native_pfdr_loss_d1_simplex.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            _F64,
            ctypes.c_void_p,  # la_f (nullable)
            _I32, _I32, _F64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            _F64, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - exercised only without g++
        warnings.warn(f"native PFDR unavailable ({e})")
        _unavailable = True
    return _lib


def available() -> bool:
    return _get_lib() is not None


def _ptr(x):
    if x is None:
        return None
    return x.ctypes.data_as(ctypes.c_void_p)


def pfdr_quadratic_d1_host(op_mode: int, a, y, eu, ev, la_d1, *,
                           la_l1=None, positivity=False, bounds=None,
                           lip_diag=None, lip_scal=0.0, rho=1.0,
                           cond_min=1e-3, dif_rcd=0.0, dif_tol=1e-4,
                           it_max=10_000, x0=None):
    """Host C++ PFDR solve (float64).

    Args:
      op_mode: >0 dense [op_mode, V]; -1 Gram [V, V]; 0 diagonal [V] (a may
        be None for identity).
      y: observation in the operator's convention.
      bounds: (lo, hi) to use the box vertex prox instead of l1.
      lip_diag / lip_scal: DIAG metric array or scalar Lipschitz bound.
      x0: warm-start iterate (defaults to zeros).

    Returns:
      (x [V] float64, iterations)
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native PFDR library unavailable")
    y = np.ascontiguousarray(y, np.float64)
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    la_d1 = np.ascontiguousarray(np.broadcast_to(la_d1, eu.shape),
                                 np.float64)
    v = len(y) if op_mode <= 0 else (a.shape[1] if a is not None else 0)
    if op_mode <= 0 and a is not None:
        a = np.ascontiguousarray(a, np.float64)
        v = a.shape[-1] if op_mode == -1 else len(a)
    elif op_mode > 0:
        a = np.ascontiguousarray(a, np.float64)
        v = a.shape[1]
    if la_l1 is not None:
        la_l1 = np.ascontiguousarray(np.broadcast_to(la_l1, (v,)),
                                     np.float64)
    if lip_diag is not None:
        lip_diag = np.ascontiguousarray(lip_diag, np.float64)
    use_bounds = bounds is not None
    lo, hi = bounds if use_bounds else (0.0, 0.0)
    x = (np.zeros(v) if x0 is None
         else np.ascontiguousarray(x0, np.float64).copy())
    it = ctypes.c_int(0)
    lib.native_pfdr_quadratic_d1(
        v, len(eu), op_mode, _ptr(a), y, eu, ev, la_d1, _ptr(la_l1),
        int(positivity), float(lo), float(hi), int(use_bounds),
        _ptr(lip_diag), float(lip_scal), float(rho), float(cond_min),
        float(dif_rcd), float(dif_tol), int(it_max), x,
        ctypes.byref(it))
    return x, int(it.value)


def pfdr_loss_d1_simplex_host(q, al, eu, ev, la_d1, *, la_f=None,
                              rho=1.0, cond_min=1e-3, dif_rcd=0.0,
                              dif_tol=1e-4, it_max=10_000, p0=None):
    """Host C++ multi-label PFDR solve (float64, [V, K] vertex-major).

    Returns (p [V, K] float64, iterations)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native PFDR library unavailable")
    q = np.ascontiguousarray(q, np.float64)
    v, k = q.shape
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    la_d1 = np.ascontiguousarray(np.broadcast_to(la_d1, eu.shape),
                                 np.float64)
    if la_f is not None:
        la_f = np.ascontiguousarray(np.broadcast_to(la_f, (v,)),
                                    np.float64)
    p = (np.full((v, k), 1.0 / k) if p0 is None
         else np.ascontiguousarray(p0, np.float64).copy())
    it = ctypes.c_int(0)
    lib.native_pfdr_loss_d1_simplex(
        v, len(eu), k, float(al), q, _ptr(la_f), eu, ev, la_d1,
        float(rho), float(cond_min), float(dif_rcd), float(dif_tol),
        int(it_max), p, ctypes.byref(it))
    return p, int(it.value)
