"""The native (C++) QP oracle, loaded with ctypes.

Counterpart of ``iadmm_tpu/native/__init__.py``.  ``qp_oracle.cpp`` is a
copy of the JAX package's source: a dense condensed-KKT Cholesky ADMM
solver (the OSQP algorithm), OpenMP-parallel across a batch of instances.
The shared library is compiled on first use with ``g++ -O3 -march=native
-fopenmp -shared -fPIC`` into ``iadmm_tpu_torch/_build/`` under a name
keyed by a hash of the source, the flags and the target options that
``-march=native`` selects on this host, so a library built on one CPU is
never loaded on another.  The compiler writes a temporary name that
is then renamed into place, so processes that build at once never load a
partial library.  Where no toolchain is available :func:`available` is
false and :func:`solve_qp_batch` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "qp_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


@functools.lru_cache(maxsize=None)
def _host_target() -> bytes:
    """The target options ``g++ -march=native`` resolves to on this host
    (empty where there is no compiler: the build then fails anyway)."""
    try:
        return subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            check=True, capture_output=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return b""


def lib_path() -> Path:
    """Where the library of the current source is (or will be) built for
    this host."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_target())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"libqp_oracle-{digest}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp",
                               dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None or _BUILD_ERROR is not None:
            return _LIB
        path = lib_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:
            _BUILD_ERROR = (e.stderr if isinstance(
                e, subprocess.CalledProcessError) and e.stderr else str(e))
            return None
        d = ctypes.POINTER(ctypes.c_double)
        i = ctypes.POINTER(ctypes.c_int)
        lib.iadmm_solve_qp_batch.restype = ctypes.c_int
        lib.iadmm_solve_qp_batch.argtypes = [
            d, d, d, d, d,                        # P q A zl zu
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            d, d, i, i, ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    return load_library() is not None


def solve_qp_batch(P: np.ndarray, q: np.ndarray, A: np.ndarray,
                   zl: np.ndarray, zu: np.ndarray,
                   eps_abs: float = 1e-4, eps_rel: float = 1e-4,
                   max_iter: int = 20000, sigma: float = 1e-6,
                   alpha: float = 1.6, rho0: float = 0.1,
                   num_threads: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Solve a batch of box-constrained QPs with the native ADMM solver.

    ``P`` is the full (doubled) Hessian.  ``P/q/A`` may be a single shared
    instance (ndim 2/1/2) with per-instance ``zl/zu`` (the QP_RHS layout).
    Returns (x (N,n), y (N,m), iters (N,), status (N,)); status 0 = solved,
    1 = max_iter, 2 = factorisation failure, 3 = primal infeasible,
    4 = dual infeasible (unbounded)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_BUILD_ERROR}")
    zl = np.ascontiguousarray(zl, np.float64)
    zu = np.ascontiguousarray(zu, np.float64)
    if zl.ndim == 1:
        zl = zl[None]
        zu = zu[None]
    N, m = zl.shape
    shared = int(P.ndim == 2)
    n = P.shape[-1]
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    want = ((n, n), (n,), (m, n)) if shared else ((N, n, n), (N, n),
                                                  (N, m, n))
    for name, a, shape in zip("PqA", (P, q, A), want):
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    if zu.shape != zl.shape:
        raise ValueError(f"zu has shape {zu.shape}, expected {zl.shape}")
    x = np.zeros((N, n), np.float64)
    y = np.zeros((N, m), np.float64)
    iters = np.zeros(N, np.int32)
    status = np.zeros(N, np.int32)

    def ptr(a, t=ctypes.c_double):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.iadmm_solve_qp_batch(
        ptr(P), ptr(q), ptr(A), ptr(zl), ptr(zu),
        n, m, N, shared, eps_abs, eps_rel, max_iter, sigma, alpha, rho0,
        ptr(x), ptr(y), ptr(iters, ctypes.c_int), ptr(status, ctypes.c_int),
        num_threads)
    return x, y, iters, status
