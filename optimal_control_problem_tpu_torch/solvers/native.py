"""Runtime-compiled native (C++) reference QP solver — port of
``optimal_control_problem_tpu/solvers/native.py``.

* The runtime compile-and-load workflow (the reference's ``compileLibrary``
  shelling out to gcc and ``dlopen``-ing the result):
  :func:`build_native_lib` compiles the port's own copy of the C++ oracle,
  ``csrc/ref_admm.cpp``, with ``g++ -O3 -shared -fPIC -std=c++17`` at first
  use into ``build/ocp_torch_kernels/`` (beside the CUDA kernels,
  content-addressed by the source) and loads it with ``ctypes``.
* The native QP backend: :func:`native_admm_solve` runs the OSQP-style
  algorithm in C++ as an independent oracle (same scaling, rho rules,
  relaxation, termination), in float32 (the reference's
  ``OSQP_USE_FLOAT=ON``) or float64 internals.

The same source, the same flags and the same inputs give the JAX
package's ``native_admm_solve`` bit for bit.  Host code: numpy in and
out, nothing on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..ops import build

__all__ = ["build_native_lib", "native_admm_solve", "native_available", "NativeQPSolution"]

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "ref_admm.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def build_native_lib(force: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the native reference solver.  The
    library is named by a hash of the source and flags, so an edited
    source is rebuilt and a stale build never loaded."""
    global _lib
    if _lib is not None and not force:
        return _lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native reference solver is compiled at first use")
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"libref_admm_{tag}.so"
    if force or not out.exists():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f32p = ctypes.POINTER(ctypes.c_float)
    argtypes = [
        ctypes.c_int, ctypes.c_int,  # n, m
        f32p, f32p, f32p, f32p, f32p,  # P q A l u
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # max_iter check_every scaling_iters
        f32p, f32p, ctypes.POINTER(ctypes.c_int), f32p, f32p,  # x y iters r_prim r_dual
    ]
    # f32 internals (OSQP_USE_FLOAT=ON analog) + f64 second opinion.
    for sym in ("ref_admm_solve", "ref_admm_solve_f64"):
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native solver builds and loads here (``g++`` present)."""
    try:
        build_native_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeQPSolution(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    iters: int
    converged: bool
    r_prim: float
    r_dual: float


def native_admm_solve(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-3,
    eps_rel: float = 1e-3,
    max_iter: int = 10000,
    check_every: int = 25,
    scaling_iters: int = 10,
    internal_f64: bool = False,
) -> NativeQPSolution:
    """Solve ``min 1/2 x'Px + q'x  s.t. l <= Ax <= u`` with the C++ oracle.

    ``internal_f64=False`` (default) computes every Ruiz pass,
    factorization, iteration and residual in float32;
    ``internal_f64=True`` keeps the float32 inputs and outputs but
    iterates in double.  Arrays may be numpy or CPU tensors.
    """
    lib = build_native_lib()
    n = int(np.shape(P)[0])
    m = int(np.shape(A)[0]) if np.size(A) else 0
    Pf = np.ascontiguousarray(P, dtype=np.float32)
    qf = np.ascontiguousarray(q, dtype=np.float32).reshape(n)
    Af = np.ascontiguousarray(A, dtype=np.float32).reshape(max(m, 1), n)
    lf = np.ascontiguousarray(l, dtype=np.float32).reshape(max(m, 1))
    uf = np.ascontiguousarray(u, dtype=np.float32).reshape(max(m, 1))
    x = np.zeros(n, dtype=np.float32)
    y = np.zeros(max(m, 1), dtype=np.float32)
    iters = ctypes.c_int(0)
    rp = ctypes.c_float(0.0)
    rd = ctypes.c_float(0.0)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    entry = lib.ref_admm_solve_f64 if internal_f64 else lib.ref_admm_solve
    status = entry(
        n, m, ptr(Pf), ptr(qf), ptr(Af), ptr(lf), ptr(uf),
        ctypes.c_float(rho), ctypes.c_float(sigma), ctypes.c_float(alpha),
        ctypes.c_float(eps_abs), ctypes.c_float(eps_rel),
        max_iter, check_every, scaling_iters,
        ptr(x), ptr(y), ctypes.byref(iters), ctypes.byref(rp), ctypes.byref(rd),
    )
    if status < 0:
        raise RuntimeError("native ADMM solver failed (factorization error)")
    return NativeQPSolution(
        x=x, y=y[:m], iters=int(iters.value), converged=(status == 0),
        r_prim=float(rp.value), r_dual=float(rd.value),
    )
