"""Fused block-tridiagonal ADMM chunk, batch-last — port of
``optimal_control_problem_tpu/ops/banded_kernel.py::banded_admm_chunk``.

One call runs a whole rho-constant ADMM chunk for a batch of
stage-structured QPs: it assembles ``M = P + sigma I + A^T R A`` from the
stage blocks, block-Thomas-factors it, then iterates over-relaxed OSQP
ADMM with per-scenario termination on unscaled residuals every
``check_every`` iterations, freezing converged scenarios at check-block
granularity.  Every array is batch-last::

    blocks  (N, w, w, B)    vectors  (N, w, B)    per-scenario  (B,)

:func:`banded_admm_chunk` is the wrapper: it checks the call and runs the
custom op ``torch.ops.ocp_torch.banded_admm_chunk`` (:func:`register_chunk_op`).
For CUDA tensors the op launches the hand-written kernel
``csrc/banded_chunk.cu`` (one warp per scenario, its factors, state and
operators in a slab of shared memory; built by ``nvcc`` at first use) and
counts the launch in ``banded_admm_chunk.launches``; for CPU tensors it
runs :func:`banded_admm_chunk_plain`, the straightforward PyTorch
transcription of the same contract that the CPU tests hold against the
Pallas kernel.  There is no fallback from one to the other.  As a custom
op the kernel is one node of known output shapes to ``torch.export``
(``utils/serialization.export_solver``): an exported program holds the
op, and reloaded in a process that imported the port, it launches the
same kernel on the card.

The iteration loop (:func:`admm_chunk_iterate_plain`), the ascending-chain
block algebra (:func:`mv`, :func:`mm`, ...) and the wrapper's contract
checks and launch (:func:`chunk_contract`, :func:`launch_chunk`) are
shared with the rolled two-way kernel of ``banded_rolled_kernel.py`` and
the cyclic-reduction kernel of ``banded_cr_kernel.py``, and so is their
registration as custom ops (:func:`register_chunk_op`): the chunks differ
only in how they factor ``M`` and solve with it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import as_tensors
from .block_tridiag import small_spd_inv

__all__ = [
    "banded_admm_chunk",
    "banded_admm_chunk_plain",
    "admm_chunk_iterate_plain",
    "chunk_contract",
    "launch_chunk",
    "register_chunk_op",
    "slab_floats",
    "slab_in_shared_memory",
    "KERNEL_WIDTHS",
    "SMEM_LIMIT",
]


def csum(t, dim):
    """Sum over ``dim`` as a sequential chain in ascending index order —
    the order of the JAX kernel's contractions and of the CUDA kernel, so
    the plain version rounds where they do (``torch.sum`` may reassociate)."""
    acc = t.select(dim, 0)
    for i in range(1, t.shape[dim]):
        acc = acc + t.select(dim, i)
    return acc


# Block widths the CUDA kernel is instantiated for (template parameter).
KERNEL_WIDTHS = (3, 4, 5)
_BOUNDS = ("lx", "ux", "rx", "ld", "ud", "rd", "lc", "uc", "rc")
_SCALES = ("ds", "ex", "ed", "ec", "ci")
# Dynamic shared memory one thread block may opt into on sm_90 (H100/H200).
SMEM_LIMIT = 232_448


def slab_floats(N: int, w: int, r: int, r2: int) -> int:
    """Floats of one scenario's slab in ``csrc/banded_chunk.cu`` (its
    ``slab_floats``): the factors ``dinv`` and ``g`` ((2N-1) w^2), the
    sweep and solution vectors and x, zx, yx (5 N w), zd, yd (2 (N-1) r),
    zc, yc (2 N r2), the factorization's product and Gauss-Jordan
    ping-pong pair (5 w^2), then the scenario's copy of its operators (Hb,
    J0, J1, Jc and the bound and scaling rows)."""
    nd = N - 1
    state = (2 * N - 1) * w * w + 5 * N * w + 2 * nd * r + 2 * N * r2 + 5 * w * w
    ops = N * w * w + 2 * nd * r * w + N * r2 * w + 6 * N * w + 4 * nd * r + 4 * N * r2
    return state + ops


def slab_in_shared_memory(N: int, w: int, r: int, r2: int) -> bool:
    """Whether one scenario's slab fits in its thread block's shared
    memory (16,544 bytes at cart-pole h20); otherwise the kernel keeps the
    slabs in global scratch (same code, L2-resident)."""
    return slab_floats(N, w, r, r2) * 4 <= SMEM_LIMIT


def outer_r(rho_s, ja, jb):
    """sum_i (rho[., i] ja[., i, a]) jb[., i, c] as an ascending i-chain ->
    (., w, w, B): the ``row_r`` terms of both kernels' M assembly."""
    acc = None
    for i in range(ja.shape[1]):
        t = (rho_s[:, i, None, None, :] * ja[:, i, :, None, :]) * jb[:, i, None, :, :]
        acc = t if acc is None else acc + t
    return acc


# ---- ascending-chain block algebra on batch-last blocks (..., w, w, B) and
# vectors (..., w, B), shared by both chunks' plain versions; one product
# per term, so only the chain order decides the rounding.


def mv(a, v):
    """a @ v: out[c] = sum_j a[c, j] v[j]."""
    acc = None
    for j in range(a.shape[-2]):
        t = a[..., :, j, :] * v[..., j : j + 1, :]
        acc = t if acc is None else acc + t
    return acc


def mtv(a, v):
    """a^T @ v: out[c] = sum_j a[j, c] v[j]."""
    acc = None
    for j in range(a.shape[-3]):
        t = a[..., j, :, :] * v[..., j : j + 1, :]
        acc = t if acc is None else acc + t
    return acc


def mm(a, b):
    """a @ b: out[i, c] = sum_j a[i, j] b[j, c]."""
    acc = None
    for j in range(a.shape[-2]):
        t = a[..., :, j, None, :] * b[..., None, j, :, :]
        acc = t if acc is None else acc + t
    return acc


def mmt(a, b):
    """a @ b^T: out[i, c] = sum_j a[i, j] b[c, j]."""
    acc = None
    for j in range(a.shape[-2]):
        t = a[..., :, j, None, :] * b[..., None, :, j, :]
        acc = t if acc is None else acc + t
    return acc


def mtm(a, b):
    """a^T @ b: out[i, c] = sum_j a[j, i] b[j, c]."""
    acc = None
    for j in range(a.shape[-3]):
        t = a[..., j, :, None, :] * b[..., None, j, :, :]
        acc = t if acc is None else acc + t
    return acc


def block_inv(m):
    """Gauss-Jordan inverse of SPD blocks (..., w, w, B)."""
    return small_spd_inv(m.movedim(-1, -3)).movedim(-3, -1)


def admm_chunk_iterate_plain(
    it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT, state,
    btd_solve: Callable[[torch.Tensor], torch.Tensor],
    *,
    interval: int,
    check_every: int,
    max_iter: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
):
    """The chunk's iteration loop, op for op the JAX kernels' ``one_iter``,
    ``residuals`` and check-block while loop, around a factored solve
    ``btd_solve(rhs (N, w, B)) -> (N, w, B)``.

    ``state`` is ``(x, zx, zd, zc, yx, yd, yc)``.  Returns the 13 chunk
    outputs ``(x, yx, yd, yc, zx, zd, zc, done, it_inc, rp, rd, mp, md)``.
    The check-block loop reads its condition on the host.
    """
    N, w, B = qT.shape
    dtype, dev = qT.dtype, qT.device
    hb, j0, j1, jc, q = HbT, J0T, J1T, JcT, qT
    lx, ux, rx = boundsT["lx"], boundsT["ux"], boundsT["rx"]
    ld, ud, rd_ = boundsT["ld"], boundsT["ud"], boundsT["rd"]
    lc, uc, rc = boundsT["lc"], boundsT["uc"], boundsT["rc"]
    ds, ex, ed, ec = scaleT["ds"], scaleT["ex"], scaleT["ed"], scaleT["ec"]
    ci = scaleT["ci"]

    def mat_A(x):
        ax_d = csum(j0 * x[:-1, None], 2) + csum(j1 * x[1:, None], 2)
        ax_c = csum(jc * x[:, None], 2)
        return x, ax_d, ax_c

    def mat_AT(tx, td, tc):
        td_e = td[:, :, None, :]
        c0 = csum(j0 * td_e, 1)
        c1 = csum(j1 * td_e, 1)
        out = tx.clone()
        out[:-1] = out[:-1] + c0
        out[1:] = out[1:] + c1
        return out + csum(jc * tc[:, :, None, :], 1)

    def mat_P(x):
        return csum(hb * x[:, None], 2)

    def one_iter(c):
        x, zx, zd, zc, yx, yd, yc = c
        rhs = sigma * x - q + mat_AT(rx * zx - yx, rd_ * zd - yd, rc * zc - yc)
        xt = btd_solve(rhs)
        ax, ad, ac = mat_A(xt)
        x_n = alpha * xt + (1.0 - alpha) * x

        def relax(zt, z, y, rho, lo, hi):
            z_rel = alpha * zt + (1.0 - alpha) * z
            z_new = torch.clip(z_rel + y / rho, lo, hi)
            y_new = y + rho * (z_rel - z_new)
            return z_new, y_new

        zx_n, yx_n = relax(ax, zx, yx, rx, lx, ux)
        zd_n, yd_n = relax(ad, zd, yd, rd_, ld, ud)
        zc_n, yc_n = relax(ac, zc, yc, rc, lc, uc)
        return (x_n, zx_n, zd_n, zc_n, yx_n, yd_n, yc_n)

    def maxsec(a):
        return torch.amax(a.reshape(-1, B), dim=0)

    def residuals(x, zx, zd, zc, yx, yd, yc):
        ax, ad, ac = mat_A(x)
        px = mat_P(x)
        aty = mat_AT(yx, yd, yc)
        r_prim = torch.maximum(
            torch.maximum(
                maxsec(torch.abs((ax - zx) * ex)), maxsec(torch.abs((ad - zd) * ed))
            ),
            maxsec(torch.abs((ac - zc) * ec)),
        )
        r_dual = ci * maxsec(torch.abs((px + q + aty) * ds))
        max_ax = torch.maximum(
            torch.maximum(maxsec(torch.abs(ax * ex)), maxsec(torch.abs(ad * ed))),
            maxsec(torch.abs(ac * ec)),
        )
        max_z = torch.maximum(
            torch.maximum(maxsec(torch.abs(zx * ex)), maxsec(torch.abs(zd * ed))),
            maxsec(torch.abs(zc * ec)),
        )
        max_prim = torch.maximum(max_ax, max_z)
        max_dual = ci * torch.maximum(
            torch.maximum(maxsec(torch.abs(aty * ds)), maxsec(torch.abs(px * ds))),
            maxsec(torch.abs(q * ds)),
        )
        return r_prim, r_dual, max_prim, max_dual

    it0 = it0.to(torch.int32)
    done = done0.to(torch.int32)
    inf_row = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    it_inc = torch.zeros((B,), dtype=torch.int32, device=dev)
    rp = rd = mp = md = inf_row

    k = 0
    while k < interval:
        act = (done == 0) & (it0 + k < max_iter)
        if not bool(act.any()):
            break
        new = state
        for _ in range(check_every):
            new = one_iter(new)
        state = tuple(torch.where(act, a, b) for a, b in zip(new, state))
        r_prim, r_dual, max_prim, max_dual = residuals(*state)
        eps_pri = eps_abs + eps_rel * max_prim
        eps_dua = eps_abs + eps_rel * max_dual
        newly = act & (r_prim <= eps_pri) & (r_dual <= eps_dua)
        it_inc = torch.where(act, it_inc + check_every, it_inc)
        rp = torch.where(act, r_prim, rp)
        rd = torch.where(act, r_dual, rd)
        mp = torch.where(act, max_prim, mp)
        md = torch.where(act, max_dual, md)
        done = torch.where(newly, torch.ones_like(done), done)
        k += check_every

    x, zx, zd, zc, yx, yd, yc = state
    return (x, yx, yd, yc, zx, zd, zc, done, it_inc, rp, rd, mp, md)


def banded_admm_chunk_plain(
    it0,  # (B,) int32 per-scenario iteration counts at entry
    done0,  # (B,) int32 1 = frozen at entry
    HbT,  # (N, w, w, B) scaled Hessian blocks
    J0T,  # (Nd, r, w, B) scaled dynamics Jacobian wrt frame k
    J1T,  # (Nd, r, w, B) scaled dynamics Jacobian wrt frame k+1
    JcT,  # (N, r2, w, B) scaled stage-constraint Jacobians
    qT,  # (N, w, B) scaled linear term
    boundsT: Dict[str, torch.Tensor],  # lx ux rx (N,w,B) ld ud rd (Nd,r,B) lc uc rc (N,r2,B)
    scaleT: Dict[str, torch.Tensor],  # ds ex (N,w,B) ed (Nd,r,B) ec (N,r2,B) ci (B,)
    xT,  # (N, w, B) scaled primal warm start
    yxT,  # (N, w, B) scaled duals by section
    ydT,  # (Nd, r, B)
    ycT,  # (N, r2, B)
    zxT,  # carried z sections
    zdT,
    zcT,
    *,
    interval: int,
    check_every: int,
    max_iter: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
):
    """Plain PyTorch version of the chunk, op for op the JAX ``_kernel``.

    Returns ``(x, yx, yd, yc, zx, zd, zc, done, it_inc, rp, rd, mp, md)``
    with the input layouts; the last six are (B,), ``done``/``it_inc``
    int32, ``rp``/``rd``/``mp``/``md`` ``inf`` where no check ran.  The
    check-block loop reads its condition on the host.
    """
    N, w, B = qT.shape
    dtype, dev = qT.dtype, qT.device
    j0, j1, jc = J0T, J1T, JcT
    rx, rd_, rc = boundsT["rx"], boundsT["rd"], boundsT["rc"]
    nd = N - 1

    # ---- M assembly + block-Thomas factorization ---------------------
    eye_w = torch.eye(w, dtype=dtype, device=dev)[:, :, None]  # (w, w, 1)
    eye_w4 = eye_w[None]

    diag = HbT + sigma * eye_w4 + eye_w4 * rx[:, :, None, :]
    diag = diag.clone()
    diag[:nd] = diag[:nd] + outer_r(rd_, j0, j0)
    diag[1:] = diag[1:] + outer_r(rd_, j1, j1)
    diag = diag + outer_r(rc, jc, jc)
    low = outer_r(rd_, j1, j0)  # (Nd, w, w, B)

    dinv = [block_inv(diag[0])]
    g = []
    for k in range(1, N):
        g_k = mm(low[k - 1], dinv[k - 1])
        dinv.append(block_inv(diag[k] - mmt(g_k, low[k - 1])))
        g.append(g_k)

    def btd_solve(rhs):
        s = [rhs[0]]
        for k in range(1, N):
            s.append(rhs[k] - mv(g[k - 1], s[k - 1]))
        s[N - 1] = mv(dinv[N - 1], s[N - 1])
        for k in range(N - 2, -1, -1):
            s[k] = mv(dinv[k], s[k]) - mtv(g[k], s[k + 1])
        return torch.stack(s)

    return admm_chunk_iterate_plain(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        (xT, zxT, zdT, zcT, yxT, ydT, ycT), btd_solve,
        interval=interval, check_every=check_every, max_iter=max_iter,
        sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
    )


# ---------------------------------------------------------------------------
# Wrapper contract and CUDA launch, shared by the chunk kernels


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def chunk_tensors(*args, device=None) -> list:
    """A chunk's positional inputs as tensors, the entries of its two dicts
    of sections included (:func:`..device.as_tensors`: what is not a tensor
    goes to ``device``, by default the first tensor's)."""
    flat = [v for a in args for v in (a.values() if isinstance(a, dict) else (a,))]
    flat = iter(as_tensors(*flat, device=device))
    return [{k: next(flat) for k in a} if isinstance(a, dict) else next(flat) for a in args]


def chunk_contract(
    label, it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
    xT, yxT, ydT, ycT, zxT, zdT, zcT, check_every,
) -> Tuple[List[torch.Tensor], Tuple[int, int, int, int, int]]:
    """Check a chunk call against the kernels' contract, on both devices
    (so the CPU tests hold the driver to it): row-major batch-last arrays
    of one float type (float32 on the card), int32 per-scenario counters,
    ``N >= 2``, ``r, r2 >= 1``.  Returns the 28 inputs in the kernels'
    pointer order and ``(N, w, r, r2, B)``."""
    dev = qT.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{label}: unsupported device {dev}")
    N, w, B = qT.shape
    nd = N - 1
    r = J0T.shape[1]
    r2 = JcT.shape[1]
    if N < 2 or r < 1 or r2 < 1:
        raise ValueError(
            f"{label} needs N >= 2, r >= 1, r2 >= 1 (got N={N}, "
            f"r={r}, r2={r2}); the driver pads absent sections"
        )
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    f32, i32 = (torch.float32 if dev.type == "cuda" else qT.dtype), torch.int32
    vx, vd, vc = (N, w, B), (nd, r, B), (N, r2, B)
    inputs = [
        ("it0", it0, (B,), i32), ("done0", done0, (B,), i32),
        ("HbT", HbT, (N, w, w, B), f32), ("J0T", J0T, (nd, r, w, B), f32),
        ("J1T", J1T, (nd, r, w, B), f32), ("JcT", JcT, (N, r2, w, B), f32),
        ("qT", qT, vx, f32),
    ]
    for name, shape in zip(_BOUNDS, (vx, vx, vx, vd, vd, vd, vc, vc, vc)):
        inputs.append((name, boundsT[name], shape, f32))
    for name, shape in zip(_SCALES, (vx, vx, vd, vc, (B,))):
        inputs.append((name, scaleT[name], shape, f32))
    inputs += [
        ("xT", xT, vx, f32), ("yxT", yxT, vx, f32), ("ydT", ydT, vd, f32),
        ("ycT", ycT, vc, f32), ("zxT", zxT, vx, f32), ("zdT", zdT, vd, f32),
        ("zcT", zcT, vc, f32),
    ]
    for name, t, shape, dt in inputs:
        _check(name, t, shape, dt, dev)
    return [t for _, t, _, _ in inputs], (N, w, r, r2, B)


def chunk_outputs(dims, dev, dtype=torch.float32) -> tuple:
    """The 13 output tensors of a chunk launch, uninitialised (floats of
    ``dtype``: float32 on the card, the plain version's input type on the
    CPU)."""
    N, w, r, r2, B = dims
    vx, vd, vc = (N, w, B), (N - 1, r, B), (N, r2, B)

    def empty(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    i32 = torch.int32
    return (
        empty(vx), empty(vx), empty(vd), empty(vc),  # x yx yd yc
        empty(vx), empty(vd), empty(vc),  # zx zd zc
        empty((B,), i32), empty((B,), i32),  # done it_inc
        empty((B,)), empty((B,)), empty((B,)), empty((B,)),  # rp rd mp md
    )


_LIB_FNS: Dict[str, Tuple[object, object]] = {}


def _lib_fn(lib_name: str, symbol: str, n_int: int):
    """``(fn, error_string)`` of a chunk kernel's C entry point, building
    and loading its library on first use.  Every entry point takes
    ``(ptrs, nptrs, <n_int ints>, sigma, alpha, eps_abs, eps_rel, stream)``
    and returns the launch's ``cudaError_t``."""
    key = f"{lib_name}:{symbol}"
    if key not in _LIB_FNS:
        from .build import load_library

        lib = load_library(lib_name)
        fn = getattr(lib, symbol)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_int] * n_int
            + [ctypes.c_double] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        err = lib.ocp_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIB_FNS[key] = (fn, err)
    return _LIB_FNS[key]


def launch_chunk(
    label: str, lib_name: str, symbol: str, tensors: Sequence[Optional[torch.Tensor]],
    ints: Sequence[int], floats: Sequence[float], dev,
) -> None:
    """Launch a chunk kernel on the current stream with the device
    pointers of ``tensors`` (inputs, outputs, scratch, in the kernel's
    order; None for a null pointer); raises if the launch is refused.
    Does not synchronise."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn, err_fn = _lib_fn(lib_name, symbol, len(ints))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        ctypes.cast(arr, ctypes.c_void_p), len(ptrs),
        *(int(i) for i in ints), *(float(f) for f in floats),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = err_fn(err).decode()
        raise RuntimeError(f"{label} launch failed: cudaError {err} ({msg})")


def chunk_scalars(interval, check_every, max_iter, sigma, alpha, eps_abs, eps_rel) -> tuple:
    """A chunk op's scalar arguments, as the schema's ints and floats."""
    return (int(interval), int(check_every), int(max_iter), float(sigma), float(alpha),
            float(eps_abs), float(eps_rel))


def chunk_dims(inputs: Sequence[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    """``(N, w, r, r2, B)`` of a chunk's inputs in the kernels' pointer order."""
    N, w, B = inputs[6].shape
    return N, w, inputs[3].shape[1], inputs[5].shape[1], B


def register_chunk_op(name: str, plain: Callable, launch: Callable, flags: Sequence[str] = ()):
    """Register a banded chunk kernel as the custom op ``ocp_torch::<name>``
    and return it.

    Its schema: the 28 inputs in the kernels' pointer order (``inputs``,
    :func:`chunk_contract`'s list: the two dicts of sections flattened),
    ``interval``, ``check_every``, ``max_iter``, ``sigma``, ``alpha``,
    ``eps_abs``, ``eps_rel`` and one ``bool`` per name in ``flags``;
    returns the 13 outputs.  The CPU implementation is the plain version
    ``plain`` (its outputs copied: an op may return no input, and no
    output twice, where a frozen chunk returns its inputs); the CUDA
    implementation is ``launch``, the module's kernel path
    ``launch(inputs, dims, interval, ..., eps_rel, *flags)``, which counts
    the launch; the fake implementation gives the outputs' shapes and
    types (:func:`chunk_outputs`).  No input is written (``mutates_args``
    is empty): each kernel writes its outputs and a slab the launch
    allocates."""
    schema = ("(Tensor[] inputs, int interval, int check_every, int max_iter, float sigma, "
              "float alpha, float eps_abs, float eps_rel"
              + "".join(f", bool {f}" for f in flags) + ") -> Tensor[]")
    keys = ("interval", "check_every", "max_iter", "sigma", "alpha", "eps_abs", "eps_rel",
            *flags)

    def cpu(inputs, *args):
        plain_args = (*inputs[:7], dict(zip(_BOUNDS, inputs[7:16])),
                      dict(zip(_SCALES, inputs[16:21])), *inputs[21:])
        return [o.clone() for o in plain(*plain_args, **dict(zip(keys, args)))]

    op = torch.library.custom_op(f"ocp_torch::{name}", cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)

    @op.register_kernel("cuda")
    def _(inputs, *args):
        return list(launch(inputs, chunk_dims(inputs), *args))

    @op.register_fake
    def _(inputs, *args):
        return list(chunk_outputs(chunk_dims(inputs), inputs[6].device, inputs[6].dtype))

    return op


def banded_admm_chunk(
    it0,
    done0,
    HbT,
    J0T,
    J1T,
    JcT,
    qT,
    boundsT: Dict[str, torch.Tensor],
    scaleT: Dict[str, torch.Tensor],
    xT,
    yxT,
    ydT,
    ycT,
    zxT,
    zdT,
    zcT,
    *,
    interval: int,
    check_every: int,
    max_iter: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
    device=None,
):
    """Run one rho-constant banded-ADMM chunk; all arrays batch-last.

    Same contract as :func:`banded_admm_chunk_plain`, through the op
    ``ocp_torch::banded_admm_chunk``: CPU tensors take the plain version;
    CUDA tensors launch ``csrc/banded_chunk.cu`` on the current stream
    (f32, contiguous, ``w`` in :data:`KERNEL_WIDTHS`, ``r, r2 >= 1``) or
    raise.  Arrays that are not tensors go to ``device``
    (:func:`chunk_tensors`).
    """
    (it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
     xT, yxT, ydT, ycT, zxT, zdT, zcT) = chunk_tensors(
        it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        xT, yxT, ydT, ycT, zxT, zdT, zcT, device=device)
    inputs, dims = chunk_contract(
        "banded_admm_chunk", it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
        xT, yxT, ydT, ycT, zxT, zdT, zcT, check_every,
    )
    if qT.device.type != "cpu":
        _card_width(dims[1])
    return tuple(torch.ops.ocp_torch.banded_admm_chunk(
        inputs, *chunk_scalars(interval, check_every, max_iter, sigma, alpha, eps_abs,
                               eps_rel)))


def _card_width(w: int) -> None:
    """Raise for a block width the CUDA kernel does not take (checked by the
    wrapper before the op, so a trace for the card refuses it too)."""
    if w not in KERNEL_WIDTHS:
        raise ValueError(
            f"banded_admm_chunk: block width w={w} has no CUDA instantiation "
            f"(built for {KERNEL_WIDTHS}); the rolled chunk takes it"
        )


def _launch(inputs, dims, interval, check_every, max_iter, sigma, alpha, eps_abs, eps_rel):
    """The wrapper's kernel path: outputs, slab and the launch of
    ``csrc/banded_chunk.cu`` on ``inputs`` (checked by ``chunk_contract``)."""
    N, w, r, r2, B = dims
    _card_width(w)
    dev = inputs[0].device
    outs = chunk_outputs(dims, dev)
    if B == 0:
        return outs
    per = slab_floats(N, w, r, r2)
    in_smem = slab_in_shared_memory(N, w, r, r2)
    slab = torch.empty((1 if in_smem else B * per,), dtype=torch.float32, device=dev)
    launch_chunk(
        "banded_admm_chunk", "banded_chunk", "ocp_banded_admm_chunk_f32",
        [*inputs, *outs, slab],
        (N, w, r, r2, B, interval, check_every, max_iter, per, int(in_smem)),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    banded_admm_chunk.launches += 1
    return outs


banded_admm_chunk.launches = 0
register_chunk_op("banded_admm_chunk", banded_admm_chunk_plain, _launch)
