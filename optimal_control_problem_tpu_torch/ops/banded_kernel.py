"""Fused block-tridiagonal ADMM chunk, batch-last — port of
``optimal_control_problem_tpu/ops/banded_kernel.py::banded_admm_chunk``.

One call runs a whole rho-constant ADMM chunk for a batch of
stage-structured QPs: it assembles ``M = P + sigma I + A^T R A`` from the
stage blocks, block-Thomas-factors it, then iterates over-relaxed OSQP
ADMM with per-scenario termination on unscaled residuals every
``check_every`` iterations, freezing converged scenarios at check-block
granularity.  Every array is batch-last::

    blocks  (N, w, w, B)    vectors  (N, w, B)    per-scenario  (B,)

:func:`banded_admm_chunk` is the wrapper: for CUDA tensors it launches the
hand-written kernel ``csrc/banded_chunk.cu`` (one thread per scenario,
built by ``nvcc`` at first use) and counts the launch in
``banded_admm_chunk.launches``; for CPU tensors it runs
:func:`banded_admm_chunk_plain`, the straightforward PyTorch transcription
of the same contract that the CPU tests hold against the Pallas kernel.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .block_tridiag import small_spd_inv

__all__ = ["banded_admm_chunk", "banded_admm_chunk_plain", "KERNEL_WIDTHS"]


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
    hb, j0, j1, jc, q = HbT, J0T, J1T, JcT, qT
    lx, ux, rx = boundsT["lx"], boundsT["ux"], boundsT["rx"]
    ld, ud, rd_ = boundsT["ld"], boundsT["ud"], boundsT["rd"]
    lc, uc, rc = boundsT["lc"], boundsT["uc"], boundsT["rc"]
    ds, ex, ed, ec = scaleT["ds"], scaleT["ex"], scaleT["ed"], scaleT["ec"]
    ci = scaleT["ci"]
    nd = N - 1

    # ---- M assembly + block-Thomas factorization ---------------------
    eye_w = torch.eye(w, dtype=dtype, device=dev)[:, :, None]  # (w, w, 1)
    eye_w4 = eye_w[None]

    def outer(rho_s, ja, jb):
        """sum_i (rho[., i] ja[., i, a]) jb[., i, c] as an ascending
        i-chain -> (., w, w, B) (the kernel's ``row_r``)."""
        acc = None
        for i in range(ja.shape[1]):
            t = (rho_s[:, i, None, None, :] * ja[:, i, :, None, :]) * jb[:, i, None, :, :]
            acc = t if acc is None else acc + t
        return acc

    diag = hb + sigma * eye_w4 + eye_w4 * rx[:, :, None, :]
    diag = diag.clone()
    diag[:nd] = diag[:nd] + outer(rd_, j0, j0)
    diag[1:] = diag[1:] + outer(rd_, j1, j1)
    diag = diag + outer(rc, jc, jc)
    low = outer(rd_, j1, j0)  # (Nd, w, w, B)

    def spd_inv_bl(m):
        return small_spd_inv(m.permute(2, 0, 1)).permute(1, 2, 0)

    def mm(a, b):
        """(w, w, B) block product, sequential j-chain."""
        acc = None
        for j in range(w):
            t = a[:, j : j + 1, :] * b[j : j + 1, :, :]
            acc = t if acc is None else acc + t
        return acc

    dinv = [spd_inv_bl(diag[0])]
    g = []
    for k in range(1, N):
        g_k = mm(low[k - 1], dinv[k - 1])
        schur = diag[k] - mm(g_k, low[k - 1].transpose(0, 1))
        dinv.append(spd_inv_bl(schur))
        g.append(g_k)

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

    def btd_solve(rhs):
        s = [rhs[0]]
        for k in range(1, N):
            s.append(rhs[k] - csum(g[k - 1] * s[k - 1][None], 1))
        s[N - 1] = csum(dinv[N - 1] * s[N - 1][None], 1)
        for k in range(N - 2, -1, -1):
            s[k] = csum(dinv[k] * s[k][None], 1) - csum(g[k] * s[k + 1][:, None], 0)
        return torch.stack(s)

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
    state = (xT, zxT, zdT, zcT, yxT, ydT, ycT)
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


# ---------------------------------------------------------------------------
# CUDA launch


def _chunk_fn():
    fn = _CHUNK_FN.get("fn")
    if fn is None:
        from .build import load_library

        lib = load_library("banded_chunk")
        fn = lib.ocp_banded_admm_chunk_f32
        fn.argtypes = [
            ctypes.c_void_p,  # const void* const* ptrs
            ctypes.c_int,  # nptrs
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N w r r2 B
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # interval check_every max_iter
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        err = lib.ocp_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _CHUNK_FN["fn"] = fn
        _CHUNK_FN["err"] = err
    return fn


_CHUNK_FN: Dict[str, object] = {}


def _check(name, t, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
):
    """Run one rho-constant banded-ADMM chunk; all arrays batch-last.

    Same contract as :func:`banded_admm_chunk_plain`.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/banded_chunk.cu`` on the
    current stream (f32, contiguous, ``w`` in :data:`KERNEL_WIDTHS`,
    ``r, r2 >= 1``) or raise.
    """
    kw = dict(
        interval=interval, check_every=check_every, max_iter=max_iter,
        sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
    )
    dev = qT.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_admm_chunk: unsupported device {dev}")
    N, w, B = qT.shape
    nd = N - 1
    r = J0T.shape[1]
    r2 = JcT.shape[1]
    if N < 2 or r < 1 or r2 < 1:
        raise ValueError(
            f"banded_admm_chunk needs N >= 2, r >= 1, r2 >= 1 (got N={N}, "
            f"r={r}, r2={r2}); the driver pads absent sections"
        )
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    # The kernel's contract, checked on both devices so the CPU tests hold
    # the driver to it: row-major batch-last arrays of one float type
    # (float32 on the card), int32 per-scenario counters.
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
    if dev.type == "cpu":
        return banded_admm_chunk_plain(
            it0, done0, HbT, J0T, J1T, JcT, qT, boundsT, scaleT,
            xT, yxT, ydT, ycT, zxT, zdT, zcT, **kw,
        )
    if w not in KERNEL_WIDTHS:
        raise ValueError(
            f"banded_admm_chunk: block width w={w} has no CUDA instantiation "
            f"(built for {KERNEL_WIDTHS})"
        )

    def empty(shape, dt=f32):
        return torch.empty(shape, dtype=dt, device=dev)

    outs = (
        empty(vx), empty(vx), empty(vd), empty(vc),  # x yx yd yc
        empty(vx), empty(vd), empty(vc),  # zx zd zc
        empty((B,), i32), empty((B,), i32),  # done it_inc
        empty((B,)), empty((B,)), empty((B,)), empty((B,)),  # rp rd mp md
    )
    scratch = (empty(vx), empty((N, w, w, B)), empty((nd, w, w, B)))  # s dinv g
    if B == 0:
        return outs
    ptrs = [t.data_ptr() for _, t, _, _ in inputs]
    ptrs += [t.data_ptr() for t in outs] + [t.data_ptr() for t in scratch]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = _chunk_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        ctypes.cast(arr, ctypes.c_void_p), len(ptrs),
        N, w, r, r2, B, int(interval), int(check_every), int(max_iter),
        float(sigma), float(alpha), float(eps_abs), float(eps_rel),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = _CHUNK_FN["err"](err).decode()
        raise RuntimeError(f"banded_admm_chunk launch failed: cudaError {err} ({msg})")
    banded_admm_chunk.launches += 1
    return outs


banded_admm_chunk.launches = 0
