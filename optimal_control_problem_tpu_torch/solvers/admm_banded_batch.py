"""Batch-native banded ADMM: whole-batch solves through the fused chunk —
port of ``optimal_control_problem_tpu/solvers/admm_banded_batch.py``.

Division of labour per solve, every array batch-LAST (trailing scenario
axis):

* prepare (PyTorch, once): Ruiz equilibration — or the precomputed
  scalings when ``scaling_refresh="tick"`` — per-row rho, and z initialised
  to ``clip(A x0)`` (:func:`prepare_banded_batch_T`);
* iterate (one chunk kernel launch per rho-constant chunk): M assembly,
  block factorization and up to ``interval`` iterations with per-scenario
  termination — the CUDA kernel for tensors on the card, its plain version
  on the CPU.  Three chunk kernels share the contract (:func:`chunk_kernel`
  picks): ``ops/banded_kernel.banded_admm_chunk`` (one-way block-Thomas,
  one thread per scenario, ``w`` in ``KERNEL_WIDTHS``),
  ``ops/banded_rolled_kernel.banded_admm_chunk_rolled`` (two-way
  factorization with an optional depth-1 cyclic-reduction level, one
  thread per block row, any ``w`` up to 16) and, for
  ``banded_solver="cr"``, ``ops/banded_cr_kernel.banded_admm_chunk_cr``
  (cyclic reduction over whole levels, one thread block per scenario, any
  ``w`` up to 16).  The rule is the same on both
  devices, so the CPU runs the plain version of the kernel the card would
  run;
* between chunks (PyTorch): infeasibility certificates on the chunk deltas
  and OSQP adaptive rho (the refactorization happens at the next launch);
* finish: optional active-set polish (one batched pass), unscaling.

Semantics match the per-scenario ``admm_solve_banded`` (thomas), except
that certificates are evaluated once per chunk instead of once per check
block (as in the JAX driver).  Without adaptive rho the chunk interval is
``max_iter``, so one launch runs every scenario to convergence or to
``max_iter`` and no host synchronisation is needed; with adaptive rho the
loop reads "any scenario still active" on the host between chunks.

Not ported (nothing on the card needs them): the VMEM tile pickers, batch
padding to a tile, and the vmapped per-scenario fallback; the kernel
choice is :func:`chunk_kernel`'s width rule instead.  A shape the chosen
kernel does not take raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import as_tensors, resolve_device
from ..ops.banded_cr_kernel import banded_admm_chunk_cr
from ..ops.banded_kernel import KERNEL_WIDTHS, banded_admm_chunk
from ..ops.banded_rolled_kernel import banded_admm_chunk_rolled
from .admm import ADMMSettings, QPSolution, _RHO_MAX, _RHO_MIN, _fresh, f32_matmuls
from .admm_banded import (
    BandedQP,
    _rho_vec,
    banded_certificates_T,
    banded_polish_T,
    ruiz_equilibrate_banded_T,
)

__all__ = [
    "BandedBatchProblem",
    "admm_solve_banded_batch",
    "admm_solve_banded_batch_T",
    "chunk_inputs",
    "chunk_kernel",
    "prepare_banded_batch_T",
    "ruiz_scalings_batch",
    "ruiz_scalings_batch_T",
    "use_cr1",
]


def _t(a):
    """Batch-leading -> batch-last."""
    return a.movedim(0, -1).contiguous()


def _ut(a):
    """Batch-last -> batch-leading."""
    return a.movedim(-1, 0).contiguous()


def ruiz_scalings_batch(qp: BandedQP, iters: int, *, device=None):
    """Batch Ruiz factors only: ``(D (B, n), E (B, m), c (B,))`` from a
    batch-leading QP; fields that are not tensors go to ``device``
    (:func:`..device.as_tensors`)."""
    qp = as_tensors(*qp, device=device)
    DT, ET, cT = ruiz_scalings_batch_T(BandedQP(*(_t(a) for a in qp)), iters)
    return _ut(DT), _ut(ET), cT


def ruiz_scalings_batch_T(qpT: BandedQP, iters: int, *, device=None):
    """Batch-last Ruiz factors ``(D (n, B), E (m, B), c (B,))`` — what the
    SQP layer hoists out of its step loop (``scaling_refresh="tick"``);
    fields that are not tensors go to ``device``."""
    qpT = BandedQP(*as_tensors(*qpT, device=device))
    _, DT, ET, cT = ruiz_equilibrate_banded_T(qpT, iters)
    return DT, ET, cT


def _apply_scalings_T(qpT: BandedQP, DT, ET, cT, N, w, r, r2):
    """Scale a batch-last QP with precomputed factors: one elementwise pass,
    same per-element multiply order as the per-scenario version."""
    n = N * w
    B = DT.shape[-1]
    DnT = DT.reshape(N, w, B)
    EdT = ET[n : n + (N - 1) * r].reshape(N - 1, r, B) if r else None
    EcT = ET[n + (N - 1) * r :].reshape(N, r2, B) if r2 else None
    return BandedQP(
        Hb=cT * DnT[:, :, None, :] * qpT.Hb * DnT[:, None, :, :],
        J0=EdT[:, :, None, :] * qpT.J0 * DnT[:-1, None, :, :] if r else qpT.J0,
        J1=EdT[:, :, None, :] * qpT.J1 * DnT[1:, None, :, :] if r else qpT.J1,
        Jc=EcT[:, :, None, :] * qpT.Jc * DnT[:, None, :, :] if r2 else qpT.Jc,
        q=cT * DT * qpT.q,
        l=ET * qpT.l,
        u=ET * qpT.u,
    )


def _pad_sections_T(qpT: BandedQP, y0T, N, w):
    """Ensure r >= 1 and r2 >= 1 by inserting all-zero Jacobian rows with
    loose bounds (the kernel has a fixed three-section signature).  Zero
    rows are inert: Ruiz gives them unit scaling and their iterates stay
    exactly zero.  Returns ``(qpT, y0T, had_r, had_r2)``."""
    B = qpT.Hb.shape[-1]
    nd = N - 1
    n = N * w
    r = qpT.J0.shape[1]
    r2 = qpT.Jc.shape[1]
    had_r, had_r2 = r > 0, r2 > 0
    dtype, dev = qpT.Hb.dtype, qpT.Hb.device
    l, u, q = qpT.l, qpT.u, qpT.q
    J0, J1, Jc = qpT.J0, qpT.J1, qpT.Jc
    inf = float("inf")
    if not had_r:
        J0 = torch.zeros((nd, 1, w, B), dtype=dtype, device=dev)
        J1 = torch.zeros((nd, 1, w, B), dtype=dtype, device=dev)
        pad = torch.full((nd, B), -inf, dtype=dtype, device=dev)
        l = torch.cat([l[:n], pad, l[n:]], dim=0)
        u = torch.cat([u[:n], -pad, u[n:]], dim=0)
        zeros = torch.zeros((nd, B), dtype=dtype, device=dev)
        y0T = torch.cat([y0T[:n], zeros, y0T[n:]], dim=0)
    if not had_r2:
        Jc = torch.zeros((N, 1, w, B), dtype=dtype, device=dev)
        pad = torch.full((N, B), -inf, dtype=dtype, device=dev)
        l = torch.cat([l, pad], dim=0)
        u = torch.cat([u, -pad], dim=0)
        y0T = torch.cat([y0T, torch.zeros((N, B), dtype=dtype, device=dev)], dim=0)
    return BandedQP(qpT.Hb, J0, J1, Jc, q, l, u), y0T, had_r, had_r2


def _strip_sections_T(vT, N, w, r, r2, had_r, had_r2):
    """Drop the rows added by :func:`_pad_sections_T` from a flat (m, B)."""
    if had_r and had_r2:
        return vT
    n = N * w
    nd = N - 1
    parts = [vT[:n]]
    if had_r:
        parts.append(vT[n : n + nd * r])
    if had_r2:
        parts.append(vT[n + nd * r :])
    return torch.cat(parts, dim=0)


class BandedBatchProblem(NamedTuple):
    """A prepared (scaled, section-padded) batch, ready for chunk launches.

    ``scaled`` is the equilibrated batch-last QP with ``r, r2 >= 1``;
    ``D (n,B)``, ``E (m,B)``, ``c (B,)`` its Ruiz factors and ``Dinv``,
    ``Einv``, ``cinv`` their inverses; ``rho (m,B)`` the per-row rho;
    ``x (n,B)``, ``y``/``z`` ``(m,B)`` the scaled starting iterates (z is
    ``clip(A x0, l, u)``); ``interval`` the rho-constant chunk length.
    """

    scaled: BandedQP
    D: torch.Tensor
    E: torch.Tensor
    c: torch.Tensor
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor
    rho: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    interval: int
    had_r: bool
    had_r2: bool

    def sections(self, vT):
        """Flat (rows, B) -> (x (N,w,B), dyn (N-1,r,B), stage (N,r2,B))
        views (row-major with the batch last: pure reshapes)."""
        N, w, B = self.scaled.q.shape
        r, r2 = self.scaled.J0.shape[1], self.scaled.Jc.shape[1]
        n = N * w
        nd = N - 1
        return (
            vT[:n].reshape(N, w, B),
            vT[n : n + nd * r].reshape(nd, r, B),
            vT[n + nd * r :].reshape(N, r2, B),
        )


def prepare_banded_batch_T(
    qpT: BandedQP,
    st: ADMMSettings,
    x0T: Optional[torch.Tensor] = None,
    y0T: Optional[torch.Tensor] = None,
    scalingsT=None,
) -> BandedBatchProblem:
    """Scale, pad and initialise a batch-last QP for the chunk loop (the
    driver's prepare).  ``qpT`` fields carry a trailing scenario axis;
    the result's ``scaled.q`` is ``(N, w, B)``."""
    dtype, dev = qpT.Hb.dtype, qpT.Hb.device
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], qpT.Hb.shape[-1]
    if N < 2:
        raise ValueError("batch-native banded path requires horizon >= 2")
    n = N * w
    m_in = qpT.l.shape[0]
    qpT = qpT._replace(
        l=torch.minimum(qpT.l.to(dtype), qpT.u.to(dtype)),
        u=qpT.u.to(dtype),
        q=qpT.q.to(dtype),
    )
    x0T = torch.zeros((n, B), dtype=dtype, device=dev) if x0T is None else x0T.to(dtype)
    y0T = torch.zeros((m_in, B), dtype=dtype, device=dev) if y0T is None else y0T.to(dtype)
    qpT, y0T, had_r, had_r2 = _pad_sections_T(qpT, y0T, N, w)
    r = qpT.J0.shape[1]
    r2 = qpT.Jc.shape[1]
    nd = N - 1
    if scalingsT is not None and not (had_r and had_r2):
        # Precomputed E was built on the UNPADDED sections; insert unit
        # scalings for the inert rows _pad_sections_T added.
        D_, E_, c_ = scalingsT
        ones = lambda k: torch.ones((k, E_.shape[-1]), dtype=E_.dtype, device=dev)  # noqa: E731
        parts = [E_[:n]]
        if had_r:
            parts.append(E_[n : n + nd * r])
            sc_off = n + nd * r
        else:
            parts.append(ones(nd))
            sc_off = n
        parts.append(E_[sc_off:] if had_r2 else ones(N))
        scalingsT = (D_, torch.cat(parts, dim=0), c_)

    if scalingsT is not None:
        DT, ET, cT = (s.to(dtype) for s in scalingsT)
        scaled = _apply_scalings_T(qpT, DT, ET, cT, N, w, r, r2)
    else:
        scaled, DT, ET, cT = ruiz_equilibrate_banded_T(qpT, st.scaling_iters)
    # Elementwise ops keep their inputs' (possibly permuted) strides; the
    # kernel takes row-major batch-last arrays.
    scaled = BandedQP(*(a.contiguous() for a in scaled))
    scaled = scaled._replace(q=scaled.q.reshape(N, w, B))
    DT, ET, cT = DT.contiguous(), ET.contiguous(), cT.contiguous()
    cinv = 1.0 / cT
    DinvT, EinvT = 1.0 / DT, 1.0 / ET
    rho0 = _rho_vec(scaled.l, scaled.u, st.rho, dtype)

    if st.adaptive_rho:
        interval = max(st.adaptive_rho_interval, st.check_every)
        interval = ((interval + st.check_every - 1) // st.check_every) * st.check_every
    else:
        interval = st.max_iter

    x_s = x0T * DinvT  # scaled warm starts
    y_s = cT * y0T * EinvT
    # z initialised ONCE to clip(A x0, l, u) in scaled space and carried
    # through every chunk (A's x-section is the identity: Ex = 1/D).
    x3 = x_s.reshape(N, w, B)
    prob = BandedBatchProblem(
        scaled=scaled, D=DT, E=ET, c=cT, Dinv=DinvT, Einv=EinvT, cinv=cinv,
        rho=rho0, x=x_s, y=y_s, z=None, interval=interval,
        had_r=had_r, had_r2=had_r2,
    )
    lxT, ldT, lcT = prob.sections(scaled.l)
    uxT, udT, ucT = prob.sections(scaled.u)
    zx0 = torch.clip(x3, lxT, uxT)
    zd0 = torch.clip(
        torch.sum(scaled.J0 * x3[:-1, None, :, :], dim=2)
        + torch.sum(scaled.J1 * x3[1:, None, :, :], dim=2),
        ldT,
        udT,
    )
    zc0 = torch.clip(torch.sum(scaled.Jc * x3[:, None, :, :], dim=2), lcT, ucT)
    z_s = torch.cat(
        [zx0.reshape(n, B), zd0.reshape(nd * r, B), zc0.reshape(N * r2, B)], dim=0
    )
    return prob._replace(z=z_s)


def chunk_inputs(prob: BandedBatchProblem, st: ADMMSettings, it_b, stop, x, y, z, rho):
    """Positional and keyword arguments of one chunk launch
    for iterates ``x (n,B)``, ``y``/``z``/``rho`` ``(m,B)``, per-scenario
    ``it_b`` (int32) and ``stop`` (bool)."""
    s = prob.scaled
    N, w, B = s.q.shape
    lxT, ldT, lcT = prob.sections(s.l)
    uxT, udT, ucT = prob.sections(s.u)
    rxT, rdT, rcT = prob.sections(rho.contiguous())
    exT, edT, ecT = prob.sections(prob.Einv)
    bounds = {
        "lx": lxT, "ux": uxT, "rx": rxT,
        "ld": ldT, "ud": udT, "rd": rdT,
        "lc": lcT, "uc": ucT, "rc": rcT,
    }
    scale = {
        "ds": prob.Dinv.reshape(N, w, B), "ex": exT, "ed": edT, "ec": ecT,
        "ci": prob.cinv,
    }
    yx, yd, yc = prob.sections(y.contiguous())
    zx, zd, zc = prob.sections(z.contiguous())
    args = (
        it_b.to(torch.int32), stop.to(torch.int32),
        s.Hb, s.J0, s.J1, s.Jc, s.q, bounds, scale,
        x.contiguous().reshape(N, w, B), yx, yd, yc, zx, zd, zc,
    )
    kw = dict(
        interval=prob.interval,
        check_every=st.check_every,
        max_iter=st.max_iter,
        sigma=float(st.sigma),
        alpha=float(st.alpha),
        eps_abs=float(st.eps_abs),
        eps_rel=float(st.eps_rel),
    )
    return args, kw


def use_cr1(N: int, B: int) -> bool:
    """Whether the rolled chunk runs its depth-1 cyclic-reduction level:
    the JAX package's ``_use_cr1`` (even horizon, N >= 16, tile < 128) with
    the whole batch in place of the tile.  JAX's ``pick_rolled_tile``
    returns the whole batch for every B < 128 at quadrotor h100 and 128
    above, so both packages take the same elimination order at every
    batch the tests and the bench use.  Whether this card prefers the
    level at every B is not measured yet."""
    return N % 2 == 0 and N >= 16 and B < 128


def chunk_kernel(
    N: int, w: int, B: int, rolled: Optional[bool] = None, banded_solver: str = "thomas"
):
    """The chunk kernel for a batch, and its extra keyword arguments.

    ``banded_solver="cr"`` takes the cyclic-reduction kernel whatever
    ``rolled`` says (as the JAX driver does).  Otherwise ``rolled=True``
    forces the rolled two-way kernel, ``False`` the one-way kernel;
    ``None`` takes the one-way kernel where it is instantiated (``w`` in
    ``KERNEL_WIDTHS``) and the rolled one otherwise.  The rule does not
    look at the device: on the CPU the driver runs the plain version of
    the kernel the card would run."""
    if banded_solver == "cr":
        return banded_admm_chunk_cr, {}
    if rolled is None:
        rolled = w not in KERNEL_WIDTHS
    if rolled:
        return banded_admm_chunk_rolled, {"cr1": use_cr1(N, B)}
    return banded_admm_chunk, {}


def _solve_banded_batch_T(
    qpT: BandedQP, st: ADMMSettings, x0T, y0T, scalingsT, rolled: Optional[bool] = None,
    on_device: bool = False,
):
    """The driver.  ``on_device`` keeps the loop over chunks on the device:
    the first chunk, then (with adaptive rho) a ``torch.while_loop`` of
    chunks while any scenario is active; the same results as the host
    loop, and the form ``torch.export`` traces (the chunk kernel one op
    node).  With ``polish=True`` both forms end with the same batched
    polish (:func:`.admm_banded.banded_polish_T`)."""
    dtype, dev = qpT.Hb.dtype, qpT.Hb.device
    N, w, B = qpT.Hb.shape[0], qpT.Hb.shape[1], qpT.Hb.shape[-1]
    n = N * w
    prob = prepare_banded_batch_T(qpT, st, x0T, y0T, scalingsT)
    scaled = prob.scaled
    r, r2 = scaled.J0.shape[1], scaled.Jc.shape[1]
    nd = N - 1

    chunk_fn, chunk_kw = chunk_kernel(N, w, B, rolled, banded_solver=st.banded_solver)

    def chunk(it_b, done, pinf, dinf, rp, rd, x, y, z, rho):
        """One chunk launch and the work between chunks."""
        stop = done | pinf | dinf
        args, kw = chunk_inputs(prob, st, it_b, stop, x, y, z, rho)
        (xT2, yx2, yd2, yc2, zx2, zd2, zc2, kdone, it_inc,
         rp_k, rd_k, mp_k, md_k) = chunk_fn(*args, **kw, **chunk_kw)
        x_new = xT2.reshape(n, B)
        y_new = torch.cat(
            [yx2.reshape(n, B), yd2.reshape(nd * r, B), yc2.reshape(N * r2, B)], dim=0
        )
        z_new = torch.cat(
            [zx2.reshape(n, B), zd2.reshape(nd * r, B), zc2.reshape(N * r2, B)], dim=0
        )
        ran = torch.isfinite(rp_k)  # scenarios that advanced this chunk
        it_b = it_b + it_inc
        done = done | ((kdone == 1) & ~stop)
        rp = torch.where(ran, rp_k, rp)
        rd = torch.where(ran, rd_k, rd)
        if st.check_infeasibility:
            pinf_k, dinf_k = banded_certificates_T(
                scaled._replace(q=scaled.q.reshape(n, B)),
                x_new - x, y_new - y, prob.D, prob.E, prob.cinv, st,
            )
            pinf = pinf | (pinf_k & ran & ~done)
            dinf = dinf | (dinf_k & ran & ~done)
        if st.adaptive_rho:
            rp_rel = rp_k / torch.clamp(mp_k, min=1e-12)
            rd_rel = rd_k / torch.clamp(md_k, min=1e-12)
            scale = torch.sqrt(rp_rel / torch.clamp(rd_rel, min=1e-12))
            scale = torch.clamp(scale, 1e-3, 1e3)
            trigger = (
                ((scale > st.adaptive_rho_tolerance)
                 | (scale < 1.0 / st.adaptive_rho_tolerance))
                & ran & ~done & ~pinf & ~dinf
            )
            # The refactorization happens inside the kernel at the next
            # launch; updating rho is all the adaptation is.
            rho = torch.where(
                trigger[None, :],
                torch.clamp(rho * scale[None, :], _RHO_MIN, _RHO_MAX),
                rho,
            )
        return it_b, done, pinf, dinf, rp, rd, x_new, y_new, z_new, rho

    def active(it_b, done, pinf, dinf, *_):
        return (~(done | pinf | dinf) & (it_b < st.max_iter)).any()

    false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    inf_b = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    s = (torch.zeros((B,), dtype=torch.int32, device=dev), false_b, false_b, false_b,
         inf_b, inf_b, prob.x, prob.y, prob.z, prob.rho)
    if B > 0 and st.max_iter > 0:
        # The first chunk always runs; without adaptive rho its interval is
        # the whole budget and it is the only one.
        s = chunk(*s)
        if prob.interval < st.max_iter:
            if on_device:
                s = torch.while_loop(lambda *c: active(*c), lambda *c: _fresh(chunk(*c)),
                                     _fresh(s))
            else:
                while bool(active(*s)):
                    s = chunk(*s)
    it_b, done, pinf, dinf, rp, rd, x, y, z, rho = s

    if st.polish:
        # Opt-in: one batched pass over every scenario (plain PyTorch, as
        # the JAX driver's vmapped polish is plain jnp).
        x, y, z, rp, rd = banded_polish_T(
            scaled._replace(q=scaled.q.reshape(n, B)), st, x, y, z, rp, rd,
            prob.Einv, prob.Dinv, prob.cinv,
        )

    had_r, had_r2 = prob.had_r, prob.had_r2
    return (
        prob.D * x,
        _strip_sections_T(prob.E * y * prob.cinv, N, w, r, r2, had_r, had_r2),
        _strip_sections_T(z * prob.Einv, N, w, r, r2, had_r, had_r2),
        it_b,
        done,
        rp,
        rd,
        pinf,
        dinf,
    )


@f32_matmuls
def admm_solve_banded_batch_T(
    qpT: BandedQP,
    settings: ADMMSettings = ADMMSettings(),
    x0T: Optional[torch.Tensor] = None,  # (n, B) warm start
    y0T: Optional[torch.Tensor] = None,  # (m, B)
    scalingsT=None,  # optional precomputed (D (n,B), E (m,B), c (B,))
    device=None,
    rolled: Optional[bool] = None,
    on_device: bool = False,
):
    """Solve a batch of stage-structured QPs, batch-LAST: every field of
    ``qpT`` carries a trailing scenario axis (``Hb (N,w,w,B)``, ``q/l/u
    (rows, B)``); warm starts and returns are ``(rows, B)``.

    Runs on ``device`` (default: the GPU; inputs are moved there, numpy
    arrays converted as :func:`..device.as_tensors` converts them);
    ``rolled`` picks the chunk kernel (:func:`chunk_kernel`); ``on_device``
    keeps the chunk loop on the device (the same results; the form
    ``torch.export`` traces).  Returns ``(x (n,B), y (m,B), z (m,B),
    iters (B,), converged, r_prim, r_dual, prim_inf, dual_inf)``.
    """
    dev = resolve_device(device)
    mv = lambda a: None if a is None else a.to(dev)  # noqa: E731
    qpT = BandedQP(*(a.to(dev) for a in as_tensors(*qpT, device=dev)))
    x0T, y0T = as_tensors(x0T, y0T, device=dev)
    sc = None if scalingsT is None else tuple(mv(s) for s in as_tensors(*scalingsT, device=dev))
    return _solve_banded_batch_T(qpT, settings, mv(x0T), mv(y0T), sc, rolled, on_device)


@f32_matmuls
def admm_solve_banded_batch(
    qp: BandedQP,
    settings: ADMMSettings = ADMMSettings(),
    x0: Optional[torch.Tensor] = None,  # (B, n) warm start
    y0: Optional[torch.Tensor] = None,  # (B, m)
    scalings=None,  # optional precomputed (D (B,n), E (B,m), c (B,))
    device=None,
    rolled: Optional[bool] = None,
    on_device: bool = False,
) -> QPSolution:
    """Solve a BATCH of stage-structured QPs (leading dim B on every field).

    The batch-leading boundary: one transpose per array at entry and exit
    around :func:`admm_solve_banded_batch_T` (``on_device`` as there).
    Returns a :class:`QPSolution` with leading batch dims.
    """
    dev = resolve_device(device)
    qpT = BandedQP(*(_t(a.to(dev)) for a in as_tensors(*qp, device=dev)))
    x0, y0 = as_tensors(x0, y0, device=dev)
    scalings = None if scalings is None else as_tensors(*scalings, device=dev)
    x0T = None if x0 is None else x0.to(dev).T.contiguous()
    y0T = None if y0 is None else y0.to(dev).T.contiguous()
    scalingsT = (
        None if scalings is None
        else (_t(scalings[0].to(dev)), _t(scalings[1].to(dev)), scalings[2].to(dev))
    )
    xT, yT, zT, it_b, done, rp, rd, pinf, dinf = _solve_banded_batch_T(
        qpT, settings, x0T, y0T, scalingsT, rolled, on_device
    )
    return QPSolution(
        x=xT.T, y=yT.T, z=zT.T,
        iters=it_b, converged=done, r_prim=rp, r_dual=rd,
        prim_inf=pinf, dual_inf=dinf,
    )
