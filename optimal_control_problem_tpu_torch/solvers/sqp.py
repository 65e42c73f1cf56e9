"""SQP engine — port of ``optimal_control_problem_tpu/solvers/sqp.py`` for
the banded (stage-structured) QP method.

Reference semantics kept: a fixed number ``max_iter`` (``step_num``) of
damped steps ``x += alpha * dx`` whose directions come from local QPs built
on the exact objective Hessian (convexified per ``hessian_reg``) and the
linearized constraint stack ``l - c(x) <= A dx <= u - c(x)``; warm start
across calls from the persisted iterate (the incoming ``x0`` is ignored,
as in the reference); the optional ``||alpha*dx|| < tol`` early exit that
freezes the iterate.

Here the QP is always the reduced-formulation banded QP: per step the
batch-last stage derivatives (``stagewise.py``) feed
``admm_solve_banded_batch_T`` (one CUDA chunk launch per rho-constant
chunk) or, for one scenario, ``admm_solve_banded``.  The step loop is a
Python loop that enqueues device work without host synchronisation on the
non-adaptive banded path.

Not ported yet (ROADMAP Queue A): the dense/condensed QP paths
(``method="kkt"``/``"condensed"``), the augmented formulation and the
``parity`` preset, the shared-system (LTI) batched path, the merit line
search and ``Sym`` expression costs.  Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..sym import Sym
from .admm import ADMMSettings

__all__ = ["SQPOptions", "SQPResult", "SQPOptimizationSolver", "normalize_nlp"]


class SQPResult(NamedTuple):
    x: torch.Tensor  # final iterate (n_x,) or (B, n_x)
    f: torch.Tensor  # objective at final iterate
    qp_x: torch.Tensor  # last QP primal (for warm starting)
    qp_y: torch.Tensor  # last QP dual
    f_history: torch.Tensor  # objective after each SQP iteration (step_num, ...)
    qp_iters: torch.Tensor  # ADMM iterations per SQP step
    step_norms: torch.Tensor  # ||alpha*dx|| per SQP step
    qp_converged: torch.Tensor  # per-step QP status flags
    qp_prim_inf: torch.Tensor
    qp_dual_inf: torch.Tensor
    steps_taken: torch.Tensor  # SQP iterations actually applied


@dataclasses.dataclass(frozen=True)
class SQPOptions:
    """Options mirroring the reference's ctor dict (``max_iter``, ``alpha``,
    ``verbose``) plus the JAX package's extensions; see that module for
    each field's meaning."""

    max_iter: int = 10  # step_num
    alpha: float = 0.1
    verbose: bool = False
    formulation: str = "augmented"  # "augmented" (parity) | "reduced" (fast)
    qp_warm_start: bool = True
    dtype: Any = torch.float32
    admm: ADMMSettings = ADMMSettings()
    shared_system: Optional[bool] = None
    hessian_reg: Any = "auto"
    line_search: str = "none"
    ls_num: int = 8
    ls_alpha_max: float = 1.0
    ls_merit_mu: float = 10.0
    early_exit: Optional[bool] = None
    early_exit_tol: float = 1e-6


def normalize_nlp(nlp: Dict[str, Any]):
    """Normalize the reference-shaped nlp dict to callables.

    ``nlp`` keys: ``"x"`` (leaf :class:`Sym` or int size), ``"f"``
    (callable ``f(x, p)``), ``"g"`` (callable or None), ``"p"`` (leaf Sym,
    int size or None).  Returns ``(f_fn, g_fn, n_x, n_p, n_g)``.
    ``Sym`` expression costs/constraints are not ported yet.
    """
    if "x" not in nlp:
        raise ValueError("optimization variable 'x' not defined")
    if "f" not in nlp:
        raise ValueError("objective 'f' not defined")

    xspec = nlp["x"]
    pspec = nlp.get("p", None)
    if isinstance(xspec, Sym):
        n_x = xspec.size1()
        if xspec.name is None:
            raise ValueError("'x' must be a leaf symbol")
    else:
        n_x = int(xspec)
    if pspec is None:
        n_p = 0
    elif isinstance(pspec, Sym):
        n_p = pspec.size1()
    else:
        n_p = int(pspec)

    def wrap(fn_raw, out_scalar):
        if fn_raw is None:
            return None
        if isinstance(fn_raw, Sym):
            raise NotImplementedError(
                "Sym expression costs/constraints are not ported yet "
                "(ROADMAP Queue A5); pass torch callables fn(x, p)"
            )

        def fn(x, p):
            out = torch.as_tensor(fn_raw(x, p))
            return out.reshape(()) if out_scalar else out.reshape(-1)

        return fn

    f_fn = wrap(nlp["f"], True)
    g_fn = wrap(nlp.get("g", None), False)
    if g_fn is None:
        n_g = 0
    else:
        n_g = int(
            g_fn(torch.zeros((n_x,), dtype=torch.float64),
                 torch.zeros((n_p,), dtype=torch.float64)).shape[0]
        )
    return f_fn, g_fn, n_x, n_p, n_g


class SQPOptimizationSolver:
    """Stateful SQP solver with the reference-parity API, banded QP method.

    ``solve_fn`` (one scenario) and ``solve_batch_banded_fn`` (a batch,
    batch-leading arguments) are the functional cores; ``BatchedSolver``
    drives the latter.
    """

    def __init__(
        self,
        nlp: Dict[str, Any],
        options: Optional[Dict | SQPOptions] = None,
        local_system_parts=None,
        stage_structure=None,
        device=None,
    ):
        if options is None:
            options = SQPOptions()
        elif isinstance(options, dict):
            known = {f.name for f in dataclasses.fields(SQPOptions)}
            options = SQPOptions(**{k: v for k, v in options.items() if k in known})
        self.options = options
        self.device = resolve_device(device)
        self.f_fn, self.g_fn, self.n_x, self.n_p, self.n_g = normalize_nlp(nlp)
        self.dtype = options.dtype
        self._verbose = options.verbose

        if options.admm.method != "banded":
            raise NotImplementedError(
                f"ADMM method {options.admm.method!r} is not ported yet: the "
                "port runs the banded method (ROADMAP Queue A8: dense/LTI paths)"
            )
        if stage_structure is None:
            raise ValueError(
                "ADMM method 'banded' requires a stage structure "
                "(OptimalControlProblem.set_stage_structure)"
            )
        if options.formulation != "reduced" or local_system_parts is None:
            raise NotImplementedError(
                "the banded port needs formulation='reduced' with stage-wise "
                "local-system parts (augmented formulation: ROADMAP Queue A6)"
            )
        if options.line_search != "none":
            raise NotImplementedError(
                f"line_search={options.line_search!r} is not ported yet "
                "(ROADMAP Queue A6: merit line search)"
            )
        if options.shared_system:
            raise NotImplementedError(
                "shared_system is not ported yet (ROADMAP Queue A8: LTI slice)"
            )
        self._parts = local_system_parts
        self.stage_structure = stage_structure
        self._qp_n = self.n_x
        self._qp_m = self._qp_n + self.n_g

        self.solve_fn = self._build_solve_banded_fn()
        self.solve_batch_banded_fn = self._build_solve_banded_batch_fn()
        self.last_result = None
        self.reset()

    # ------------------------------------------------------------------
    def _early_exit(self):
        """Resolve the early-exit policy to a static (enabled, tol) pair:
        ``early_exit=None`` ties it to ``verbose`` like the reference."""
        opt = self.options
        enabled = opt.verbose if opt.early_exit is None else bool(opt.early_exit)
        return enabled, float(opt.early_exit_tol)

    def _make_step_rule(self):
        """``step(x, dx) -> (x_new, ||alpha*dx||)`` — the reference's fixed
        damped update, batched over any leading dims."""
        if self.options.line_search != "none":
            raise NotImplementedError("merit line search is not ported yet")
        alpha = self.options.alpha

        def step(x, dx):
            return x + alpha * dx, torch.linalg.vector_norm(alpha * dx, dim=-1)

        return step

    def _build_solve_banded_fn(self):
        """Single-scenario solve with the per-scenario banded ADMM."""
        from ..stagewise import build_stage_blocks
        from .admm_banded import BandedQP, admm_solve_banded

        opt = self.options
        dtype = opt.dtype
        _, _, vectors, stack_bounds = self._parts
        blocks = build_stage_blocks(self.stage_structure, dtype, opt.hessian_reg)
        f_fn = self.f_fn
        step = self._make_step_rule()
        early, tol = self._early_exit()

        def solve(x_init, p, lbx, ubx, lbg, ubg, qp_x0, qp_y0):
            x = x_init.to(dtype)
            p = p.to(dtype)
            lower, upper = stack_bounds(p, lbx, ubx, lbg, ubg)
            qpx, qpy = qp_x0, qp_y0
            stop = torch.zeros((), dtype=torch.bool, device=x.device)
            hist = []
            for _ in range(opt.max_iter):
                grad, cval = vectors(x, p)
                qp = BandedQP(*blocks(x, p), q=grad, l=lower - cval, u=upper - cval)
                sol = admm_solve_banded(
                    qp, opt.admm,
                    x0=qpx if opt.qp_warm_start else None,
                    y0=qpy if opt.qp_warm_start else None,
                )
                x_new, step_norm = step(x, sol.x)
                qp_it = sol.iters
                if early:
                    x_new = torch.where(stop, x, x_new)
                    qpx = torch.where(stop, qpx, sol.x)
                    qpy = torch.where(stop, qpy, sol.y)
                    qp_it = torch.where(stop, torch.zeros_like(qp_it), qp_it)
                    step_norm = torch.where(stop, torch.zeros_like(step_norm), step_norm)
                    took = ~stop
                    stop = stop | (step_norm < tol)
                else:
                    qpx, qpy = sol.x, sol.y
                    took = torch.ones((), dtype=torch.bool, device=x.device)
                x = x_new
                hist.append((f_fn(x, p), qp_it, step_norm, sol.converged,
                             sol.prim_inf, sol.dual_inf, took))
            return _result(x, qpx, qpy, hist)

        return solve

    def _build_solve_banded_batch_fn(self):
        """Batched banded solve: ``(x (B,nx), p (B,np), lbx (B,nx), ubx,
        lbg (B,ng), ubg, qp_x (B,qn), qp_y (B,qm)) -> SQPResult`` with
        leading batch dims.  Per step: batch-last stage derivatives, then
        ``admm_solve_banded_batch_T`` — one chunk launch for the whole
        batch (per rho-constant chunk)."""
        from ..stagewise import build_stage_blocks_batch, build_stage_vectors_batch
        from .admm_banded import BandedQP
        from .admm_banded_batch import _solve_banded_batch_T, ruiz_scalings_batch_T

        opt = self.options
        ss = self.stage_structure
        admm_settings = opt.admm
        dtype = opt.dtype
        _, _, _, stack_bounds = self._parts
        blocks_T = build_stage_blocks_batch(ss, dtype, opt.hessian_reg)
        vectors_T = build_stage_vectors_batch(ss, dtype)
        f_b = torch.func.vmap(self.f_fn)
        step = self._make_step_rule()
        early, tol = self._early_exit()

        def solve_batch(x_init, p, lbx, ubx, lbg, ubg, qp_x0, qp_y0):
            x = x_init.to(dtype)
            p = p.to(dtype)
            # Iterate-independent bound stack, hoisted out of the step loop
            # (only the shift by c(x_k) changes per step).
            lower, upper = stack_bounds(p, lbx, ubx, lbg, ubg)
            lowerT, upperT = lower.T.contiguous(), upper.T.contiguous()
            pT = p.T.contiguous()

            def build_qp_T(x):
                xT = x.T.contiguous()
                HbT, J0T, J1T, JcT = blocks_T(xT, pT)
                gradT, cvalT = vectors_T(xT, pT)
                return BandedQP(
                    Hb=HbT, J0=J0T, J1=J1T, Jc=JcT,
                    q=gradT, l=lowerT - cvalT, u=upperT - cvalT,
                )

            if admm_settings.scaling_refresh == "tick":
                # Equilibrate ONCE against the first linearization and reuse
                # the factors for every step's QP.
                scalingsT = ruiz_scalings_batch_T(
                    build_qp_T(x), admm_settings.scaling_iters
                )
            else:
                scalingsT = None

            qpxT, qpyT = qp_x0.T.contiguous(), qp_y0.T.contiguous()
            stop = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
            hist = []
            for _ in range(opt.max_iter):
                (sxT, syT, _szT, s_iters, s_conv, _rp, _rd, s_pinf, s_dinf) = (
                    _solve_banded_batch_T(
                        build_qp_T(x),
                        admm_settings,
                        qpxT if opt.qp_warm_start else None,
                        qpyT if opt.qp_warm_start else None,
                        scalingsT,
                    )
                )
                x_new, step_norm = step(x, sxT.T)
                qp_it = s_iters
                if early:
                    x_new = torch.where(stop[:, None], x, x_new)
                    qpxT = torch.where(stop[None, :], qpxT, sxT)
                    qpyT = torch.where(stop[None, :], qpyT, syT)
                    qp_it = torch.where(stop, torch.zeros_like(qp_it), qp_it)
                    step_norm = torch.where(stop, torch.zeros_like(step_norm), step_norm)
                    took = ~stop
                    stop = stop | (step_norm < tol)
                else:
                    qpxT, qpyT = sxT, syT
                    took = torch.ones_like(stop)
                x = x_new
                hist.append((f_b(x, p), qp_it, step_norm, s_conv, s_pinf, s_dinf, took))
            return _result(x, qpxT.T, qpyT.T, hist)

        return solve_batch

    # -- reference-parity stateful API ----------------------------------
    def get_optimal_solution(self, arg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Run ``step_num`` SQP iterations from the persisted iterate
        (``arg["x0"]`` is ignored, as in the reference).  Pass
        ``lbx/ubx/lbg/ubg`` and optionally ``p``."""
        dt, dev = self.dtype, self.device
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev).reshape(-1)  # noqa: E731
        lbx, ubx = as_t(arg["lbx"]), as_t(arg["ubx"])
        p = as_t(arg.get("p", np.zeros((self.n_p,))))
        lbg = as_t(arg.get("lbg", np.zeros((0,))))
        ubg = as_t(arg.get("ubg", np.zeros((0,))))
        if lbx.shape[0] != self.n_x or ubx.shape[0] != self.n_x:
            raise ValueError(
                f"lbx/ubx must have size {self.n_x}, got {lbx.shape[0]}/{ubx.shape[0]}"
            )
        if lbg.shape[0] != self.n_g or ubg.shape[0] != self.n_g:
            raise ValueError(
                f"lbg/ubg must have size {self.n_g}, got {lbg.shape[0]}/{ubg.shape[0]}"
            )
        if p.shape[0] != self.n_p:
            raise ValueError(f"p must have size {self.n_p}, got {p.shape[0]}")
        res = self.solve_fn(self._result_x, p, lbx, ubx, lbg, ubg, self._qp_x, self._qp_y)
        self._result_x, self._result_f = res.x, res.f
        self._qp_x, self._qp_y = res.qp_x, res.qp_y
        self.last_result = res
        if self._verbose:
            taken = int(res.steps_taken) or self.options.max_iter
            print("=== SQP done ===")
            print(f"  iterations: {taken}/{self.options.max_iter}, alpha: {self.options.alpha}")
            print(f"  qp iters per step: {res.qp_iters.cpu().numpy()}")
            print(f"  f history: {res.f_history.cpu().numpy()}")
        return {"x": res.x, "f": res.f}

    def reset(self) -> None:
        """Clear the persistent iterate back to zeros (fresh ``result_``)."""
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)  # noqa: E731
        self._result_x = z(self.n_x)
        self._result_f = z()
        self._qp_x = z(self._qp_n)
        self._qp_y = z(self._qp_m)


def _result(x, qpx, qpy, hist) -> SQPResult:
    """Stack the per-step records ``(f, qp_iters, step_norm, converged,
    prim_inf, dual_inf, took)`` into an :class:`SQPResult`."""
    f_hist, qp_iters, norms, conv, pinf, dinf, took = (
        torch.stack(c) for c in zip(*hist)
    )
    return SQPResult(
        x=x,
        f=f_hist[-1],
        qp_x=qpx,
        qp_y=qpy,
        f_history=f_hist,
        qp_iters=qp_iters,
        step_norms=norms,
        qp_converged=conv,
        qp_prim_inf=pinf,
        qp_dual_inf=dinf,
        steps_taken=torch.sum(took.to(torch.int32), dim=0),
    )
