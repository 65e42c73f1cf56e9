"""SQP engine — port of ``optimal_control_problem_tpu/solvers/sqp.py``.

Reference semantics kept: a fixed number ``max_iter`` (``step_num``) of
damped steps ``x += alpha * dx`` whose directions come from local QPs built
on the exact objective Hessian (convexified per ``hessian_reg``) and the
linearized constraint stack ``l - c <= A dz <= u - c``; the augmented
formulation (the reference's: ``dz = [dp; dx]``, the stack ``[p; x; g]``,
identity rows pinning ``dp = 0``) or the reduced one (``dp`` eliminated);
warm start across calls from the persisted iterate (the incoming ``x0`` is
ignored, as in the reference); the optional ``||alpha*dx|| < tol`` early
exit that freezes the iterate; and the opt-in merit line search (``ls_num``
geometric candidates against an L1 exact-penalty merit, all evaluated in
one ``torch.func.vmap``).

Four QP paths, each a Python step loop that enqueues device work:

* **banded** (``method="banded"``, stage-structured problems): per step the
  batch-last stage derivatives (``stagewise.py``) feed
  ``admm_solve_banded_batch_T`` (one CUDA chunk launch per rho-constant
  chunk) or, for one scenario, ``admm_solve_banded``;
* **dense, per problem** (``method="kkt"`` / ``"condensed"``): ``solve_fn``
  assembles the dense local QP with ``torch.func`` (``hessian``, ``jacfwd``,
  ``grad``; or stage-wise, ``stagewise.build_stagewise_parts``) and calls
  ``admm_solve``;
* **shared system** (the same methods on an LQ/LTI problem, detected by
  probing whether ``(H, A)`` depend on the point): ``solve_batch_fn``
  factors one operator for the whole batch and all steps
  (``admm_batched.py``) and maps only the per-scenario vectors with
  ``torch.func.vmap``;
* **dense, per scenario** (the same methods on any other problem):
  ``solve_batch_dense_fn``, the port of ``jax.vmap(solve_fn)``, maps the
  dense assembly with ``torch.func.vmap`` and solves the batch of local QPs
  with ``admm_solve_batch`` (with ``backend="pallas"``, one launch of the
  device-loop kernel per step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..sym import Sym, evaluate
from .admm import ADMMSettings, admm_solve, admm_solve_batch, f32_matmuls

__all__ = [
    "SQPOptions",
    "SQPResult",
    "SQPOptimizationSolver",
    "normalize_nlp",
    "build_local_system_fn",
    "build_local_system_parts",
]


class SQPResult(NamedTuple):
    x: torch.Tensor  # final iterate (n_x,) or (B, n_x)
    f: torch.Tensor  # objective at final iterate
    qp_x: torch.Tensor  # last QP primal (for warm starting)
    qp_y: torch.Tensor  # last QP dual
    f_history: torch.Tensor  # objective after each SQP iteration (step_num, ...)
    qp_iters: torch.Tensor  # ADMM iterations per SQP step
    step_norms: torch.Tensor  # ||alpha*dx|| per SQP step
    # Per-step QP status flags and the SQP iterations actually applied;
    # empty / 0-d by default, as in the JAX package, for a result built
    # from the first seven fields.
    qp_converged: torch.Tensor = torch.zeros((0,), dtype=torch.bool)
    qp_prim_inf: torch.Tensor = torch.zeros((0,), dtype=torch.bool)
    qp_dual_inf: torch.Tensor = torch.zeros((0,), dtype=torch.bool)
    steps_taken: torch.Tensor = torch.zeros((), dtype=torch.int32)


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

    @classmethod
    def parity(cls, **overrides) -> "SQPOptions":
        """Reference-parity preset: the augmented ``z = [p; x]`` formulation,
        the raw objective Hessian (``hessian_reg`` 0.0), the fixed damped
        step ``alpha`` 0.1 x 10 with no line search, early exit tied to
        ``verbose``, the per-scenario QP path (no shared-factorization
        shortcut) and cold-started QPs (the reference re-creates its QP
        workspace every SQP iteration).  Override any field by keyword."""
        base = dict(
            formulation="augmented",
            hessian_reg=0.0,
            line_search="none",
            alpha=0.1,
            max_iter=10,
            shared_system=False,
            qp_warm_start=False,
        )
        base.update(overrides)
        return cls(**base)


def normalize_nlp(nlp: Dict[str, Any]):
    """Normalize the reference-shaped nlp dict to callables.

    ``nlp`` keys: ``"x"`` (leaf :class:`Sym` or int size), ``"f"`` (scalar
    :class:`Sym` or callable ``f(x, p)``), ``"g"`` (:class:`Sym`, callable
    or None), ``"p"`` (leaf Sym, int size or None).  Returns ``(f_fn, g_fn,
    n_x, n_p, n_g)`` with ``f_fn(x, p) -> scalar`` and ``g_fn(x, p) ->
    (n_g,)`` (``g_fn`` is None when there are no constraints).
    """
    if "x" not in nlp:
        raise ValueError("optimization variable 'x' not defined")
    if "f" not in nlp:
        raise ValueError("objective 'f' not defined")

    xspec = nlp["x"]
    pspec = nlp.get("p", None)
    if isinstance(xspec, Sym):
        n_x, x_name = xspec.size1(), xspec.name
        if x_name is None:
            raise ValueError("'x' must be a leaf symbol")
    else:
        n_x, x_name = int(xspec), None
    if pspec is None:
        n_p, p_name = 0, None
    elif isinstance(pspec, Sym):
        n_p, p_name = pspec.size1(), pspec.name
    else:
        n_p, p_name = int(pspec), None

    def wrap(spec, out_scalar):
        if spec is None:
            return None
        if isinstance(spec, Sym):
            if x_name is None:
                raise ValueError("Sym expressions require 'x' to be a leaf symbol")

            def fn(x, p):
                env = {x_name: x}
                if p_name:
                    env[p_name] = p
                out = evaluate(spec, env)
                return out[0] if out_scalar else out

            return fn

        def fn(x, p):
            out = torch.as_tensor(spec(x, p))
            return out.reshape(()) if out_scalar else out.reshape(-1)

        return fn

    f_fn = wrap(nlp["f"], True)
    gspec = nlp.get("g", None)
    if isinstance(gspec, Sym) and gspec.size1() == 0:
        gspec = None
    g_fn = wrap(gspec, False)
    if g_fn is None:
        n_g = 0
    elif isinstance(gspec, Sym):
        n_g = gspec.size1()
    else:
        n_g = int(
            g_fn(torch.zeros((n_x,), dtype=torch.float64),
                 torch.zeros((n_p,), dtype=torch.float64)).shape[0]
        )
    return f_fn, g_fn, n_x, n_p, n_g


def build_local_system_parts(
    f_fn: Callable,
    g_fn: Optional[Callable],
    n_x: int,
    n_p: int,
    n_g: int,
    formulation: str,
    dtype,
    hessian_reg="auto",
):
    """Composable pieces of the dense local-QP assembly.

    Returns ``(matrices, matrices_raw, vectors, stack_bounds)``:

    * ``matrices(x, p) -> (H, A)`` — regularized objective Hessian and the
      linearized constraint-stack Jacobian;
    * ``matrices_raw(x, p) -> (H, A)`` — the same without Hessian
      regularization (used for shared-system detection/extraction, where
      the shift is applied on the host instead);
    * ``vectors(x, p) -> (grad, cval)`` — objective gradient and the value
      of the constraint stack ``c`` at the point;
    * ``stack_bounds(p, lbx, ubx, lbg, ubg) -> (lower, upper)`` — the raw
      (un-shifted) bound stack; batched inputs work too (it concatenates
      along the last axis).

    Augmented: the QP variable is ``z = [p; x]``, ``c = [z; g]`` and the
    bound stack ``[p; lbx; lbg]`` / ``[p; ubx; ubg]`` (identity rows pin
    ``dp = 0``); the Hessian, and its regularization, cover the whole of
    ``z``.  Reduced: ``c = [x; g]`` over ``x`` alone.

    Derivatives come from ``torch.func``; every output is cast back to
    ``dtype`` (forward mode promotes ``tensor / python_float`` tangents to
    float64).
    """
    if formulation not in ("augmented", "reduced"):
        raise ValueError(f"unknown formulation {formulation!r}")
    hessian, jacfwd, grad = torch.func.hessian, torch.func.jacfwd, torch.func.grad

    def _regularize(H):
        """Convexify an indefinite objective Hessian (SQPOptions.hessian_reg):
        "auto" shifts by a Gershgorin lower bound on the minimum eigenvalue,
        "eigh" by the exact minimum eigenvalue, a float adds a fixed
        multiple of identity, 0.0 reproduces the reference exactly."""
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        if hessian_reg == "auto":
            Hs = 0.5 * (H + H.T)
            diag = torch.diagonal(Hs)
            offsum = torch.sum(torch.abs(Hs), dim=1) - torch.abs(diag)
            bound = torch.min(diag - offsum)  # Gershgorin: lambda_min >= bound
            return H + torch.clamp(1e-6 - bound, min=0.0) * eye
        if hessian_reg == "eigh":
            w_min = torch.linalg.eigvalsh(0.5 * (H + H.T))[0]
            return H + torch.clamp(1e-6 - w_min, min=0.0) * eye
        reg = float(hessian_reg)
        return H + reg * eye if reg > 0.0 else H

    if formulation == "augmented":
        nz = n_p + n_x

        def f_z(z):
            return f_fn(z[n_p:], z[:n_p])

        def c_z(z):
            return z if g_fn is None else torch.cat([z, g_fn(z[n_p:], z[:n_p])])

        def matrices_raw(x, p):
            z = torch.cat([p, x]).to(dtype)
            H = hessian(f_z)(z).to(dtype)
            if g_fn is None:
                A = torch.eye(nz, dtype=dtype, device=z.device)
            else:
                A = jacfwd(c_z)(z).to(dtype)
            return H, A

        def vectors(x, p):
            z = torch.cat([p, x]).to(dtype)
            return grad(f_z)(z).to(dtype), c_z(z).to(dtype)

        def stack_bounds(p, lbx, ubx, lbg, ubg):
            return (
                torch.cat([p, lbx, lbg], dim=-1).to(dtype),
                torch.cat([p, ubx, ubg], dim=-1).to(dtype),
            )

    else:

        def matrices_raw(x, p):
            x = x.to(dtype)
            H = hessian(lambda xx: f_fn(xx, p))(x).to(dtype)
            A = torch.eye(n_x, dtype=dtype, device=x.device)
            if g_fn is not None:
                J = jacfwd(lambda xx: g_fn(xx, p))(x).to(dtype)
                A = torch.cat([A, J], dim=0)
            return H, A

        def vectors(x, p):
            x = x.to(dtype)
            g = grad(lambda xx: f_fn(xx, p))(x).to(dtype)
            cval = x if g_fn is None else torch.cat([x, g_fn(x, p).to(dtype)])
            return g, cval

        def stack_bounds(p, lbx, ubx, lbg, ubg):
            return (
                torch.cat([lbx, lbg], dim=-1).to(dtype),
                torch.cat([ubx, ubg], dim=-1).to(dtype),
            )

    def matrices(x, p):
        H, A = matrices_raw(x, p)
        return _regularize(H), A

    return matrices, matrices_raw, vectors, stack_bounds


def build_local_system_fn(
    f_fn: Callable,
    g_fn: Optional[Callable],
    n_x: int,
    n_p: int,
    n_g: int,
    formulation: str,
    dtype,
    hessian_reg="auto",
):
    """The local-QP assembly, the analog of the reference's
    ``localSystemFunction_`` (``SQPOptimizationSolver.cpp:74-77``): maps
    ``(x, p, lbx, ubx, lbg, ubg) -> (H, grad, A, l - c, u - c)``, with the
    derivatives of :func:`build_local_system_parts`."""
    return _local_system(build_local_system_parts(
        f_fn, g_fn, n_x, n_p, n_g, formulation, dtype, hessian_reg
    ))


def _local_system(parts):
    """``(x, p, lbx, ubx, lbg, ubg) -> (H, grad, A, l - c, u - c)`` from the
    ``(matrices, matrices_raw, vectors, stack_bounds)`` parts."""
    matrices, _, vectors, stack_bounds = parts

    def local_system(x, p, lbx, ubx, lbg, ubg):
        H, A = matrices(x, p)
        grad, cval = vectors(x, p)
        lower, upper = stack_bounds(p, lbx, ubx, lbg, ubg)
        return H, grad, A, lower - cval, upper - cval

    return local_system


class SQPOptimizationSolver:
    """Stateful solver with the reference-parity API.

    The functional cores: ``solve_fn`` (one scenario), and for a batch
    (batch-leading arguments) ``solve_batch_fn`` (shared-system problems),
    ``solve_batch_banded_fn`` (``method="banded"``) or
    ``solve_batch_dense_fn`` (every other problem); ``BatchedSolver``
    drives the batch ones.
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
        banded = options.admm.method == "banded"

        self._custom_parts = local_system_parts is not None
        if local_system_parts is not None:
            # Structured override (stagewise.py): the caller supplies the
            # (matrices, matrices_raw, vectors, stack_bounds) tuple.
            if options.formulation != "reduced":
                raise ValueError("custom local_system_parts require formulation='reduced'")
            self._parts = local_system_parts
        else:
            # A banded solver on a stage structure takes only ``vectors``
            # and ``stack_bounds`` from the dense parts.
            self._parts = build_local_system_parts(
                self.f_fn, self.g_fn, self.n_x, self.n_p, self.n_g,
                options.formulation, self.dtype, options.hessian_reg,
            )
        self.stage_structure = stage_structure
        if banded and stage_structure is None:
            raise ValueError(
                "ADMM method 'banded' requires a stage structure "
                "(OptimalControlProblem.set_stage_structure)"
            )
        # Augmented: the QP variable is [dp; dx], dx from offset n_p on.
        self._x_at = self.n_p if options.formulation == "augmented" else 0
        self._qp_n = self._x_at + self.n_x
        self._qp_m = self._qp_n + self.n_g

        if options.line_search != "none":
            # The shared-factorization batch path takes the fixed reference
            # update only; a line search runs per scenario.
            self.shared_system = False
        elif options.shared_system is None and not banded:
            self.shared_system = self._detect_shared_system()
        else:
            self.shared_system = bool(options.shared_system)
        self._step = self._make_step_rule()

        self.solve_fn = self._build_solve_banded_fn() if banded else self._build_solve_fn()
        # Shared-system (LTI) batch path: one factorization for the whole
        # batch and every step (admm_batched.py).
        self.solve_batch_fn = self._build_solve_batch_fn() if self.shared_system else None
        # Batch-native banded path: the whole scenario batch iterates inside
        # the fused batch-last chunk kernel (admm_banded_batch.py).
        self.solve_batch_banded_fn = self._build_solve_banded_batch_fn() if banded else None
        # Per-scenario dense batch path: each scenario's own local QP.
        self.solve_batch_dense_fn = (
            None if banded or self.shared_system else self._build_solve_dense_batch_fn()
        )
        self.last_result = None
        self.reset()

    # -- shared-system (LTI) detection ------------------------------------
    def _detect_shared_system(self) -> bool:
        """Probe whether (H, A) are independent of the evaluation point.

        True for LQ/LTI problems (quadratic costs, linear dynamics), which
        unlocks the shared-factorization batched ADMM (admm_batched.py).
        Probing evaluates the matrices at two random points — exact for
        polynomial costs and constraints.
        """
        matrices_raw = self._parts[1]
        rng = np.random.default_rng(12345)
        outs = []
        for _ in range(2):
            x, p = (
                torch.as_tensor(rng.normal(size=(k,)) * 0.7, dtype=self.dtype, device=self.device)
                for k in (self.n_x, self.n_p)
            )
            outs.append(matrices_raw(x, p))
        (H1, A1), (H2, A2) = outs
        return bool(
            torch.allclose(H1, H2, rtol=1e-4, atol=1e-5)
            and torch.allclose(A1, A2, rtol=1e-4, atol=1e-5)
        )

    # ------------------------------------------------------------------
    def _early_exit(self):
        """Resolve the early-exit policy to a static (enabled, tol) pair:
        ``early_exit=None`` ties it to ``verbose`` like the reference."""
        opt = self.options
        enabled = opt.verbose if opt.early_exit is None else bool(opt.early_exit)
        return enabled, float(opt.early_exit_tol)

    def _make_step_rule(self):
        """``step(x, dx, p, lbx, ubx, lbg, ubg) -> (x_new, step_norm)`` for
        one scenario.

        "none" is the reference's fixed damped update ``x + alpha * dx``;
        "merit" evaluates ``ls_num`` geometric candidates ``ls_alpha_max *
        2^-k`` against the L1 exact-penalty merit ``f + mu * violation`` in
        one ``torch.func.vmap`` and takes the first smallest (``argmin``: a
        NaN merit counts as smallest, as in JAX)."""
        opt = self.options
        if opt.line_search == "none":
            alpha = opt.alpha

            def step(x, dx, p, lbx, ubx, lbg, ubg):
                return x + alpha * dx, torch.linalg.vector_norm(alpha * dx, dim=-1)

            return step
        if opt.line_search != "merit":
            raise ValueError(
                f"unknown line_search: {opt.line_search!r} (use 'none' or 'merit')"
            )
        f_fn, g_fn, n_g = self.f_fn, self.g_fn, self.n_g
        mu = opt.ls_merit_mu
        al = torch.as_tensor(opt.ls_alpha_max * (0.5 ** np.arange(opt.ls_num)),
                             dtype=self.dtype, device=self.device)

        def step(x, dx, p, lbx, ubx, lbg, ubg):
            cand = x[None, :] + al[:, None] * dx[None, :]

            def merit(xc):
                # max(-inf, 0) = 0: infinite bounds contribute nothing.
                viol = torch.sum(torch.clamp(lbx - xc, min=0.0) + torch.clamp(xc - ubx, min=0.0))
                if n_g:
                    gv = g_fn(xc, p)
                    viol = viol + torch.sum(
                        torch.clamp(lbg - gv, min=0.0) + torch.clamp(gv - ubg, min=0.0)
                    )
                return f_fn(xc, p) + mu * viol

            a = al[torch.argmin(torch.func.vmap(merit)(cand))]
            return x + a * dx, torch.linalg.vector_norm(a * dx)

        return step

    def _step_batch(self):
        """The step rule over a leading batch axis: the fixed update is
        batched as it stands, the merit search mapped with
        ``torch.func.vmap`` (candidates x scenarios in one nested map)."""
        if self.options.line_search == "none":
            return self._step
        return torch.func.vmap(self._step)

    def _build_solve_fn(self, export: bool = False):
        """Single-scenario solve on the dense local QP: per step the
        ``torch.func`` assembly, then :func:`.admm.admm_solve`.

        The function carries ``export_form``: its twin for ``torch.export``
        (``utils/serialization.export_solver``), built with ``export=True``
        — the ADMM loop (the device-loop kernel's op at
        ``backend="pallas"``) and the early exit decided on the device, the
        :class:`SQPResult` fields returned as a tuple; the same results."""
        opt = self.options
        dtype = opt.dtype
        f_fn = self.f_fn
        matrices, _, vectors, stack_bounds = self._parts
        step = self._step
        x_at = self._x_at
        early, tol = self._early_exit()

        @f32_matmuls
        def solve(x_init, p, lbx, ubx, lbg, ubg, qp_x0, qp_y0):
            x = x_init.to(dtype)
            p = p.to(dtype)
            lower, upper = stack_bounds(p, lbx, ubx, lbg, ubg)
            qpx, qpy = qp_x0, qp_y0
            stop = torch.zeros((), dtype=torch.bool, device=x.device) if export else False
            hist = []
            for _ in range(opt.max_iter):
                H, A = matrices(x, p)
                grad, cval = vectors(x, p)
                sol = admm_solve(
                    H, grad, A, lower - cval, upper - cval, opt.admm,
                    x0=qpx if opt.qp_warm_start else None,
                    y0=qpy if opt.qp_warm_start else None,
                    on_device=export,
                )
                x_new, step_norm = step(x, sol.x[x_at:], p, lbx, ubx, lbg, ubg)
                qp_it = sol.iters
                if export:
                    # The host `break` below as a freeze on the device.
                    took = ~stop
                    x_new = torch.where(stop, x, x_new)
                    qp_it = torch.where(stop, torch.zeros_like(qp_it), qp_it)
                    step_norm = torch.where(stop, torch.zeros_like(step_norm), step_norm)
                    qpx = torch.where(stop, qpx, sol.x)
                    qpy = torch.where(stop, qpy, sol.y)
                    if early:
                        stop = stop | (step_norm < tol)
                else:
                    took = torch.as_tensor(not stop, device=x.device)
                    if stop:
                        # Frozen after the ||alpha*dx|| < tol break: the
                        # same results as the reference's loop `break`.
                        x_new, qp_it = x, torch.zeros_like(qp_it)
                        step_norm = torch.zeros_like(step_norm)
                    else:
                        qpx, qpy = sol.x, sol.y
                        stop = early and bool(step_norm < tol)
                x = x_new
                hist.append((f_fn(x, p), qp_it, step_norm, sol.converged, sol.prim_inf,
                             sol.dual_inf, took))
            res = _result(x, qpx, qpy, hist)
            return tuple(res) if export else res

        if not export:
            solve.export_form = self._build_solve_fn(export=True)
        return solve

    def _build_solve_batch_fn(self, export: bool = False):
        """Batched solve over B scenarios sharing the QP matrices.

        Signature: ``(x (B,nx), p (B,np), lbx (B,nx), ubx, lbg (B,ng), ubg,
        qp_x (B,qn), qp_y (B,qm)) -> SQPResult`` with leading batch dims
        (``qp_iters`` is one count per step: the batch iterates together).
        Each step calls the shared-factorization ADMM (admm_batched.py).
        ``export_form`` (built with ``export=True``) is its twin for
        ``torch.export``: the ADMM loop on the device (the shared chunk
        kernel's op at ``backend="pallas"``), the fields as a tuple; the
        same results.
        """
        from .admm_batched import admm_iterate_prepared, prepare_shared

        opt = self.options
        dtype, dev = opt.dtype, self.device
        _, matrices_raw, vectors, stack_bounds = self._parts
        admm_settings = opt.admm

        # (H, A) are iterate-independent: extract them ONCE at construction
        # and apply the Hessian convexification shift on the host, keeping
        # eigendecompositions out of the tick.
        H_raw, A_raw = matrices_raw(
            torch.zeros((self.n_x,), dtype=dtype, device=dev),
            torch.zeros((self.n_p,), dtype=dtype, device=dev),
        )
        H_np = H_raw.cpu().numpy().astype(np.float64)
        if opt.hessian_reg == "auto":
            w_min = float(np.linalg.eigvalsh(0.5 * (H_np + H_np.T))[0])
            shift = max(0.0, 1e-6 - w_min)
        else:
            shift = float(opt.hessian_reg)
        if shift > 0.0:
            H_np = H_np + shift * np.eye(H_np.shape[0])
        H_const = torch.as_tensor(H_np, dtype=dtype, device=dev)
        A_const = A_raw.to(dtype)

        vectors_b = torch.func.vmap(vectors)
        f_b = torch.func.vmap(self.f_fn)
        step = self._step  # the fixed update: a line search turns this path off
        x_at = self._x_at
        early, tol = self._early_exit()

        @f32_matmuls
        def solve_batch(x_init, p, lbx, ubx, lbg, ubg, qp_x0, qp_y0):
            x = x_init.to(dtype)
            p = p.to(dtype)
            # The raw bound stack is iterate-independent; only the shift by
            # c(x_k) changes per SQP step.  Bound TYPES (equality / loose
            # rows) are shift-invariant, so one factorization serves every
            # step.
            lower0, upper0 = stack_bounds(p, lbx, ubx, lbg, ubg)
            grad0, _ = vectors_b(x, p)
            fac = prepare_shared(H_const, A_const, lower0, upper0, grad0, admm_settings)
            qpx, qpy = qp_x0, qp_y0
            stop = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
            hist = []
            for _ in range(opt.max_iter):
                grad, cval = vectors_b(x, p)
                sol = admm_iterate_prepared(
                    fac, grad, lower0 - cval, upper0 - cval, admm_settings,
                    x0=qpx if opt.qp_warm_start else None,
                    y0=qpy if opt.qp_warm_start else None,
                    on_device=export,
                )
                x_new, step_norm = step(x, sol.x[:, x_at:], p, lbx, ubx, lbg, ubg)
                qp_it = sol.iters
                if early:
                    # Per-scenario freeze after ||alpha*dx|| < tol (the
                    # scenario still rides the shared batch QP; its results
                    # are discarded).
                    x_new = torch.where(stop[:, None], x, x_new)
                    qpx = torch.where(stop[:, None], qpx, sol.x)
                    qpy = torch.where(stop[:, None], qpy, sol.y)
                    qp_it = torch.where(stop, torch.zeros_like(qp_it), qp_it)
                    step_norm = torch.where(stop, torch.zeros_like(step_norm), step_norm)
                    took = ~stop
                    stop = stop | (step_norm < tol)
                else:
                    qpx, qpy = sol.x, sol.y
                    took = torch.ones_like(stop)
                x = x_new
                hist.append((f_b(x, p), qp_it, step_norm, sol.converged, sol.prim_inf,
                             sol.dual_inf, took))
            res = _result(x, qpx, qpy, hist)
            return tuple(res) if export else res

        if not export:
            solve_batch.export_form = self._build_solve_batch_fn(export=True)
        return solve_batch

    def _build_solve_dense_batch_fn(self, export: bool = False):
        """Batched solve on each scenario's own dense local QP: the port of
        ``jax.vmap(solve_fn)``.

        Signature: ``(x (B,nx), p (B,np), lbx (B,nx), ubx, lbg (B,ng), ubg,
        qp_x (B,qn), qp_y (B,qm)) -> SQPResult`` shaped as JAX's vmapped
        result, batch-leading (``f_history``, ``qp_iters``, ``step_norms``
        and the status flags ``(B, step_num)``, ``steps_taken (B,)``).  Per
        step: ``torch.func.vmap`` of the dense assembly, then
        :func:`.admm.admm_solve_batch`.  ``export_form`` (built with
        ``export=True``) is its twin for ``torch.export``: the ADMM loop on
        the device (the device-loop kernel's op at ``backend="pallas"``),
        the fields as a tuple; the same results.
        """
        opt = self.options
        dtype = opt.dtype
        matrices, _, vectors, stack_bounds = self._parts
        matrices_b = torch.func.vmap(matrices)
        vectors_b = torch.func.vmap(vectors)
        f_b = torch.func.vmap(self.f_fn)
        step = self._step_batch()
        x_at = self._x_at
        early, tol = self._early_exit()

        @f32_matmuls
        def solve_batch(x_init, p, lbx, ubx, lbg, ubg, qp_x0, qp_y0):
            x = x_init.to(dtype)
            p = p.to(dtype)
            lower, upper = stack_bounds(p, lbx, ubx, lbg, ubg)
            qpx, qpy = qp_x0, qp_y0
            stop = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
            hist = []
            for _ in range(opt.max_iter):
                H, A = matrices_b(x, p)
                grad, cval = vectors_b(x, p)
                sol = admm_solve_batch(
                    H, grad, A, lower - cval, upper - cval, opt.admm,
                    x0=qpx if opt.qp_warm_start else None,
                    y0=qpy if opt.qp_warm_start else None,
                    on_device=export,
                )
                x_new, step_norm = step(x, sol.x[:, x_at:], p, lbx, ubx, lbg, ubg)
                qp_it = sol.iters
                if early:
                    # Per-scenario freeze after ||alpha*dx|| < tol.
                    x_new = torch.where(stop[:, None], x, x_new)
                    qpx = torch.where(stop[:, None], qpx, sol.x)
                    qpy = torch.where(stop[:, None], qpy, sol.y)
                    qp_it = torch.where(stop, torch.zeros_like(qp_it), qp_it)
                    step_norm = torch.where(stop, torch.zeros_like(step_norm), step_norm)
                    took = ~stop
                    stop = stop | (step_norm < tol)
                else:
                    qpx, qpy = sol.x, sol.y
                    took = torch.ones_like(stop)
                x = x_new
                hist.append((f_b(x, p), qp_it, step_norm, sol.converged, sol.prim_inf,
                             sol.dual_inf, took))
            res = _result(x, qpx, qpy, hist)
            per_step = ("f_history", "qp_iters", "step_norms", "qp_converged",
                        "qp_prim_inf", "qp_dual_inf")
            res = res._replace(**{k: getattr(res, k).T for k in per_step})
            return tuple(res) if export else res

        if not export:
            solve_batch.export_form = self._build_solve_dense_batch_fn(export=True)
        return solve_batch

    def _build_solve_banded_fn(self, export: bool = False):
        """Single-scenario solve with the per-scenario banded ADMM
        (``solvers/admm_banded.admm_solve_banded``, no hand kernel).

        ``export_form``, its twin for ``torch.export``, is built with
        ``export=True``: the ADMM loop as one ``torch.while_loop`` on the
        device, the :class:`SQPResult` fields as a tuple; the same results."""
        from ..stagewise import build_stage_blocks
        from .admm_banded import BandedQP, admm_solve_banded

        opt = self.options
        dtype = opt.dtype
        _, _, vectors, stack_bounds = self._parts
        blocks = build_stage_blocks(self.stage_structure, dtype, opt.hessian_reg)
        f_fn = self.f_fn
        step = self._step
        early, tol = self._early_exit()

        @f32_matmuls
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
                    on_device=export,
                )
                x_new, step_norm = step(x, sol.x, p, lbx, ubx, lbg, ubg)
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
            res = _result(x, qpx, qpy, hist)
            return tuple(res) if export else res

        if not export:
            solve.export_form = self._build_solve_banded_fn(export=True)
        return solve

    def _build_solve_banded_batch_fn(self, export: bool = False):
        """Batched banded solve: ``(x (B,nx), p (B,np), lbx (B,nx), ubx,
        lbg (B,ng), ubg, qp_x (B,qn), qp_y (B,qm)) -> SQPResult`` with
        leading batch dims.  Per step: batch-last stage derivatives, then
        ``admm_solve_banded_batch_T`` — one chunk launch for the whole
        batch (per rho-constant chunk).  ``export_form`` (built with
        ``export=True``) is its twin for ``torch.export``: the chunk loop on
        the device, each chunk kernel one op node, the fields as a tuple;
        the same results (with ``polish=True`` the batched polish too)."""
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
        step = self._step_batch()
        early, tol = self._early_exit()

        @f32_matmuls
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
                        on_device=export,
                    )
                )
                x_new, step_norm = step(x, sxT.T, p, lbx, ubx, lbg, ubg)
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
            res = _result(x, qpxT.T, qpyT.T, hist)
            return tuple(res) if export else res

        if not export:
            solve_batch.export_form = self._build_solve_banded_batch_fn(export=True)
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
            if taken < self.options.max_iter:
                print(f"  early exit: ||alpha*dx|| < {self.options.early_exit_tol}")
            print(f"  qp iters per step: {res.qp_iters.cpu().numpy()}")
            print(f"  f history: {res.f_history.cpu().numpy()}")
            print(f"  x = {res.x.cpu().numpy()}")
        return {"x": res.x, "f": res.f}

    def set_iterate(self, x) -> None:
        """Seed the persistent iterate (``result_``), e.g. with a shifted
        previous plan for receding-horizon warm starting (controller.py)."""
        x = torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(-1), dtype=self.dtype,
                            device=self.device)
        if x.shape[0] != self.n_x:
            raise ValueError(f"iterate must have size {self.n_x}")
        self._result_x = x

    def reset(self) -> None:
        """Clear the persistent iterate back to zeros (fresh ``result_``)."""
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)  # noqa: E731
        self._result_x = z(self.n_x)
        self._result_f = z()
        self._qp_x = z(self._qp_n)
        self._qp_y = z(self._qp_m)

    def get_local_system_function(self):
        """The local-QP assembly ``(x, p, lbx, ubx, lbg, ubg) -> (H, grad,
        A, l - c, u - c)``, the analog of the reference's
        ``getSXLocalSystemFunction``."""
        return _local_system(self._parts)

    def set_verbose(self, verbose: bool) -> None:
        self._verbose = bool(verbose)


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
