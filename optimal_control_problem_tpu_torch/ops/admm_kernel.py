"""Dense per-scenario ADMM device loop, batch-leading — port of
``optimal_control_problem_tpu/ops/admm_kernel.py::admm_device_loop``.

One call runs a whole rho-constant condensed OSQP-ADMM solve for each of B
independent QPs, each with its OWN operators (the nonlinear models'
local QPs change with the iterate): ``OP (B, n, n)`` (condensed inverse),
``Ab (B, m, n)``, ``Pb (B, n, n)`` and per-row ``rho (B, m)``, all in the
scaled space of the dense driver (``solvers/admm.py``).  At entry ``z`` is
recomputed as ``clip(x @ Ab^T, lb, ub)``, as the JAX kernel does (it is not
carried over).  Each iteration::

    rhs = sigma x - qb + (rho z - y) @ Ab
    xt  = rhs @ OP
    zt  = xt @ Ab^T

with the relaxation, the projection onto ``[lb, ub]`` and the dual update,
and every ``check_every`` iterations three more products (``x @ Ab^T``,
``x @ Pb``, ``y @ Ab``) give the unscaled residuals of the OSQP
termination test.  Each scenario runs its own loop: whole check blocks
while ``it < max_iter`` and it has not converged, ``it += check_every``
(so ``it`` can pass ``max_iter``).  The product orientations are the JAX
kernel's, not the ``"xla"`` loop's: an f32 inverse (and a Hessian from
``torch.func``) need not be exactly symmetric, so ``rhs @ OP`` and
``OP @ rhs`` differ.

:func:`admm_device_loop` is the wrapper: it checks the call and runs the
custom op ``torch.ops.ocp_torch.admm_device_loop``, one node of known
output shapes to ``torch.export``.  For CUDA tensors the op launches the
hand-written kernel ``csrc/admm_device_loop.cu`` (built by ``nvcc`` at
first use; one thread block per scenario) and counts the launch in
``admm_device_loop.launches``.  :func:`kernel_tier` picks where the
kernel keeps a scenario's operators, greedily: tier 1 stages ``OP^T``,
``Ab`` and ``Ab^T`` in shared memory, tier 2 ``OP^T`` and ``Ab``, tier 3
reads them where the caller holds them, through L2 (vectors in a scratch
slab); all three run the same op order.  The layout (each tier's shared
memory, the slab's row) is the C entry point's alone: the wrapper asks
the built library for it (``ocp_admm_device_loop_smem``,
``ocp_admm_device_loop_slab_floats``) and keeps no copy.  The only size limit is the JAX
driver's own guard, which the dense ``"pallas"`` path
(``solvers/admm.py``) copies.  For CPU tensors it runs
:func:`admm_device_loop_plain`, the plain PyTorch version of the same
contract that the CPU tests hold against the Pallas kernel.  There is no
fallback from one to the other.

Both versions form every product as an ascending chain over the
contraction index, one multiply and one add per term (the CUDA build has
FMA contraction off), so they round alike and agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch
from torch import Tensor

from ..device import as_tensors
from .banded_kernel import _check, launch_chunk
from .build import load_library

__all__ = [
    "admm_device_loop",
    "admm_device_loop_plain",
    "chain_bmm",
    "kernel_tier",
    "SMEM_LIMIT",
]

# Dynamic shared memory one thread block may opt into on sm_90 (H100/H200).
SMEM_LIMIT = 232_448


def _layout(symbol: str, *ints: int) -> int:
    """One of the C entry point's layout queries, from the built library
    (``ocp_admm_device_loop_smem(tier, n, m)``: a block's shared bytes;
    ``ocp_admm_device_loop_slab_floats(n, m)``: a scenario's row of tier
    3's vector slab)."""
    fn = getattr(load_library("admm_device_loop"), symbol)
    fn.argtypes = [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_longlong
    return int(fn(*ints))


def kernel_tier(n: int, m: int) -> int:
    """The first tier whose shared memory (the C entry point's count) fits
    a thread block: 1 up to 204,544 bytes at n=100, m=196 (the cart-pole
    h20 QP), 2 at n=120, m=236 (185,840 bytes), 3 at n=200, m=392 and
    beyond."""
    for tier in (1, 2):
        if _layout("ocp_admm_device_loop_smem", tier, n, m) <= SMEM_LIMIT:
            return tier
    return 3


def chain_bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (B, K) @ w (B, K, J)`` per scenario, as an ascending chain over
    ``k`` from zero, a multiply and an add per term — the CUDA kernel's
    order."""
    acc = torch.zeros((a.shape[0], w.shape[2]), dtype=a.dtype, device=a.device)
    for k in range(w.shape[1]):
        acc = acc + a[:, k : k + 1] * w[:, k]
    return acc


def _contract(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0, check_every):
    """Check a call on either device; returns ``(B, n, m)``."""
    dev = x0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"admm_device_loop: unsupported device {dev}")
    if x0.dim() != 2 or y0.dim() != 2:
        raise ValueError("admm_device_loop: x0 must be (B, n) and y0 (B, m)")
    B, n = x0.shape
    m = y0.shape[1]
    if n < 1 or m < 1:
        raise ValueError(f"admm_device_loop needs n >= 1 and m >= 1 (got n={n}, m={m})")
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    ft = torch.float32 if dev.type == "cuda" else x0.dtype
    for name, t, shape in (
        ("OP", OP, (B, n, n)), ("Ab", Ab, (B, m, n)), ("Pb", Pb, (B, n, n)),
        ("qb", qb, (B, n)), ("lb", lb, (B, m)), ("ub", ub, (B, m)), ("rho", rho, (B, m)),
        ("Dinv", Dinv, (B, n)), ("Einv", Einv, (B, m)), ("cinv", cinv, (B,)),
        ("x0", x0, (B, n)), ("y0", y0, (B, m)),
    ):
        _check(name, t, shape, ft, dev)
    return B, n, m


def admm_device_loop_plain(
    OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv,
    sigma: float, alpha: float, eps_abs: float, eps_rel: float,
    x0, y0, max_iter: int = 10000, check_every: int = 25,
):
    """Plain PyTorch version of the device loop, op for op the JAX
    ``_kernel`` over a leading batch axis.

    Operators and vectors as in the module docstring; ``Dinv (B, n)``,
    ``Einv (B, m)``, ``cinv (B,)`` unscale the residuals; ``x0 (B, n)``,
    ``y0 (B, m)`` are scaled warm starts.  Returns ``(x, y, z, it)``, with
    ``it (B,)`` int32.  Scenarios that have stopped are masked: they keep
    their iterates while the others run on.
    """
    B, n, m = _contract(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0, check_every)
    AbT = Ab.transpose(1, 2)
    one_m_alpha = 1.0 - alpha

    def clip(v):
        return torch.minimum(torch.maximum(v, lb), ub)

    def one_iter(x, z, y):
        rhs = sigma * x - qb + chain_bmm(rho * z - y, Ab)
        xt = chain_bmm(rhs, OP)
        zt = chain_bmm(xt, AbT)
        x_n = alpha * xt + one_m_alpha * x
        z_rel = alpha * zt + one_m_alpha * z
        z_n = clip(z_rel + y / rho)
        y_n = y + rho * (z_rel - z_n)
        return x_n, z_n, y_n

    def rowmax(a):
        return a.abs().amax(dim=1)

    def residual_ok(x, z, y):
        ax = chain_bmm(x, AbT)
        px = chain_bmm(x, Pb)
        aty = chain_bmm(y, Ab)
        r_prim = rowmax((ax - z) * Einv)
        r_dual = cinv * rowmax((px + qb + aty) * Dinv)
        max_prim = torch.maximum(rowmax(ax * Einv), rowmax(z * Einv))
        max_dual = cinv * torch.maximum(
            torch.maximum(rowmax(aty * Dinv), rowmax(px * Dinv)), rowmax(qb * Dinv)
        )
        return (r_prim <= eps_abs + eps_rel * max_prim) & (r_dual <= eps_abs + eps_rel * max_dual)

    x, y = x0, y0
    z = clip(chain_bmm(x, AbT))
    it = torch.zeros((B,), dtype=torch.int32, device=x.device)
    done = torch.zeros((B,), dtype=torch.bool, device=x.device)
    while True:
        act = (it < max_iter) & ~done
        if not bool(act.any()):
            break
        xs, zs, ys = x, z, y
        for _ in range(check_every):
            xs, zs, ys = one_iter(xs, zs, ys)
        ok = residual_ok(xs, zs, ys)
        a2 = act[:, None]
        x, z, y = torch.where(a2, xs, x), torch.where(a2, zs, z), torch.where(a2, ys, y)
        done = torch.where(act, ok, done)
        it = it + check_every * act.to(torch.int32)
    return x, y, z, it


def admm_device_loop(
    OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv,
    sigma: float, alpha: float, eps_abs: float, eps_rel: float,
    x0, y0, max_iter: int = 10000, check_every: int = 25, *, device=None,
):
    """Run the dense device loop for a batch of QPs; same contract as
    :func:`admm_device_loop_plain`, through the op
    ``ocp_torch::admm_device_loop``.

    CPU tensors take the plain version.  CUDA tensors (f32, contiguous)
    launch ``csrc/admm_device_loop.cu`` on the current stream, one thread
    block per scenario, in the tier :func:`kernel_tier` picks, or raise if
    the launch is refused.  Arrays that are not tensors go to ``device``
    (:func:`..device.as_tensors`).
    """
    OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0 = as_tensors(
        OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0, device=device)
    _contract(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0, check_every)
    return tuple(torch.ops.ocp_torch.admm_device_loop(
        OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, float(sigma), float(alpha),
        float(eps_abs), float(eps_rel), x0, y0, int(max_iter), int(check_every)))


def _launch(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sigma, alpha, eps_abs, eps_rel,
            x0, y0, max_iter, check_every, tier=None):
    """The wrapper's kernel path: outputs, vector slab and the launch of
    ``csrc/admm_device_loop.cu`` on checked inputs, in ``tier`` (default
    :func:`kernel_tier`; the tests and the ablation force one, and the C
    entry point refuses a tier whose shared memory does not fit)."""
    B, n, m = x0.shape[0], x0.shape[1], y0.shape[1]
    dev = x0.device
    tier = kernel_tier(n, m) if tier is None else tier
    outs = (
        torch.empty((B, n), dtype=torch.float32, device=dev),
        torch.empty((B, m), dtype=torch.float32, device=dev),
        torch.empty((B, m), dtype=torch.float32, device=dev),
        torch.empty((B,), dtype=torch.int32, device=dev),
    )
    if B == 0:
        return outs
    slab = _layout("ocp_admm_device_loop_slab_floats", n, m) if tier == 3 else 0
    vec = torch.empty((max(1, B * slab),), dtype=torch.float32, device=dev)
    launch_chunk(
        "admm_device_loop", "admm_device_loop", "ocp_admm_device_loop_f32",
        [OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, x0, y0, *outs, vec],
        (B, n, m, max_iter, check_every, tier),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    admm_device_loop.launches += 1
    return outs


admm_device_loop.launches = 0


@torch.library.custom_op("ocp_torch::admm_device_loop", mutates_args=(), device_types="cpu")
def _device_loop_op(OP: Tensor, Ab: Tensor, Pb: Tensor, qb: Tensor, lb: Tensor, ub: Tensor,
                    rho: Tensor, Dinv: Tensor, Einv: Tensor, cinv: Tensor, sigma: float,
                    alpha: float, eps_abs: float, eps_rel: float, x0: Tensor, y0: Tensor,
                    max_iter: int, check_every: int) -> List[Tensor]:
    """The op's CPU implementation: the plain version, its outputs copied
    (an op may return no input: a scenario that runs no check block keeps
    its warm start)."""
    return [o.clone() for o in admm_device_loop_plain(
        OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sigma, alpha, eps_abs, eps_rel, x0, y0,
        max_iter=max_iter, check_every=check_every)]


@_device_loop_op.register_kernel("cuda")
def _(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sigma, alpha, eps_abs, eps_rel, x0, y0,
      max_iter, check_every):
    """The CUDA implementation: the kernel path, which counts the launch.
    No input is written (the outputs and tier 3's slab are the launch's)."""
    return list(_launch(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sigma, alpha, eps_abs,
                        eps_rel, x0, y0, max_iter, check_every))


@_device_loop_op.register_fake
def _(OP, Ab, Pb, qb, lb, ub, rho, Dinv, Einv, cinv, sigma, alpha, eps_abs, eps_rel, x0, y0,
      max_iter, check_every):
    it = torch.empty((x0.shape[0],), dtype=torch.int32, device=x0.device)
    return [torch.empty_like(x0), torch.empty_like(y0), torch.empty_like(y0), it]
