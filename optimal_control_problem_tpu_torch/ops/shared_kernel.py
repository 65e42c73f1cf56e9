"""Fused shared-operator ADMM chunk, batch-leading — port of
``optimal_control_problem_tpu/ops/shared_kernel.py::shared_admm_chunk``.

One call runs a whole rho-constant condensed OSQP-ADMM chunk for a batch
of QPs that share one operator: panels ``(B, n)`` / ``(B, m)`` against the
shared ``OP (n, n)``, ``Ab (m, n)``, ``Pb (n, n)`` and per-row ``rho (m,)``.
Each iteration is three panel products with the elementwise relaxation,
projection and dual update between them::

    rhs = sigma x - qb + (rho z - y) @ Ab
    xt  = rhs @ OP
    zt  = xt @ Ab^T

and every ``check_every`` iterations three more (``x @ Ab^T``, ``x @ Pb``,
``y @ Ab``) give the unscaled residuals of the OSQP termination test.
Termination is shared by a *termination group* of ``batch_tile``
consecutive scenarios: nobody freezes, ``conv`` is re-evaluated for every
scenario at each check, and the group runs whole check blocks while its
iteration count is below ``bound`` and not all of its scenarios have
converged.  A group whose scenarios are all done at entry returns its
inputs with ``it_inc = 0`` and infinite residuals.  The driver's group is
:func:`pick_shared_tile`'s, as in the JAX package: the whole batch up to
6,538 scenarios at n=120, m=196 (one batch-wide vote, which is what makes
the fused path's iteration counts equal the ``"xla"`` loop's), tiles of
6,536 above.

:func:`shared_admm_chunk` is the wrapper: it checks the call and runs the
custom op ``torch.ops.ocp_torch.shared_admm_chunk``, one node of known
output shapes to ``torch.export``.  For CUDA tensors the op launches the
hand-written kernel ``csrc/shared_chunk.cu`` (built by ``nvcc`` at first
use) and counts the launch in ``shared_admm_chunk.launches``; for CPU
tensors it runs :func:`shared_admm_chunk_plain`, the plain PyTorch version
of the same contract that the CPU tests hold against the Pallas kernel.
There is no fallback from one to the other.  The op takes the chunk's
budget ``bound`` as a tensor, so that a loop on the device can compute
it; the kernel path reads it on the host, where it enqueues one launch
per check block.

Both versions form every product as an ascending chain over the
contraction index, one multiply and one add per term (the CUDA build has
FMA contraction off), so they round alike and can agree bitwise.  A
``torch.matmul`` sums in another order: against it (the ``"xla"`` loop)
iterates agree to f32 roundoff only.

On the card one thread block holds 8, 16 or 32 scenarios, and a group's
vote crosses thread blocks: the kernel runs one check block per launch and
the wrapper's one call enqueues a launch per check block of the budget,
each reading its group's last vote from global memory, so a group of any
size runs (see the note in ``csrc/shared_chunk.cu``).

``iter_precision`` (``"highest"``, ``"high"``, ``"mixed"``) is the JAX
kernel's precision of the three iteration products.  ``"highest"`` is the
FP32 chains above.  At ``"high"`` all three, at ``"mixed"`` the rhs and x
products (``zt`` stays ``"highest"``), run as the TPU's ``HIGH``: bf16_3x,
each f32 operand split into ``hi = bf16(a)`` and ``lo = bf16(a - hi)``
(:func:`split_bf16`) and the product summed as ``hi hi + (hi lo + lo hi)``
with f32 accumulation.  The termination residuals stay FP32 chains in
every mode, so a scenario that stops is certified in true f32.  On the
card those products run on the tensor cores in a kernel of their own,
``csrc/shared_chunk_tc.cu`` (``wgmma`` bf16 with the operator as the wide
side, its hi/lo slices packed once per call as :func:`tc_operator_slices`
lays them out and brought into shared memory by bulk copies); the plain
version sums
the same split products with ``torch.matmul``.  Tensor cores accumulate
in their own order, so the variant agrees with its plain version to f32
roundoff of the products, not bitwise.  TF32 plays no part: the variant
is the reference's bf16_3x.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from ..device import as_tensors
from .banded_kernel import _check, launch_chunk

__all__ = [
    "shared_admm_chunk",
    "shared_admm_chunk_plain",
    "chain_matmul",
    "split_bf16",
    "matmul_split",
    "precision_matmul",
    "tc_operator_slices",
    "pick_shared_tile",
    "shared_block_rows",
    "ROWS_PER_BLOCK",
    "ROWS_PER_BLOCK_TC",
    "ITER_PRECISIONS",
    "PRECISION_NAMES",
]

# Scenarios per thread block the CUDA kernels are instantiated for, in the
# FP32 form and in the tensor-core form (the N of its m64nNk16 products).
ROWS_PER_BLOCK = (8, 16, 32)
ROWS_PER_BLOCK_TC = (16, 32)
ITER_PRECISIONS = ("highest", "high", "mixed")
# Dynamic shared memory a thread block may opt into on an H100.
SMEM_LIMIT = 232448
# The tensor-core form's operator slices: output columns per pass (four
# m64 tiles) and the fewest ring slots it runs with.
TC_PASS_COLS = 256
TC_MIN_STAGES = 2


def _pad(v: int, k: int) -> int:
    return -(-v // k) * k


def tc_split_floats(n: int, m: int) -> int:
    """Floats per scenario row of the tensor-core form's split panel: the
    hi and lo bf16 copies of the widest product operand, its width padded
    to a multiple of 16 (the products' k16 steps)."""
    return max(_pad(n, 16), _pad(m, 16))


def tc_block_bytes(rows: int, n: int, m: int, stages: int = TC_MIN_STAGES) -> int:
    """Shared memory of a tensor-core block of ``rows`` scenarios at
    ``"high"`` with ``stages`` ring slots, as ``csrc/shared_chunk_tc.cu``'s
    ``tc_layout`` places it: 128 bytes of mbarriers, the ring (slots of
    16-deep operator slices, at most ``TC_PASS_COLS`` columns padded to
    64, 4 bytes a column and k for hi and lo), the split panel and the six
    panels (each region padded to 128 bytes), and five floats a row of
    static per-row results.  ``"mixed"`` needs no more (its slices are
    only ``n`` wide; zt's FP32 slices take what is left, or none)."""
    slot = 64 * min(max(_pad(n, 64), _pad(m, 64)), TC_PASS_COLS)
    split = _pad(rows * tc_split_floats(n, m) * 4, 128)
    panels = _pad(rows * (3 * n + 3 * m) * 4, 128)
    return 128 + stages * slot + split + panels + 5 * rows * 4


def shared_block_rows(B: int, batch_tile: int, n: int, m: int, sms: int,
                      tensor_cores: bool = False) -> int:
    """Scenarios per thread block for a launch over ``B`` scenarios in
    termination groups of ``batch_tile`` on a card with ``sms`` SMs: of
    the ``ROWS_PER_BLOCK`` (``ROWS_PER_BLOCK_TC`` for the tensor-core
    form) whose panels fit in shared memory (six of ``rows`` by ``n`` or
    ``m`` floats and five per row; the tensor-core form's block with its
    split panel and two ring slots, :func:`tc_block_bytes`; the C entry
    points refuse the others), the
    one that puts the fewest scenario rows on the busiest SM
    (``ceil(blocks / sms) * rows``: an SM's float pipes are shared by the
    blocks it holds), then the most rows (each block streams the operators
    once).  At n=120, m=196: 32 at B=4096 (128 blocks), 8 at B=64 (8
    blocks, where 32 would leave 130 of 132 SMs idle; 16 for the
    tensor-core form).  Raises where no block fits."""
    best = None
    for rows in sorted(ROWS_PER_BLOCK_TC if tensor_cores else ROWS_PER_BLOCK, reverse=True):
        need = (tc_block_bytes(rows, n, m) if tensor_cores
                else rows * (3 * n + 3 * m + 5) * 4)
        if need > SMEM_LIMIT:
            continue
        blocks = (B // batch_tile) * -(-batch_tile // rows)
        load = -(-blocks // sms) * rows
        if best is None or load < best[0]:
            best = (load, rows)
    if best is None:
        rows = min(ROWS_PER_BLOCK_TC if tensor_cores else ROWS_PER_BLOCK)
        raise ValueError(
            f"shared_admm_chunk: the panels of {rows} scenarios at n={n}, "
            f"m={m} exceed the {SMEM_LIMIT} bytes of shared memory a block can have"
        )
    return best[1]


def pick_shared_tile(B: int, n: int, m: int) -> Optional[int]:
    """The termination group of the fused path, or ``None``: the JAX
    package's ``ops/shared_kernel.py::pick_shared_tile``, copied so that
    both packages vote over the same scenarios.  It sizes the TPU's VMEM
    working set (lane dims padded to 128, panels and temporaries modelled
    at three times the panel rows, a 96 MiB budget less the operators):
    the whole batch while it fits, else the largest multiple of 8 that
    does, else ``None`` (the JAX driver then runs its XLA loop, and so
    does the port's)."""
    pad = lambda s: -(-s // 128) * 128  # noqa: E731
    np_, mp = pad(n), pad(m)
    per_scen = 3 * (2 * np_ + 4 * mp)
    ops = 2 * n * np_ + m * np_ + 4 * mp + 2 * np_
    budget = 96 * 1024 * 1024 // 4 - ops
    if B * per_scen <= budget:
        return B
    tile = (budget // per_scen) // 8 * 8
    if tile >= 8:
        return min(tile, B)
    return None


def chain_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (B, K) @ w (K, J)`` as an ascending chain over ``k`` from zero,
    a multiply and an add per term — the CUDA kernel's order."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    for k in range(w.shape[0]):
        acc = acc + a[:, k : k + 1] * w[k]
    return acc


def split_bf16(a: torch.Tensor):
    """``a`` as ``hi + lo`` for a bf16_3x product: ``hi = bf16(a)`` and
    ``lo = bf16(a - hi)``, each rounded to nearest even, returned in
    ``a``'s dtype (the values are exact bf16 numbers).  A NaN stays NaN in
    both; an infinite entry has a NaN ``lo``, as the TPU's split."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, (a - hi).to(torch.bfloat16).to(a.dtype)


def matmul_split(a: torch.Tensor, w_split) -> torch.Tensor:
    """``a @ w`` at the TPU's ``HIGH`` (bf16_3x) against an operator split
    once by :func:`split_bf16`: ``a`` is split here, each product of two
    bf16 numbers is exact in float32, and the three products are summed
    in float32 as ``hi hi + (hi lo + lo hi)`` (the tensor-core kernel
    keeps the same two sums).  ``lo lo`` is dropped."""
    a_hi, a_lo = split_bf16(a)
    w_hi, w_lo = w_split
    return a_hi @ w_hi + (a_hi @ w_lo + a_lo @ w_hi)


# JAX's names of a matmul precision (``jax.default_matmul_precision``) and
# what each means on the TPU: one bf16 pass, bf16_3x, or true f32.
PRECISION_NAMES = {
    "default": "default", "fastest": "default", "bfloat16": "default",
    "high": "high", "bfloat16_3x": "high", "tensorfloat32": "high",
    "highest": "highest", "float32": "highest",
}


def precision_matmul(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ w`` at one of JAX's matmul precisions (:data:`PRECISION_NAMES`),
    for float32 operands: ``"highest"`` the float32 product (TF32 is off),
    ``"high"`` bf16_3x (:func:`matmul_split`; the TPU's meaning, never the
    card's TF32), ``"default"`` one bf16 pass (both operands rounded to
    bf16, float32 accumulation).  Other dtypes (the float64 problems) take
    the plain product at every precision, as JAX's CPU does."""
    if precision not in PRECISION_NAMES:
        raise ValueError(f"precision must be one of {sorted(PRECISION_NAMES)}, got {precision!r}")
    precision = PRECISION_NAMES[precision]
    if precision == "highest" or a.dtype != torch.float32:
        return a @ w
    if precision == "high":
        return matmul_split(a, split_bf16(w))
    bf = lambda t: t.to(torch.bfloat16).to(t.dtype)  # noqa: E731
    return bf(a) @ bf(w)


def tc_operator_slices(w: torch.Tensor) -> torch.Tensor:
    """The operator ``w (K, J)`` of a product ``a @ w`` as the tensor-core
    kernel streams it: split by :func:`split_bf16`, zero-padded to ``K`` a
    multiple of 16 and ``J`` of 64, cut into passes of ``TC_PASS_COLS``
    output columns and each pass into k16 slices.  A slice is one
    contiguous run (one bulk copy): the hi part, then the lo part, each
    the pass's ``Jp`` columns as rows of an ``A`` operand (``A[j, k] =
    w[k, j]``) in K-major core matrices of 8 rows by 8 k (16 bytes a row,
    128 a matrix), the k halves of a row group side by side (128 bytes
    apart) and the row groups 256 bytes apart.  Returns the bf16 values,
    flat: pass by pass, slice by slice.  The plain version of the packing
    kernel the tensor-core entry point runs once per call."""
    K, J = w.shape
    Kp, Jp = _pad(K, 16), _pad(J, 64)
    wp = torch.zeros((Kp, Jp), dtype=torch.float32, device=w.device)
    wp[:K, :J] = w
    hi = wp.to(torch.bfloat16)
    lo = (wp - hi.to(torch.float32)).to(torch.bfloat16)
    parts = torch.stack([hi, lo])  # (2, Kp, Jp): k = 16 s + 8 half + kk, j = 8 G + r
    runs = []
    for p0 in range(0, Jp, TC_PASS_COLS):
        W = min(TC_PASS_COLS, Jp - p0)
        q = parts[:, :, p0:p0 + W].reshape(2, Kp // 16, 2, 8, W // 8, 8)
        # -> (s, hi/lo, G, half, r, kk)
        runs.append(q.permute(1, 0, 4, 2, 5, 3).reshape(-1))
    return torch.cat(runs).contiguous()


def _contract(done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
              check_every, batch_tile):
    """Check a chunk call on either device; returns ``(B, n, m, bound,
    done0 as int32, cinv as a (1,) tensor)``, ``bound`` an int or, given
    as a tensor, a 0-d one (read nowhere here: it may lie on the card or
    be traced)."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"shared_admm_chunk: unsupported device {dev}")
    if x.dim() != 2 or z.dim() != 2:
        raise ValueError("shared_admm_chunk: x must be (B, n) and z (B, m)")
    B, n = x.shape
    m = z.shape[1]
    if n < 1 or m < 1:
        raise ValueError(f"shared_admm_chunk needs n >= 1 and m >= 1 (got n={n}, m={m})")
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    if batch_tile < 1 or B % batch_tile:
        raise ValueError(f"batch {B} not divisible by tile {batch_tile}")
    ft = torch.float32 if dev.type == "cuda" else x.dtype
    cinv = torch.as_tensor(cinv, dtype=ft, device=dev).reshape(1)
    done0 = done0.to(torch.int32)
    if isinstance(bound, Tensor):
        if bound.numel() != 1 or bound.is_floating_point():
            raise ValueError("shared_admm_chunk: bound must be an int or a 0-d integer tensor")
        bound = bound.reshape(())
    else:
        bound = int(bound)
    for name, t, shape in (
        ("OP", OP, (n, n)), ("Ab", Ab, (m, n)), ("Pb", Pb, (n, n)), ("rho", rho, (m,)),
        ("lb", lb, (B, m)), ("ub", ub, (B, m)), ("qb", qb, (B, n)),
        ("Dinv", Dinv, (n,)), ("Einv", Einv, (m,)), ("cinv", cinv, (1,)),
        ("x", x, (B, n)), ("z", z, (B, m)), ("y", y, (B, m)),
    ):
        _check(name, t, shape, ft, dev)
    _check("done0", done0, (B,), torch.int32, dev)
    return B, n, m, bound, done0, cinv


def _check_iter_precision(iter_precision: str) -> None:
    if iter_precision not in ITER_PRECISIONS:
        raise ValueError(
            f"iter_precision must be 'highest', 'high' or 'mixed', got {iter_precision!r}"
        )


def shared_admm_chunk_plain(
    done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
    *,
    check_every: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
    batch_tile: int,
    iter_precision: str = "highest",
):
    """Plain PyTorch version of the shared-operator chunk, op for op the
    JAX ``_kernel``.

    ``done0 (B,)`` bool/int: scenario enters converged or certified;
    ``bound``: the chunk's iteration budget (an int or a 0-d integer
    tensor; need not be a multiple
    of ``check_every``, the last check block still runs whole); panels and
    operators as in the module docstring; ``Dinv (n,)``, ``Einv (m,)``,
    ``cinv`` (scalar) unscale the residuals; ``iter_precision`` as in the
    module docstring (products at ``HIGH`` through :func:`matmul_split`,
    every other product an FP32 chain).  Returns ``(x, z, y, conv (B,)
    bool, it_inc (B,) int32, rp, rd, rp_rel, rd_rel (B,))``.
    """
    _check_iter_precision(iter_precision)
    B, n, m, bound, done0, cinv = _contract(
        done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
        check_every, batch_tile,
    )
    bound = int(bound)
    AbT = Ab.T.contiguous()
    one_m_alpha = 1.0 - alpha
    high_x = iter_precision != "highest"
    high_z = iter_precision == "high"
    Ab_s, OP_s = (split_bf16(Ab), split_bf16(OP)) if high_x else (None, None)
    AbT_s = split_bf16(AbT) if high_z else None

    def prod(a, w, w_split):
        return chain_matmul(a, w) if w_split is None else matmul_split(a, w_split)

    def one_iter(x, z, y, qb, lb, ub):
        rhs = sigma * x - qb + prod(rho * z - y, Ab, Ab_s)
        xt = prod(rhs, OP, OP_s)
        zt = prod(xt, AbT, AbT_s)
        x_n = alpha * xt + one_m_alpha * x
        z_rel = alpha * zt + one_m_alpha * z
        z_n = torch.minimum(torch.maximum(z_rel + y / rho, lb), ub)
        y_n = y + rho * (z_rel - z_n)
        return x_n, z_n, y_n

    def rowmax(a):
        return a.abs().amax(dim=1)

    def residuals(x, z, y, qb):
        Ax = chain_matmul(x, AbT)
        Px = chain_matmul(x, Pb)  # Pb symmetric
        Aty = chain_matmul(y, Ab)
        r_prim = rowmax((Ax - z) * Einv)
        r_dual = cinv * rowmax((Px + qb + Aty) * Dinv)
        max_prim = torch.maximum(rowmax(Ax * Einv), rowmax(z * Einv))
        max_dual = cinv * torch.maximum(
            torch.maximum(rowmax(Aty * Dinv), rowmax(Px * Dinv)), rowmax(qb * Dinv)
        )
        return r_prim, r_dual, max_prim, max_dual

    outs = [[] for _ in range(9)]
    for g in range(B // batch_tile):
        sl = slice(g * batch_tile, (g + 1) * batch_tile)
        xg, zg, yg = x[sl], z[sl], y[sl]
        qg, lg, ug = qb[sl], lb[sl], ub[sl]
        conv = done0[sl] == 1
        inf = torch.full((batch_tile,), float("inf"), dtype=x.dtype, device=x.device)
        rp, rd, rpr, rdr = inf, inf, inf, inf
        k = 0
        all_conv = bool(conv.all())  # the group skips when all enter done
        while k < bound and not all_conv:
            for _ in range(check_every):
                xg, zg, yg = one_iter(xg, zg, yg, qg, lg, ug)
            rp, rd, max_prim, max_dual = residuals(xg, zg, yg, qg)
            conv = (rp <= eps_abs + eps_rel * max_prim) & (rd <= eps_abs + eps_rel * max_dual)
            rpr = rp / torch.clamp(max_prim, min=1e-12)
            rdr = rd / torch.clamp(max_dual, min=1e-12)
            all_conv = bool(conv.all())
            k += check_every
        it_inc = torch.full((batch_tile,), k, dtype=torch.int32, device=x.device)
        for o, v in zip(outs, (xg, zg, yg, conv, it_inc, rp, rd, rpr, rdr)):
            o.append(v)
    return tuple(torch.cat(o) for o in outs)


def shared_admm_chunk(
    done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
    *,
    check_every: int,
    sigma: float,
    alpha: float,
    eps_abs: float,
    eps_rel: float,
    batch_tile: int,
    iter_precision: str = "highest",
    rows_per_block: Optional[int] = None,
    device=None,
):
    """Run one rho-constant shared-operator ADMM chunk; same contract as
    :func:`shared_admm_chunk_plain`, through the op
    ``ocp_torch::shared_admm_chunk`` (``bound`` an int or a 0-d integer
    tensor).

    CPU tensors take the plain version.  CUDA tensors (f32, contiguous)
    launch a hand-written kernel on the current stream, one launch per
    check block of ``bound`` (the termination vote of a group crosses
    thread blocks through global memory between launches), or raise: a
    panel width whose rows do not fit in shared memory is refused.
    ``iter_precision="highest"`` runs the FP32 kernel ``csrc/shared_chunk.cu``,
    bitwise its plain version, and counts one launch in
    ``shared_admm_chunk.launches`` (one chunk of the batch loop); ``"high"``
    and ``"mixed"`` run the tensor-core form ``csrc/shared_chunk_tc.cu`` and
    count in ``shared_admm_chunk.tc_launches``.
    ``rows_per_block`` (one of ``ROWS_PER_BLOCK``, or ``ROWS_PER_BLOCK_TC``
    for the tensor-core form) forces the scenarios per thread block, for
    timing; by default :func:`shared_block_rows` picks it for the card.
    Results do not depend on it (the FP32 form's bits; the tensor-core
    form's up to the order of its sums).  Arrays that are not tensors go to
    ``device`` (:func:`..device.as_tensors`).
    """
    done0, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y = as_tensors(
        done0, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y, device=device)
    _check_iter_precision(iter_precision)
    _, _, _, bound, done0, cinv = _contract(
        done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
        check_every, batch_tile,
    )
    if x.device.type != "cpu":
        _check_rows(rows_per_block, iter_precision != "highest")
    if not isinstance(bound, Tensor):
        bound = torch.tensor(bound)
    return tuple(torch.ops.ocp_torch.shared_admm_chunk(
        done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
        int(check_every), float(sigma), float(alpha), float(eps_abs), float(eps_rel),
        int(batch_tile), iter_precision, rows_per_block))


def _outputs(B, n, m, dev):
    """Empty outputs of a chunk: ``x z y conv it_inc rp rd rp_rel rd_rel``."""
    def empty(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)

    return (
        empty(B, n), empty(B, m), empty(B, m),  # x z y
        empty(B, dt=torch.int32), empty(B, dt=torch.int32),  # conv it_inc
        empty(B), empty(B), empty(B), empty(B),  # rp rd rp_rel rd_rel
    )


def _check_rows(rows_per_block, tensor_cores) -> None:
    """Raise for a forced scenarios-per-block count the kernel has no
    instantiation for (checked by the wrapper before the op, so a trace
    for the card refuses it too)."""
    allowed = ROWS_PER_BLOCK_TC if tensor_cores else ROWS_PER_BLOCK
    if rows_per_block is not None and rows_per_block not in allowed:
        raise ValueError(f"rows_per_block must be one of {allowed}, got {rows_per_block}")


def _block_rows(rows_per_block, B, batch_tile, n, m, dev, tensor_cores):
    if rows_per_block is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return shared_block_rows(B, batch_tile, n, m, sms, tensor_cores)
    _check_rows(rows_per_block, tensor_cores)
    return rows_per_block


def _launch_tc(done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
               rows_per_block, *, check_every, sigma, alpha, eps_abs, eps_rel, batch_tile,
               iter_precision, l2_bytes=None):
    """The wrapper's path to the tensor-core form ``csrc/shared_chunk_tc.cu``
    on inputs checked by ``_contract``: room for the operators' bf16 hi/lo
    slices (``Ab`` for the rhs product, ``OP`` for the x product, ``Ab^T``
    for ``zt`` at ``"high"``, which the entry point packs as
    :func:`tc_operator_slices` does), outputs, votes and the launches.
    ``l2_bytes`` (an int64 ``(1,)`` tensor), where given, gets the bytes
    the kernel's bulk copies brought from L2 added to it; the kernel counts
    nothing without it."""
    B, n = x.shape
    m = z.shape[1]
    dev = x.device
    outs = _outputs(B, n, m, dev)
    if B == 0:
        return outs[:3] + (outs[3].bool(),) + outs[4:]
    rows = _block_rows(rows_per_block, B, batch_tile, n, m, dev, True)
    AbT = Ab.T.contiguous()

    def slices(K, J):
        return torch.empty(2 * _pad(K, 16) * _pad(J, 64), dtype=torch.bfloat16, device=dev)

    s_ab, s_op = slices(m, n), slices(n, n)
    # "mixed" runs zt as an FP32 chain and never packs or reads the third.
    s_abt = slices(n, m) if iter_precision == "high" else s_op
    n_checks = max(1, -(-bound // check_every))
    votes = torch.zeros((B // batch_tile, n_checks), dtype=torch.int32, device=dev)
    launch_chunk(
        "shared_admm_chunk", "shared_chunk_tc", "ocp_shared_admm_chunk_tc_f32",
        [done0, OP, Ab, AbT, Pb, rho, lb, ub, qb, Dinv, Einv, cinv,
         x, z, y, *outs, votes, s_ab, s_op, s_abt, l2_bytes],
        (B, n, m, batch_tile, rows, bound, check_every, n_checks,
         ITER_PRECISIONS.index(iter_precision)),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    shared_admm_chunk.tc_launches += 1
    return outs[:3] + (outs[3].bool(),) + outs[4:]


def _launch(done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
            rows_per_block, *, check_every, sigma, alpha, eps_abs, eps_rel, batch_tile,
            iter_precision="highest"):
    """The wrapper's kernel path: outputs, votes and the launches of
    ``csrc/shared_chunk.cu``'s FP32 form on inputs checked by
    ``_contract`` (``iter_precision`` must be ``"highest"``)."""
    if iter_precision != "highest":
        raise ValueError("the FP32 form runs iter_precision='highest' only")
    B, n = x.shape
    m = z.shape[1]
    dev = x.device

    outs = _outputs(B, n, m, dev)
    if B == 0:
        return outs[:3] + (outs[3].bool(),) + outs[4:]
    groups = B // batch_tile
    rows = _block_rows(rows_per_block, B, batch_tile, n, m, dev, False)
    n_checks = max(1, -(-bound // check_every))
    # Per group and check block: how many of the group's thread blocks
    # still held an unconverged scenario (read by the next check's launch).
    votes = torch.zeros((groups, n_checks), dtype=torch.int32, device=dev)
    launch_chunk(
        "shared_admm_chunk", "shared_chunk", "ocp_shared_admm_chunk_f32",
        [done0, OP, Ab, Ab.T.contiguous(), Pb, rho, lb, ub, qb, Dinv, Einv, cinv,
         x, z, y, *outs, votes],
        (B, n, m, batch_tile, rows, bound, check_every, n_checks),
        (sigma, alpha, eps_abs, eps_rel), dev,
    )
    shared_admm_chunk.launches += 1
    return outs[:3] + (outs[3].bool(),) + outs[4:]


shared_admm_chunk.launches = 0
shared_admm_chunk.tc_launches = 0


@torch.library.custom_op("ocp_torch::shared_admm_chunk", mutates_args=(), device_types="cpu")
def _shared_op(done0: Tensor, bound: Tensor, OP: Tensor, Ab: Tensor, Pb: Tensor, rho: Tensor,
               lb: Tensor, ub: Tensor, qb: Tensor, Dinv: Tensor, Einv: Tensor, cinv: Tensor,
               x: Tensor, z: Tensor, y: Tensor, check_every: int, sigma: float, alpha: float,
               eps_abs: float, eps_rel: float, batch_tile: int, iter_precision: str,
               rows_per_block: Optional[int]) -> List[Tensor]:
    """The op's CPU implementation: the plain version (``done0`` int32,
    ``cinv`` (1,), as :func:`_contract` gives them), its outputs copied
    (an op may return no input: a group all done at entry returns its
    panels).  ``rows_per_block`` is the card's alone."""
    return [o.clone() for o in shared_admm_chunk_plain(
        done0, int(bound), OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y,
        check_every=check_every, sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
        batch_tile=batch_tile, iter_precision=iter_precision)]


@_shared_op.register_kernel("cuda")
def _(done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y, check_every,
      sigma, alpha, eps_abs, eps_rel, batch_tile, iter_precision, rows_per_block):
    """The CUDA implementation: the FP32 form or the tensor-core form,
    ``bound`` read on the host (a sync where it lies on the card).  No
    input is written: the group votes and the operator slices live in
    buffers the launch allocates."""
    launch = _launch if iter_precision == "highest" else _launch_tc
    return list(launch(done0, int(bound), OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z,
                       y, rows_per_block, check_every=check_every, sigma=sigma, alpha=alpha,
                       eps_abs=eps_abs, eps_rel=eps_rel, batch_tile=batch_tile,
                       iter_precision=iter_precision))


@_shared_op.register_fake
def _(done0, bound, OP, Ab, Pb, rho, lb, ub, qb, Dinv, Einv, cinv, x, z, y, *args):
    B, n = x.shape
    conv = torch.empty((B,), dtype=torch.bool, device=x.device)
    it_inc = torch.empty((B,), dtype=torch.int32, device=x.device)
    return [torch.empty_like(x), torch.empty_like(z), torch.empty_like(y), conv, it_inc,
            *(x.new_empty((B,)) for _ in range(4))]
