"""Symbolic expression layer: the CasADi-``SX`` analog, evaluated with
torch — port of ``optimal_control_problem_tpu/sym.py``.

Users compose expressions imperatively, as with CasADi::

    X = sym("X", 40)
    q = X[0:2]
    cost = q[0] ** 2 + sin(q[1])

A :class:`Sym` is a tiny deferred-evaluation node (a closure over its
children) that evaluates to a torch tensor given an environment binding
leaf names to tensors.  ``compile_fn`` turns expression outputs into an
ordinary function of the leaf tensors, which ``torch.func`` differentiates
and maps (``hessian``, ``jacfwd``, ``vmap``) like any other.  Evaluation
memoizes on node identity, so shared subexpressions (a DAG, as in CasADi)
evaluate once.

Every node applies out-of-place torch ops only, and a constant enters as a
Python float (one element) or as a tensor made at evaluation time on the
other operand's device and dtype, so an expression runs unchanged under
``torch.func`` and on the card.

All expressions are 1-D float vectors of static shape ``(n,)`` (CasADi's
``n x 1`` column matrices); scalars are shape ``(1,)``.
"""

from __future__ import annotations

import operator
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "Sym",
    "sym",
    "const",
    "vertcat",
    "sumsqr",
    "dot",
    "sin",
    "cos",
    "tan",
    "exp",
    "log",
    "sqrt",
    "tanh",
    "abs_",
    "asin",
    "acos",
    "atan",
    "atan2",
    "minimum",
    "maximum",
    "power",
    "norm_2",
    "compile_fn",
    "evaluate",
]


def _as_1d(x) -> torch.Tensor:
    a = torch.as_tensor(x)
    if a.ndim == 0:
        a = a.reshape(1)
    if a.ndim != 1:
        raise ValueError(f"Sym expressions are 1-D vectors; got shape {tuple(a.shape)}")
    return a


def _const_1d(value) -> np.ndarray:
    """A constant operand as a float64 numpy vector (made a tensor only
    when evaluated, on the other operand's device and dtype)."""
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.ndim != 1:
        raise ValueError(f"Sym expressions are 1-D vectors; got shape {arr.shape}")
    return arr


def _like(arr: np.ndarray, ref: torch.Tensor):
    """A constant operand for an op with ``ref``: a Python float when it
    has one element (no tensor is made), else a tensor of ``ref``'s dtype
    on ``ref``'s device.  Made anew at each evaluation: a tensor kept
    across calls would escape ``torch.func``'s transforms."""
    if arr.shape[0] == 1:
        return float(arr[0])
    return torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)


def _on_tensors(op):
    """``op`` for torch functions that take tensors only: a Python-float
    operand becomes a tensor filled like the other."""

    def f(a, b):
        if not torch.is_tensor(a):
            a = torch.full_like(b, a)
        if not torch.is_tensor(b):
            b = torch.full_like(a, b)
        return op(a, b)

    return f


class Sym:
    """A deferred 1-D expression node.

    ``_fn(env, memo)`` computes this node's value; ``children`` keeps strong
    references so ``id()``-based memoization is safe for the duration of an
    ``evaluate`` call.
    """

    __slots__ = ("_fn", "shape", "children", "name")

    def __init__(self, fn, shape, children=(), name=None):
        self._fn = fn
        self.shape = (int(shape[0]),)
        self.children = tuple(children)
        self.name = name

    # -- evaluation -------------------------------------------------------
    def _ev(self, env: dict, memo: dict) -> torch.Tensor:
        key = id(self)
        val = memo.get(key)
        if val is None:
            val = self._fn(env, memo)
            memo[key] = val
        return val

    # -- introspection ----------------------------------------------------
    def size1(self) -> int:
        """CasADi-compatible row count (``SX::size1``)."""
        return self.shape[0]

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self):
        if self.name is not None:
            return f"Sym({self.name!r}, n={self.shape[0]})"
        return f"Sym(n={self.shape[0]})"

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, idx) -> "Sym":
        n = self.shape[0]
        if isinstance(idx, slice):
            start, stop, step = idx.indices(n)
            size = len(range(start, stop, step))
            if size == 0:
                raise IndexError("empty Sym slice")
            return Sym(
                lambda env, memo: self._ev(env, memo)[idx], (size,), (self,)
            )
        idx = int(idx)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"index {idx} out of range for Sym of size {n}")
        return Sym(
            lambda env, memo: self._ev(env, memo)[idx : idx + 1], (1,), (self,)
        )

    # -- arithmetic -------------------------------------------------------
    def _binary(self, other, op) -> "Sym":
        mine = _const_of(self)
        if mine is not None and isinstance(other, Sym) and _const_of(other) is None:
            # const(c) op x: the constant takes x's device and dtype.
            return other._binary(mine, lambda a, b: op(b, a))
        arr = _const_of(other)
        if arr is None:
            n, m = self.shape[0], other.shape[0]
            if n != m and n != 1 and m != 1:
                raise ValueError(f"shape mismatch in Sym op: {n} vs {m}")
            return Sym(
                lambda env, memo: op(self._ev(env, memo), other._ev(env, memo)),
                (max(n, m),),
                (self, other),
            )
        n, m = self.shape[0], arr.shape[0]
        if n != m and n != 1 and m != 1:
            raise ValueError(f"shape mismatch in Sym op: {n} vs {m}")

        def fn(env, memo):
            a = self._ev(env, memo)
            return op(a, _like(arr, a))

        return Sym(fn, (max(n, m),), (self,))

    def _rbinary(self, other, op) -> "Sym":
        return self._binary(other, lambda a, b: op(b, a))

    # Python's operators, so that either operand may be a Python float.
    def __add__(self, o):
        return self._binary(o, operator.add)

    def __radd__(self, o):
        return self._rbinary(o, operator.add)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __rsub__(self, o):
        return self._rbinary(o, operator.sub)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __rmul__(self, o):
        return self._rbinary(o, operator.mul)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._rbinary(o, operator.truediv)

    def __pow__(self, o):
        return self._binary(o, operator.pow)

    def __rpow__(self, o):
        return self._rbinary(o, operator.pow)

    def __neg__(self):
        return Sym(lambda env, memo: torch.neg(self._ev(env, memo)), self.shape, (self,))

    def __matmul__(self, o):
        return dot(self, o)


def sym(name: str, size: int) -> Sym:
    """Create a leaf symbol vector — the analog of ``SX::sym(name, size)``."""
    if size < 0:
        raise ValueError("symbol size must be >= 0")

    def fetch(env, memo):
        try:
            val = env[name]
        except KeyError:
            raise KeyError(f"no binding for symbol {name!r}") from None
        val = _as_1d(val)
        if val.shape[0] != size:
            raise ValueError(
                f"symbol {name!r} expects size {size}, bound value has {val.shape[0]}"
            )
        return val

    return Sym(fetch, (size,), (), name=name)


def const(value) -> Sym:
    """A constant vector.  Combined with a symbol it becomes a tensor of the
    symbol's device and dtype; evaluated on its own, a float64 CPU
    tensor."""
    arr = _const_1d(value)

    def fn(env, memo):
        return torch.as_tensor(arr)

    fn.value = arr
    return Sym(fn, arr.shape, ())


def _const_of(x):
    """The value of a constant operand (a number, an array or a
    :func:`const` node) as a float64 numpy vector; None for any other
    expression."""
    if isinstance(x, Sym):
        return getattr(x._fn, "value", None)
    return _const_1d(x)


def _unary(op):
    def f(x: Sym) -> Sym:
        value = _const_of(x)
        if value is not None:  # folded, so it stays a constant
            return const(op(torch.as_tensor(value)).numpy())
        return Sym(lambda env, memo: op(x._ev(env, memo)), x.shape, (x,))

    return f


sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
exp = _unary(torch.exp)
log = _unary(torch.log)
sqrt = _unary(torch.sqrt)
tanh = _unary(torch.tanh)
abs_ = _unary(torch.abs)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)


def _binary_fn(op):
    def f(a, b) -> "Sym":
        if not isinstance(a, Sym):
            if not isinstance(b, Sym):
                return const(op(torch.as_tensor(_const_1d(a)),
                                torch.as_tensor(_const_1d(b))).numpy())
            return b._rbinary(a, op)
        return a._binary(b, op)

    return f


atan2 = _binary_fn(_on_tensors(torch.atan2))
minimum = _binary_fn(_on_tensors(torch.minimum))
maximum = _binary_fn(_on_tensors(torch.maximum))
power = _binary_fn(operator.pow)


def norm_2(x: Sym) -> Sym:
    """Euclidean norm (CasADi ``norm_2``)."""
    return Sym(
        lambda env, memo: torch.linalg.vector_norm(x._ev(env, memo)).reshape(1),
        (1,),
        (x,),
    )


def vertcat(*parts) -> Sym:
    """Concatenate expressions — the analog of ``SX::vertcat``."""
    if len(parts) == 1 and isinstance(parts[0], (list, tuple)):
        parts = tuple(parts[0])
    if not parts:
        raise ValueError("vertcat of nothing")
    items = [p if (v := _const_of(p)) is None else v for p in parts]
    syms = [p for p in items if isinstance(p, Sym)]
    if not syms:
        return const(np.concatenate(items))
    total = sum(p.shape[0] for p in items)

    def fn(env, memo):
        ref = syms[0]._ev(env, memo)
        return torch.cat([p._ev(env, memo) if isinstance(p, Sym)
                          else torch.as_tensor(p, dtype=ref.dtype, device=ref.device)
                          for p in items])

    return Sym(fn, (total,), tuple(syms))


def sumsqr(x: Sym) -> Sym:
    return Sym(
        lambda env, memo: torch.sum(torch.square(x._ev(env, memo))).reshape(1),
        (1,),
        (x,),
    )


def dot(a: Sym, b) -> Sym:
    n_b = b.shape[0] if isinstance(b, Sym) else _const_1d(b).shape[0]
    if a.shape[0] != n_b:
        raise ValueError(f"dot shape mismatch: {a.shape[0]} vs {n_b}")
    prod = a * b
    return Sym(
        lambda env, memo: torch.sum(prod._ev(env, memo)).reshape(1),
        (1,),
        (prod,),
    )


def evaluate(expr: Sym, env: dict) -> torch.Tensor:
    """Evaluate an expression under leaf bindings ``{name: tensor}``."""
    return expr._ev(env, {})


def compile_fn(outputs: Sequence[Sym] | Sym, inputs: Sequence[Sym]) -> Callable:
    """Compile expressions to a plain function of the leaf tensors.

    ``inputs`` must be leaf symbols (created via :func:`sym`).  The returned
    function takes tensors positionally (matching ``inputs``) and returns
    the evaluated output tensor(s); it is a pure torch function that
    ``torch.func`` differentiates and maps.
    """
    single = isinstance(outputs, Sym)
    outs = [outputs] if single else list(outputs)
    names = []
    for s in inputs:
        if s.name is None:
            raise ValueError("compile_fn inputs must be leaf symbols with names")
        names.append(s.name)

    def fn(*arrays):
        if len(arrays) != len(names):
            raise TypeError(f"expected {len(names)} arguments, got {len(arrays)}")
        env = dict(zip(names, arrays))
        memo: dict = {}
        results = [o._ev(env, memo) for o in outs]
        return results[0] if single else tuple(results)

    return fn
