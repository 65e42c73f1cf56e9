"""The part of the symbolic expression layer that :class:`..config.OCPConfig`
needs: leaf symbols and named slices of them.

Counterpart of ``optimal_control_problem_tpu/sym.py`` (the CasADi-``SX``
analog).  ``OCPConfig`` creates the flat decision vector as a leaf
``sym("X", horizon * frame_size)`` and hands out slices of it
(``get_variable``); the NLP front-end reads a leaf's name and size.  The
expression arithmetic (costs built from ``Sym`` trees) is not ported yet:
the port's models write their costs as torch callables.  A ``Sym``
evaluates to a torch tensor given an environment binding leaf names to
tensors.
"""

from __future__ import annotations

import torch

__all__ = ["Sym", "sym", "evaluate"]


def _as_1d(x) -> torch.Tensor:
    a = torch.as_tensor(x)
    if a.ndim == 0:
        a = a.reshape(1)
    if a.ndim != 1:
        raise ValueError(f"Sym expressions are 1-D vectors; got shape {tuple(a.shape)}")
    return a


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

    def _ev(self, env: dict, memo: dict) -> torch.Tensor:
        key = id(self)
        val = memo.get(key)
        if val is None:
            val = self._fn(env, memo)
            memo[key] = val
        return val

    def size1(self) -> int:
        """CasADi-compatible row count (``SX::size1``)."""
        return self.shape[0]

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self):
        if self.name is not None:
            return f"Sym({self.name!r}, n={self.shape[0]})"
        return f"Sym(n={self.shape[0]})"

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


def evaluate(expr: Sym, env: dict) -> torch.Tensor:
    """Evaluate an expression under leaf bindings ``{name: tensor}``."""
    return expr._ev(env, {})
