"""Model library.  Ported so far: the double integrator (LTI, the
shared-factorization main path), cart-pole (short-horizon banded main path)
and the quadrotor (long-horizon banded main path); the unicycle follows
(ROADMAP Queue A5)."""

from . import cartpole, double_integrator, quadrotor
from .cartpole import CartPoleOCP
from .double_integrator import DoubleIntegratorOCP
from .quadrotor import QuadrotorOCP

__all__ = [
    "cartpole",
    "double_integrator",
    "quadrotor",
    "CartPoleOCP",
    "DoubleIntegratorOCP",
    "QuadrotorOCP",
]
