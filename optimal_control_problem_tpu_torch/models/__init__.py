"""Model library: the double integrator (LTI, the shared-factorization
path), cart-pole and the unicycle (short-horizon banded paths) and the
quadrotor (long-horizon banded path)."""

from . import cartpole, double_integrator, quadrotor, unicycle
from .cartpole import CartPoleOCP
from .double_integrator import DoubleIntegratorOCP
from .quadrotor import QuadrotorOCP
from .unicycle import UnicycleOCP

__all__ = [
    "cartpole",
    "double_integrator",
    "quadrotor",
    "unicycle",
    "CartPoleOCP",
    "DoubleIntegratorOCP",
    "QuadrotorOCP",
    "UnicycleOCP",
]
