"""Model library.  Ported so far: cart-pole (short-horizon main path) and
the quadrotor (long-horizon main path); the double integrator and unicycle
follow (ROADMAP Queue A5)."""

from . import cartpole, quadrotor
from .cartpole import CartPoleOCP
from .quadrotor import QuadrotorOCP

__all__ = ["cartpole", "quadrotor", "CartPoleOCP", "QuadrotorOCP"]
