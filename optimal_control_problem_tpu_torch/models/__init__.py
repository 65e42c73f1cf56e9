"""Model library.  Ported so far: cart-pole (the main path's model); the
double integrator, unicycle and quadrotor follow (ROADMAP Queue A5)."""

from . import cartpole
from .cartpole import CartPoleOCP

__all__ = ["cartpole", "CartPoleOCP"]
