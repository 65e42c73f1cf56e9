"""Device policy for the port's entry points.

Every entry point (``OptimalControlProblem``, ``models.*.build``,
``BatchedSolver``, ``admm_solve_banded_batch(_T)``) resolves its device
here: ``cuda`` unless the caller asks for something else, and an error --
never a silent CPU run -- when no GPU is present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if b is None:
        return False
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib
