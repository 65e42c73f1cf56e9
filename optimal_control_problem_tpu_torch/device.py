"""Device policy for the port's entry points.

Every entry point (``OptimalControlProblem``, ``models.*.build``,
``BatchedSolver``, ``admm_solve_banded_batch(_T)``) resolves its device
here: ``cuda`` unless the caller asks for something else, and an error --
never a silent CPU run -- when no GPU is present.

The public array functions take what the JAX package's take: tensors,
numpy arrays, Python sequences and numbers (:func:`as_tensors`).  A tensor
keeps its device; anything else is converted as ``jnp.asarray`` converts
it with 64-bit types off (float64 becomes float32, int64 int32).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensors"]

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


# ``jnp.asarray`` with 64-bit types off (JAX's default) narrows these.
_NARROW = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.complex128): np.complex64,
}


def as_tensors(*arrays, device: DeviceLike = None):
    """Each of ``arrays`` as a tensor: a tensor (or ``None``) as it is; a
    numpy array, Python sequence or number copied to a new tensor with
    JAX's dtype rule (64-bit floats and ints narrowed to 32 bits).  The new
    tensors go to ``device`` when it is given, else to the device of the
    first tensor among ``arrays``, else to :func:`resolve_device`'s
    default, ``cuda``, raising where there is none.  Returns a tuple."""
    if device is not None:
        target = resolve_device(device)
    else:
        target = next((a.device for a in arrays if isinstance(a, torch.Tensor)), None)
    out = []
    for a in arrays:
        if a is not None and not isinstance(a, torch.Tensor):
            if target is None:
                target = resolve_device(None)
            arr = np.asarray(a)
            arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype))
            a = torch.tensor(arr, device=target)
        out.append(a)
    return tuple(out)
