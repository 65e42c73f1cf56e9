"""Kernels of the port's hot paths.

Each TPU (Pallas) kernel of the JAX package becomes a hand-written CUDA
kernel under ``csrc/``, with a plain PyTorch version of the same contract
beside its wrapper.  Ported: the two banded ADMM chunk kernels of the
batched MPC tick, ``banded_kernel.banded_admm_chunk`` (one-way
block-Thomas, ``w`` in ``KERNEL_WIDTHS``) and
``banded_rolled_kernel.banded_admm_chunk_rolled`` (two-way factorization
with an optional depth-1 cyclic-reduction level, any ``w`` up to 16) and
``banded_cr_kernel.banded_admm_chunk_cr`` (cyclic reduction over whole
levels, ``banded_solver="cr"``, any ``w`` up to 16);
``solvers/admm_banded_batch.chunk_kernel`` picks among them; and the
shared-operator chunk of the LTI path, ``shared_kernel.shared_admm_chunk``
(``backend="pallas"`` of ``solvers/admm_batched.py``); and the dense
per-scenario device loop, ``admm_kernel.admm_device_loop``
(``backend="pallas"`` of ``solvers/admm.py``).

Importing this package registers each kernel as a custom op,
``torch.ops.ocp_torch.<wrapper name>`` (the five modules below), which
``torch.export`` programs of the solves hold (``utils/serialization``).
"""

from . import admm_kernel, banded_cr_kernel, banded_kernel, banded_rolled_kernel  # noqa: F401
from . import shared_kernel  # noqa: F401
