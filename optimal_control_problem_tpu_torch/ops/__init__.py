"""Kernels of the port's hot paths.

Each TPU (Pallas) kernel of the JAX package becomes a hand-written CUDA
kernel under ``csrc/``, with a plain PyTorch version of the same contract
beside its wrapper.  Ported: ``banded_kernel.banded_admm_chunk``.
"""
