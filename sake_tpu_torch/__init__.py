"""PyTorch / CUDA port of ``sake_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``sake_tpu`` is the reference; this package mirrors its
module names. Plain tensor code is PyTorch; the TPU kernels on the ported
path are hand-written CUDA in ``csrc/``, built at first use.
"""
