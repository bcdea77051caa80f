"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its
module names and parameter layouts and never imports JAX.  Kernels are
hand-written CUDA in ``csrc/``, built on first use
(``repro_torch.kernels.build``).
"""
