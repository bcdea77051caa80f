"""The paper's Provet machine, ISA, CNN templates and the section 7
analytical suite: a numpy-only copy of ``repro.core`` (the JAX
package's copy is the reference; only the package imports differ).

Its numbers are the paper's analytical models (Provet, systolic arrays,
a TPU, ARA and an A100 at 200 MHz), not measurements of this port: the
port's H100 times are those of ``kernels.vwr_conv2d`` and
``kernels.vwr_depthwise`` in ``chip_smoke.py``.
"""
from repro_torch.core import (analysis, isa, machine, ref_ops,  # noqa: F401
                              templates)
