"""The paper's own application: CNN layers on the Provet machine.

Not an LM config: this exposes the section 6/7 artifacts (ISA machine,
templates, analysis suite) of the port's numpy-only ``core`` copy under
the same registry, as ``repro.configs.provet_cnn`` does."""
from repro_torch.core.analysis import LAYERS, PROVET_FULL, run_suite  # noqa: F401
from repro_torch.core.machine import PAPER_EXAMPLE, ProvetConfig  # noqa: F401

CONFIG = None  # not a ModelConfig; see module docstring
