"""Serving engine (dense cache, one device)."""
from repro_torch.engine.cache import pad_cache_from_prefill  # noqa: F401
from repro_torch.engine.engine import (DecodeEngine,  # noqa: F401
                                       EngineConfig, NonFiniteLogitsError)
