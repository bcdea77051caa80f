"""Serving engine on one device: ``DecodeEngine`` over a dense or a
paged KV cache, and ``Scheduler`` continuous batching over the paged one
(requests walk the ``RequestStatus`` lifecycle and end as
``RequestResult``s; fault injectors are in ``engine.faults``)."""
from repro_torch.engine.cache import pad_cache_from_prefill
from repro_torch.engine.engine import (DecodeEngine, EngineConfig,
                                       NonFiniteLogitsError)
from repro_torch.engine.paged_cache import (PageAllocator, PagePoolExhausted,
                                            bucket_table_width, fork_page)
from repro_torch.engine.scheduler import (Request, RequestResult,
                                          RequestStatus, Scheduler)

__all__ = ["DecodeEngine", "EngineConfig", "NonFiniteLogitsError",
           "pad_cache_from_prefill", "PageAllocator", "PagePoolExhausted",
           "Request", "RequestResult", "RequestStatus", "Scheduler",
           "bucket_table_width", "fork_page"]
