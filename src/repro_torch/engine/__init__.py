"""Serving engine on one device: ``DecodeEngine`` over a dense or a
paged KV cache, and ``Scheduler`` continuous batching over the paged one
(requests walk the ``RequestStatus`` lifecycle and end as
``RequestResult``s; fault injectors are in ``engine.faults``), with the
``PrefixCache`` radix trie and chunked prefill.  Durability rides on
top: the scheduler's full serving state snapshots crash-consistently
(``engine.snapshot``) and every request event is write-ahead journaled
(``engine.journal``), so ``runtime.resilience.serve_with_recovery``
survives process death with the crash-free run's streams."""
from repro_torch.engine.cache import pad_cache_from_prefill
from repro_torch.engine.engine import (DecodeEngine, EngineConfig,
                                       NonFiniteLogitsError)
from repro_torch.engine.journal import RequestJournal, read_events, replay
from repro_torch.engine.paged_cache import (PageAllocator, PagePoolExhausted,
                                            bucket_table_width, fork_page)
from repro_torch.engine.prefix_cache import PrefixCache
from repro_torch.engine.scheduler import (Request, RequestResult,
                                          RequestStatus, Scheduler)
from repro_torch.engine.snapshot import EngineSnapshotter, restore, snapshot

__all__ = ["DecodeEngine", "EngineConfig", "NonFiniteLogitsError",
           "pad_cache_from_prefill", "PageAllocator", "PagePoolExhausted",
           "PrefixCache",
           "Request", "RequestJournal", "RequestResult", "RequestStatus",
           "Scheduler", "EngineSnapshotter", "bucket_table_width",
           "fork_page", "read_events", "replay", "restore", "snapshot"]
