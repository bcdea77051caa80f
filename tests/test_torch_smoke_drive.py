"""``chip_smoke._drive``, the loop that feeds a Scheduler stream in bursts
and steps it until every request is done: on the CPU with a reduced
config it drains a stream, and a Scheduler that can admit nothing (every
page held) makes it raise with the Scheduler's state within its cap of
rounds instead of spinning for as long as the caller lets it."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.engine import (DecodeEngine, EngineConfig,  # noqa: E402
                                RequestStatus, Scheduler)
from repro_torch.engine import faults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engine():
    cfg = reduced(get_config("tinyllama-1.1b")).replace(dtype="float32")
    return DecodeEngine(cfg, EngineConfig(batch=2, max_len=48, paged=True,
                                          page_size=4, n_pages=24,
                                          kernel_impl="torch"),
                        device="cpu")


def test_drive_drains_a_stream(smoke, engine):
    reqs = smoke._requests(engine.cfg, 5, (8, 20), 6, seed=3)
    sched = Scheduler(engine)
    out = smoke._drive(sched, reqs)
    assert sorted(out) == [r.rid for r in reqs]
    assert all(o.status == RequestStatus.FINISHED for o in out.values())
    assert sched.allocator.free_pages == engine.n_pages


@pytest.mark.parametrize("held", [23, 24])
def test_drive_raises_on_a_stalled_scheduler(smoke, engine, held):
    """With every page but one (or every page) held no request is ever
    admitted: the loop raises, naming the steps, pending, parked and
    active counts."""
    reqs = smoke._requests(engine.cfg, 5, (8, 20), 6, seed=3)
    sched = Scheduler(engine)
    release = faults.hold_pages(sched, held)
    try:
        with pytest.raises(AssertionError, match="stalled.*steps 0, "
                           "pending 5, parked 0, active 0"):
            smoke._drive(sched, reqs)
    finally:
        release()
