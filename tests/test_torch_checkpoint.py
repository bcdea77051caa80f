"""The port's checkpoint store (``repro_torch.checkpoint``).

Port copies of the JAX store's tests (``tests/test_checkpoint_data_optim.py``:
roundtrip, keep-k, atomicity, async, async failure, stray directories),
then what the port adds: a bf16 leaf round-trips bit for bit (numpy has
no bfloat16: the store writes its 16-bit words), a save is a private
copy (an async write never sees a later in-place write), restore writes
into the target tensors in place and refuses a shape or dtype that
differs, and the JAX package's ``.npy`` / ``index.json`` files read in
the port and the port's in the JAX package (fp32, int8, int32).  The
durable-serving modules import neither ``jax`` nor ``ml_dtypes``.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import _leaf_paths  # noqa: E402
from repro_torch.runtime.resilience import (RestartPolicy,  # noqa: E402
                                            run_with_restarts)


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else
                None if v is None else torch.zeros_like(v))
            for k, v in tree.items()}


# ------------------------------------------------- the JAX store's cases

def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    store.save(1, tree)
    out = store.restore(1, _zeros_like(tree))
    torch.testing.assert_close(out["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(out["b"]["c"], tree["b"]["c"], rtol=0,
                               atol=0)


def test_checkpoint_keep_k_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        store.save(s, tree)
    assert store.steps() == [3, 4]
    assert store.latest_step() == 4


def test_checkpoint_atomicity(tmp_path):
    """Incomplete directories (no _COMPLETE) are invisible."""
    store = CheckpointStore(str(tmp_path))
    store.save(5, {"x": torch.ones((2,))})
    os.makedirs(tmp_path / "step_9")          # crashed write, no marker
    os.makedirs(tmp_path / "step_11.tmp")     # crashed before the rename
    assert store.latest_step() == 5


def test_checkpoint_async(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"x": torch.full((128, 128), 3.0)}
    store.save(1, tree, async_=True)
    store.wait()
    out = store.restore(1, _zeros_like(tree))
    assert float(out["x"][0, 0]) == 3.0


def test_checkpoint_async_failure_surfaces_on_wait(tmp_path, monkeypatch):
    """A failed background write re-raises at wait() — exactly once —
    and the store is usable again afterwards."""
    store = CheckpointStore(str(tmp_path))
    tree = {"x": torch.zeros((2,))}
    real_write = store._write

    def boom(step, host):
        raise OSError("disk died")

    monkeypatch.setattr(store, "_write", boom)
    store.save(1, tree, async_=True)
    with pytest.raises(OSError, match="disk died"):
        store.wait()
    store.wait()                        # idempotent: no second raise
    monkeypatch.setattr(store, "_write", real_write)
    store.save(2, tree, async_=True)    # save() joins via wait() too
    store.wait()
    assert store.latest_step() == 2


def test_checkpoint_steps_skips_stray_dirs(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(3, {"x": torch.zeros((2,))})
    os.makedirs(tmp_path / "step_backup")
    (tmp_path / "step_backup" / "_COMPLETE").write_text("ok")
    (tmp_path / "step_7b").mkdir()
    assert store.steps() == [3]
    assert store.latest_step() == 3


def test_run_with_restarts(tmp_path):
    store = CheckpointStore(str(tmp_path))
    calls = []

    def make_state(resume):
        calls.append(resume)
        return {"resume": resume}

    def run(state):
        if state["resume"] is None:
            store.save(10, {"x": torch.ones(2)})
            raise RuntimeError("simulated node failure")
        assert state["resume"] == 10

    run_with_restarts(make_state, run, store,
                      RestartPolicy(max_restarts=3, backoff_s=0.0))
    assert calls == [None, 10]


def test_run_with_restarts_gives_up(tmp_path):
    """Past ``max_restarts`` the last failure re-raises."""
    store = CheckpointStore(str(tmp_path))
    calls = []

    def run(state):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError, match="always down"):
        run_with_restarts(calls.append, run, store,
                          RestartPolicy(max_restarts=2, backoff_s=0.0))
    assert calls == [None, None, None]


# ------------------------------------------------- what the port adds

def test_bf16_leaf_roundtrips_bitwise(tmp_path):
    """Every bf16 bit pattern but the NaNs' (signed zeros, subnormals,
    infinities, the extremes) comes back as it went in, through the
    store's 16-bit words; the index names the dtype bfloat16."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[~torch.isnan(x)].reshape(-1, 2)
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"w": x})
    index = json.loads((tmp_path / "step_1" / "index.json").read_text())
    assert index["w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_1" / "w.s0.npy").dtype == np.dtype("V2")
    out = store.restore(1, {"w": torch.zeros_like(x)})["w"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), x.view(torch.int16))


def test_save_is_a_private_copy(tmp_path, monkeypatch):
    """An async save of a tensor that is written in place right after
    saves the bytes of the cut: the background write is held until the
    tensor has changed, and still writes the old values."""
    store = CheckpointStore(str(tmp_path))
    x = torch.arange(6, dtype=torch.float32)
    go = threading.Event()
    real_write = store._write

    def held(step, host):
        go.wait(10)
        real_write(step, host)

    monkeypatch.setattr(store, "_write", held)
    store.save(1, {"x": x}, async_=True)
    x.add_(100)
    go.set()
    store.wait()
    out = store.restore(1, {"x": torch.zeros(6)})
    torch.testing.assert_close(out["x"], torch.arange(6.0), rtol=0, atol=0)


def test_restore_writes_in_place_and_checks(tmp_path):
    """Restore copies into the target tensors (same storage, same
    strides: a strided view stays a view), and refuses a shape or a
    dtype that differs from the saved leaf."""
    store = CheckpointStore(str(tmp_path))
    src = torch.randn(3, 5)
    store.save(1, {"a": src, "n": None})
    base = torch.zeros(3, 8)
    view = base[:, :5]
    ptr, stride = view.data_ptr(), view.stride()
    store.restore(1, {"a": view})
    assert view.data_ptr() == ptr and view.stride() == stride
    torch.testing.assert_close(base[:, :5], src, rtol=0, atol=0)
    assert not base[:, 5:].any()
    with pytest.raises(ValueError, match="shape"):
        store.restore(1, {"a": torch.zeros(5, 3)})
    with pytest.raises(ValueError, match="dtype"):
        store.restore(1, {"a": torch.zeros(3, 5, dtype=torch.float64)})


def test_leaf_keys_follow_the_jax_walk():
    """Nested dict keys sorted and joined by '/', None subtrees dropped:
    the moe cache's {'dense': None, 'moe': {...}} gives 'cache/moe/ckv',
    as in the JAX store."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint.store import _leaf_paths as jax_leaf_paths
    t = torch.zeros(1)
    tree = {"host": t, "cache": {"moe": {"ckv": t, "ckv_scale": t},
                                 "dense": None}}
    assert list(_leaf_paths(tree)) == [
        "cache/moe/ckv", "cache/moe/ckv_scale", "host"]
    assert list(jax_leaf_paths(jax.tree.map(np.asarray, tree))) == \
        list(_leaf_paths(tree))


def _jax_tree():
    rng = np.random.default_rng(3)
    return {"cache": {"k": rng.standard_normal((2, 3, 4)).astype(np.float32),
                      "q": rng.integers(-127, 128, (5, 2)).astype(np.int8)},
            "meta": {"lens": rng.integers(0, 99, (4,)).astype(np.int32)}}


def test_reads_a_jax_written_store(tmp_path):
    """The JAX store's files (one leaf a dtype: fp32, int8, int32) read
    in the port bit for bit."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import CheckpointStore as JStore
    tree = _jax_tree()
    JStore(str(tmp_path)).save(4, jax.tree.map(jax.numpy.asarray, tree))
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() == 4
    target = {k: {n: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype)))
                  for n, a in g.items()} for k, g in tree.items()}
    out = store.restore(4, target)
    for k, g in tree.items():
        for n, a in g.items():
            np.testing.assert_array_equal(out[k][n].numpy(), a)


def test_reads_a_jax_written_bf16_leaf(tmp_path):
    """A bf16 leaf the JAX store wrote (``np.save`` of an ml_dtypes
    array: raw 16-bit words) reads in the port bit for bit, though the
    JAX store's own restore cannot cast it back (ROADMAP queue 3)."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import CheckpointStore as JStore
    x = jax.numpy.linspace(-3, 3, 24, dtype=jax.numpy.bfloat16).reshape(4, 6)
    JStore(str(tmp_path)).save(1, {"x": x})
    out = CheckpointStore(str(tmp_path)).restore(
        1, {"x": torch.zeros((4, 6), dtype=torch.bfloat16)})["x"]
    want = np.asarray(x).view(np.int16)
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), want)


def test_jax_reads_a_port_written_store(tmp_path):
    """The port's files read in the JAX store bit for bit, at the JAX
    store's own leaf keys."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import CheckpointStore as JStore
    tree = _jax_tree()
    CheckpointStore(str(tmp_path)).save(
        2, {k: {n: torch.from_numpy(a) for n, a in g.items()}
            for k, g in tree.items()})
    spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)
    out = JStore(str(tmp_path)).restore(2, spec)
    for k, g in tree.items():
        for n, a in g.items():
            got = np.asarray(out[k][n])
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)


def test_durable_modules_import_no_jax():
    """The store, snapshot, journal and resilience modules (and the
    engine package that exports them) import neither jax nor ml_dtypes
    nor anything of the JAX package, checked in a fresh interpreter."""
    code = (
        "import sys\n"
        "import repro_torch.checkpoint.store, repro_torch.engine.snapshot\n"
        "import repro_torch.engine.journal, repro_torch.runtime.resilience\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
