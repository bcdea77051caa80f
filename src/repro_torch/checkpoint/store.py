"""Atomic, keep-k checkpointing in the JAX package's shard layout.

Counterpart of ``repro.checkpoint.store`` on one device.  Layout::

    <dir>/step_<n>/
        index.json            {key: {shape, dtype, shards: [{spans, file}]}}
        <leaf_id>.s<k>.npy    shard k of a leaf (leaf_id: key, "/" -> "__")
        _COMPLETE             commit marker (atomicity)

  * atomic: written into ``step_<n>.tmp``, the marker fsynced, then
    renamed; readers only trust directories holding ``_COMPLETE``;
  * keep-k GC and an async save on one background worker, joined
    before the next save (at most one in flight); ``wait()`` re-raises
    a failed write;
  * leaf keys are the JAX store's: the path of each leaf through nested
    dicts (keys sorted), NamedTuples (``.<field>``, fields in order:
    an optimizer state ``OptState`` keys as ``opt/.step``,
    ``opt/.m/<path>``, ...) and plain tuples and lists (the index),
    joined by ``/``, with ``None`` subtrees dropped, as
    ``jax.tree_util.tree_flatten_with_path`` walks them, so a store
    written by either package reads in the other.

The port writes one shard per leaf (one device, no elastic re-shard);
``restore`` reads any number of shards a leaf was saved in.

``save`` copies every leaf to host memory before it returns: the port
writes its tensors in place, so a background writer must never see the
live storage (on the CPU ``t.cpu()`` is ``t`` itself and ``.numpy()``
shares its memory).  numpy has no bfloat16: a bf16 leaf is written as
its raw 16-bit words (``|V2``, the bytes ``np.save`` writes for an
ml_dtypes bf16 array) with ``"dtype": "bfloat16"`` in the index, and
read back bit for bit through an int16 view.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf_paths(tree) -> Dict[str, Any]:
    """{key: leaf} of a tree of nested dicts, NamedTuples, tuples and
    lists, ``None`` subtrees dropped, in the JAX flattening order (dict
    keys sorted, a NamedTuple's fields and a sequence's items in order)."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), path + ("." + f,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node
    walk(tree, ())
    return out


def _dtype_name(dtype) -> str:
    """The index's dtype string of a torch or numpy dtype (``float32``,
    ``bfloat16``, ``int8``, ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an index dtype string."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def _host_array(leaf) -> tuple:
    """(dtype name, private host numpy copy) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view("V2")
        return _dtype_name(t.dtype), t.numpy()
    arr = np.array(leaf, copy=True)
    return _dtype_name(arr.dtype), arr


def _read_shard(path: str, dtype: str) -> torch.Tensor:
    """One ``.npy`` shard as a CPU tensor of ``dtype``, by its bits for
    bfloat16 (never a casting assignment)."""
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 shard of {arr.dtype}")
        return torch.from_numpy(
            np.ascontiguousarray(arr.view(np.int16))).view(torch.bfloat16)
    if arr.dtype != np.dtype(dtype):
        raise ValueError(f"{path}: the index says {dtype}, the shard "
                         f"holds {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr))


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Optional[Future] = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree, async_: bool = False):
        # copy to host memory first: the caller goes on writing its
        # tensors in place while an async write runs
        host = {k: self._to_host_shards(v)
                for k, v in _leaf_paths(tree).items()}
        self.wait()     # join (and clear) the previous async write —
        # a failure re-raises HERE once, not again at teardown
        if async_:
            self._inflight = self._pool.submit(self._write, step, host)
        else:
            self._write(step, host)

    @staticmethod
    def _to_host_shards(leaf):
        dtype, arr = _host_array(leaf)
        return {"shape": list(arr.shape), "dtype": dtype,
                "shards": [([(0, d) for d in arr.shape], arr)]}

    def _write(self, step: int, host_tree):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {}
        for key, rec in host_tree.items():
            safe = key.replace("/", "__")
            index[key] = {"shape": rec["shape"], "dtype": rec["dtype"],
                          "shards": []}
            for i, (spans, arr) in enumerate(rec["shards"]):
                fname = f"{safe}.s{i}.npy"
                np.save(os.path.join(tmp, fname), arr)
                index[key]["shards"].append({"spans": spans,
                                             "file": fname})
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            # tolerate stray entries (step_backup, step_old_3, ...):
            # one unparsable name must not kill restore discovery
            tail = name[len("step_"):]
            if not tail.isdigit():
                continue
            if os.path.exists(os.path.join(self.dir, name,
                                           "_COMPLETE")):
                out.append(int(tail))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree):
        """Copy the leaves saved at ``step`` into the tensors of
        ``target_tree`` in place (``copy_``: a target keeps its device,
        storage and strides) and return ``target_tree``.  Each target
        must have its saved leaf's shape and dtype (``ValueError``
        otherwise)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        for key, tgt in _leaf_paths(target_tree).items():
            if key not in index:
                raise KeyError(f"{d} holds no leaf {key!r}")
            rec = index[key]
            shape = tuple(rec["shape"])
            if shape != tuple(tgt.shape):
                raise ValueError(f"{key}: saved shape {shape}, target "
                                 f"{tuple(tgt.shape)}")
            dtype = _torch_dtype(rec["dtype"])
            if dtype != tgt.dtype:
                raise ValueError(f"{key}: saved dtype {rec['dtype']}, "
                                 f"target {_dtype_name(tgt.dtype)}")
            buf = torch.empty(shape, dtype=dtype)
            for shard in rec["shards"]:
                idx = tuple(slice(a, b) for a, b in shard["spans"])
                buf[idx] = _read_shard(os.path.join(d, shard["file"]),
                                       rec["dtype"])
            tgt.copy_(buf)
        return target_tree

    def wait(self):
        """Join the in-flight async save, re-raising its exception —
        without this, a failed background write would surface only on
        the NEXT ``save()`` (or never, at the end of a run).  Call it
        at run end and from snapshot-cadence teardown; idempotent."""
        if self._inflight is not None:
            try:
                self._inflight.result()
            finally:
                self._inflight = None
