"""Sharding hint helpers (counterpart of ``repro.common.hints``).

The JAX package is single-controller: one program sees every tensor
whole, and ``with_sharding_constraint`` asks GSPMD to lay a tensor out
over the mesh.  The port is multi-controller: one process a mesh
position, each holding its own block (``launch.mesh``).  So a layout
constraint on a tensor that every rank holds whole becomes "keep my
block": ``shard_hint`` and ``shard_batch`` return this rank's block
(``dist.sharding.local_block``) where the JAX helper would constrain,
and the tensor itself where it would not.

Every helper takes the mesh as an explicit argument.  The port has no
ambient ``with mesh:`` context, so ``ambient_mesh`` is always None and
``resolve_mesh`` returns the mesh it is given.  ``shard_hint`` makes the
MoE's dispatch cut (``models.moe``).  ``ambient_mesh``, ``resolve_mesh``
and ``shard_batch`` have no caller in the port and are kept for the
JAX module's signatures: the engine cuts its rows by the block it works
out once from the batch specs (``DecodeEngine.rows``).
"""
from __future__ import annotations

import math

from repro_torch.dist.sharding import PS, _flat, local_block


def ambient_mesh():
    """None: the port has no ambient mesh context."""
    return None


def resolve_mesh(mesh, context: str = ""):
    """The explicit mesh (``context`` names the caller, as in JAX, where
    an ambient fallback would warn; here there is none)."""
    return mesh


def _splits(x, spec, mesh) -> bool:
    """Whether ``mesh`` has every axis ``spec`` names and each split dim
    of ``x`` divides over its axes (the layouts ``local_block`` cuts;
    JAX's constraint fails, and its helper returns ``x``, otherwise)."""
    names = set(mesh.axis_names) if mesh is not None else set()
    need = {a for e in spec for a in _flat(e)}
    if not need or not need.issubset(names):
        return False
    return all(x.shape[d] % math.prod(mesh.shape[a] for a in _flat(e)) == 0
               for d, e in enumerate(spec) if e is not None)


def shard_hint(x, spec, mesh=None):
    """This rank's block of ``x`` (held whole on every rank) under
    ``spec`` when the mesh has every axis the spec names, else ``x``."""
    if not _splits(x, spec, mesh):
        return x
    return local_block(x, spec, mesh)


def shard_batch(x, ndim=None, extra=None, mesh=None):
    """This rank's rows of ``x`` (dim 0 over the data axes present in the
    mesh, when they divide it), else ``x``; the other dims (``ndim`` of
    them in all, ``x.ndim`` by default) stay whole.  ``extra`` is unused,
    as in the JAX helper."""
    if mesh is None:
        return x
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not dp:
        return x
    n = ndim or x.ndim
    spec = PS(dp if len(dp) > 1 else dp[0], *([None] * (n - 1)))
    return shard_hint(x, spec, mesh)
