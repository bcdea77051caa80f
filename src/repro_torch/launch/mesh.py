"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``repro.launch.mesh``.  The JAX package is
single-controller: one process holds every device of a ``jax.sharding.
Mesh`` and ``shard_map`` runs a function on each.  The port is
multi-controller: one process per mesh position, each holding its own
block of every sharded tensor, with explicit collectives over one
process group per mesh axis.  ``Mesh`` carries what the sharding
vocabulary (``dist.sharding``) reads from a JAX mesh (``axis_names`` and
the ``shape`` dict) plus this rank's coordinate on each axis, the axis
groups and the device.

    mesh = make_local_mesh(1, 2)           # inside a world of 2 ranks
    run_ranks(fn, 1, 2, device="cuda")     # spawns that world, fn(mesh)
    pipe = make_mesh({"pipe": 2})          # the same ranks, other axes

``make_mesh`` is the counterpart of ``jax.make_mesh``: any axis names,
row-major over the world's ranks; ``make_local_mesh(data, model)`` is
its ``(data, model)`` case.

Transport: ranks that share a GPU cannot use NCCL (it refuses two ranks
on one device), so they use ``gloo``, whose all-reduce, reduce-scatter,
all-gather and broadcast take CUDA tensors by staging them through the
host; ranks with a GPU each use ``nccl``.  ``transport`` picks by the
world size against ``torch.cuda.device_count()``; the tensors and the
kernels stay on the card either way.  A mesh's ``repr`` names its
transport.  gloo's point-to-point send and receive do not take CUDA
tensors (they hand the device pointer to the socket), so
``Mesh.exchange`` copies through the host itself when the transport is
gloo and the tensors are on a card (``_host_staged``, decided by the
transport alone).

``make_local_mesh`` raises unless the world has exactly ``data * model``
ranks, where the JAX function silently falls back to ``(n, 1)``: a
smaller mesh than the one asked for would serve a different layout
without saying so.
"""
from __future__ import annotations

import datetime
import math
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 120.0


class Mesh:
    """A mesh of ranks, or an abstract one (no groups).

    ``shape`` is an ordered {axis: size} dict, as ``jax.sharding.Mesh.
    shape`` is; ``coords`` this rank's index on each axis; ``groups`` one
    process group per axis of more than one rank (the ranks that differ
    only on that axis) and ``peers`` the world ranks of that group in
    coordinate order."""

    def __init__(self, shape: Dict[str, int], coords=None, groups=None,
                 device=None, transport: Optional[str] = None,
                 peers=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = dict(coords or {})
        self.groups = dict(groups or {})
        self.peers = dict(peers or {})
        self.device = device
        self.transport = transport

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def fold(self, axis: str) -> "Mesh":
        """This mesh with ``axis`` folded to one rank: the layout of
        blocks that are whole along ``axis`` (replicated over it)."""
        return Mesh({**self.shape, axis: 1}, {**self.coords, axis: 0},
                    {a: g for a, g in self.groups.items() if a != axis},
                    self.device, self.transport,
                    {a: r for a, r in self.peers.items() if a != axis})

    def __repr__(self):
        where = ("abstract" if not self.coords else
                 f"at {self.coords} on {self.device}, {self.transport}")
        return f"Mesh({self.shape}, {where})"

    # ------------------------------------------------------------------
    # collectives over one axis, or over a tuple of axes (a spec entry's;
    # identities on an axis of one rank)
    # ------------------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` reduced over ``axis`` (a name or a tuple of names) in
        place ('sum' or 'max'); every rank of the axes gets the same
        bits."""
        for a in _axes(axis):
            if self.axis_size(a) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                                else dist.ReduceOp.SUM,
                                group=self.groups[a])
        return t

    def all_gather(self, t: torch.Tensor, axis, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order; over a tuple of axes, in the order of the block
        index (row-major over them, the innermost varying fastest)."""
        for a in reversed(_axes(axis)):
            n = self.axis_size(a)
            if n == 1:
                continue
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=self.groups[a])
            t = torch.cat(parts, dim)
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0
                       ) -> torch.Tensor:
        """``t`` summed over ``axis``, and of the sum this rank's block
        along ``dim`` (``t.shape[dim]`` split evenly, in coordinate
        order), as a tensor of its own.  gloo and nccl both take CUDA
        tensors for it (gloo staging them through the host)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        parts = [p.contiguous() for p in t.chunk(n, dim)]
        out = torch.empty_like(parts[self.coord(axis)])
        dist.reduce_scatter(out, parts, group=self.groups[axis])
        return out

    def exchange(self, axis: str, send: Optional[torch.Tensor] = None,
                 to: Optional[int] = None,
                 recv: Optional[torch.Tensor] = None,
                 frm: Optional[int] = None) -> Optional[torch.Tensor]:
        """Send ``send`` to coordinate ``to`` of ``axis`` and receive into
        ``recv`` from coordinate ``frm``, in one batch of point-to-point
        operations (every rank of the axis posts its pair together, so
        no order of ranks deadlocks); either half may be left out.
        Returns ``recv``."""
        staged = _host_staged(self)
        ops = []
        if send is not None:
            buf = send.cpu() if staged else send.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self.peers[axis][to],
                                  self.groups[axis]))
        if recv is not None:
            rbuf = torch.empty_like(recv, device="cpu") if staged else recv
            ops.append(dist.P2POp(dist.irecv, rbuf, self.peers[axis][frm],
                                  self.groups[axis]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if recv is not None and staged:
            recv.copy_(rbuf)
        return recv

    def gather_objects(self, obj) -> list:
        """``obj`` of every rank of the whole mesh, in rank order (host
        objects: tests and checks, not the serving path)."""
        if self.size == 1 or not dist.is_initialized():
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract (16, 16) or (2, 16, 16) mesh: the sharding
    vocabulary's shapes, with no ranks behind it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def transport(world: int, device) -> str:
    """'nccl' when every rank has a GPU of its own, else 'gloo' (ranks on
    the CPU, or sharing a GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    from repro_torch.common.module import resolve_device
    resolve_device(dev)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _host_staged(mesh) -> bool:
    """True when ``mesh``'s point-to-point operations would hand CUDA
    tensors to gloo, whose send / receive take host memory only: the one
    place ``Mesh.exchange`` decides by its transport to copy through the
    host."""
    return (mesh.transport == "gloo" and mesh.device is not None
            and mesh.device.type == "cuda")


def make_mesh(shape: Dict[str, int], *, device="cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of this process's ``torch.distributed`` world with axes
    ``shape`` (an ordered {name: size} dict; the counterpart of
    ``jax.make_mesh``): rank r sits at r unravelled row-major over the
    sizes.  Needs an initialized world of exactly ``prod(sizes)`` ranks
    (a single process without a world is the one-rank mesh) and raises
    otherwise.  Every rank must call it, in the same order as its other
    group creations: each axis group is created collectively, and a
    collective on it that waits longer than ``timeout_s`` for its peers
    raises.  One world can build several meshes (a ``{"data": 2}`` and a
    ``{"pipe": 2}`` over the same two ranks)."""
    shape = {a: int(n) for a, n in shape.items()}
    n = math.prod(shape.values())
    what = f"a mesh of {shape}"
    if not dist.is_initialized():
        if n == 1:
            return Mesh(shape, {a: 0 for a in shape},
                        device=_rank_device(device, 0))
        raise RuntimeError(
            f"{what} needs a torch.distributed world of {n} ranks, and "
            "none is initialized: start the ranks with "
            "launch.mesh.run_ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"{what} needs a world of {n} ranks, this one "
                         f"has {world}")
    axes = list(shape)
    strides = {a: math.prod(shape[b] for b in axes[i + 1:])
               for i, a in enumerate(axes)}
    coords = {a: (rank // strides[a]) % shape[a] for a in axes}
    groups, peers = {}, {}
    timeout = datetime.timedelta(seconds=timeout_s)
    # every rank creates every group of every axis, in one order
    for a in axes:
        if shape[a] == 1:
            continue
        for base in range(n):
            if (base // strides[a]) % shape[a]:
                continue            # not the first rank of its group
            ranks = [base + i * strides[a] for i in range(shape[a])]
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[a], peers[a] = g, ranks
    return Mesh(shape, coords, groups, device=_rank_device(device, rank),
                transport=dist.get_backend(), peers=peers)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda",
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The (data, model) mesh of this process's ``torch.distributed``
    world: rank r sits at (r // model, r % model) (``make_mesh``'s
    ``{"data": data, "model": model}``); raises unless the world has
    exactly ``data * model`` ranks."""
    return make_mesh({"data": data, "model": model}, device=device,
                     timeout_s=timeout_s)


# ----------------------------------------------------------------------
# spawning a world
# ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, shape, device, backend, timeout_s,
               threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(shape, device=device, timeout_s=timeout_s)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = fn(mesh, *args)
        # no rank leaves while another may still be in a collective
        dist.barrier()
        # by value (the plain pickler), not torch's shared-memory handles,
        # which die with this process before the parent may read them
        results.put((rank, "ok", pickle.dumps(out) if rank == 0 else None))
    except BaseException:                              # noqa: BLE001
        # the process boundary: report the traceback to the parent, which
        # raises it, before the group closes under the other ranks; then
        # exit non-zero
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, data: Union[int, Dict[str, int]] = 1,
              model: int = 1, *, args: Sequence[Any] = (), device="cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S,
              threads: Optional[int] = None) -> Any:
    """Spawn a world of ``data * model`` ranks on ``device``, run
    ``fn(mesh, *args)`` on each, and return rank 0's result.  ``data``
    may be a shape dict instead (``run_ranks(fn, {"pipe": 2})``), whose
    ``make_mesh`` each rank then gets.

    ``fn`` and ``args`` go to the ranks by pickle (``fn`` by import path)
    and rank 0's result comes back pickled by value (its tensors copied,
    so they outlive the rank).  The ranks talk over ``transport(world,
    device)``; ``threads`` sets each rank's ``torch.set_num_threads`` (on
    the CPU by default this process's threads over the ranks).  A rank that
    raises fails the run with its traceback; a collective that never
    completes raises in its ranks after ``timeout_s`` (the groups'
    timeout), and a world that has not finished by then plus a margin is
    terminated and raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    shape = (dict(data) if isinstance(data, dict)
             else {"data": data, "model": model})
    world = math.prod(shape.values())
    backend = transport(world, device)
    if threads is None and torch.device(device).type == "cpu":
        # ranks on the CPU share its cores
        threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, shape, str(device),
                               backend, timeout_s, threads, fn, tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    done: Dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + 2 * timeout_s + 60
    try:
        while len(done) < world and error is None:
            try:
                rank, status, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done]
                if dead:
                    # let the rank's own report arrive, if it sent one
                    time.sleep(1.0)
                    if results.empty():
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the {shape} world did not finish within "
                        f"{2 * timeout_s + 60:.0f} s")
                continue
            if status == "error":
                error = f"rank {rank} raised:\n{out}"
                # the other ranks' reports follow (a peer's collective
                # fails once this rank has gone): keep them, after it
                time.sleep(1.0)
                while not results.empty():
                    rank, status, out = results.get()
                    if status == "error":
                        error += f"\nrank {rank} raised:\n{out}"
            else:
                done[rank] = out if out is None else pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=10 if error is None else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    if error is not None:
        raise RuntimeError(f"run_ranks({fn.__name__}, {shape}): {error}")
    return done[0]

