"""Process meshes for the distributed solvers, on torch.distributed:
spherical_bundle_adjuster_tpu/parallel/mesh.py.

The JAX package lays a `jax.sharding.Mesh` over devices and runs one
program over all of them (`shard_map`), `psum`-reducing camera-level
aggregates over a mesh axis. Here the model is SPMD over processes:
every rank runs the same entry point on the whole input, a mesh is a
grid of ranks with named axes, each line of the grid along an axis is one
process group, and a `psum` over an axis is an `all_reduce` over this
rank's group on that axis (`Axis`).

Without an initialised process group every mesh has one rank and its
collectives are the identity, so single-process callers need nothing
else. Ranks with a card each take the NCCL backend; ranks that share one
card take gloo (NCCL refuses two ranks on one device), which stages CUDA
tensors through the host.
"""

from __future__ import annotations

import collections
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# the process groups' default timeout: a collective that one rank never
# joins fails after it instead of hanging
DEFAULT_TIMEOUT = timedelta(seconds=300)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(ranks_per_host: int) -> str:
    """"nccl" where every rank of a host can have a card of its own, else
    "gloo" (ranks that share a card, or no card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> int:
    """Join this process to the job's process group; returns its rank.

    coordinator_address is "host:port" (a TCP store on rank 0's host) or
    an init-method URL ("tcp://...", "file://..."), given with
    num_processes and process_id. With none of the three, torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and
    LOCAL_RANK / LOCAL_WORLD_SIZE where set) names them; without it the
    process stays single-process and this returns 0, as the JAX package's
    does. Idempotent.

    backend: "nccl" or "gloo"; None takes default_backend (NCCL where every
    rank of the host has its own card, gloo where ranks share one). A
    failure raises: there is no quiet switch to another backend. With a
    card, each rank first selects card local_rank % device_count.
    timeout: how long a collective waits for every rank of its group."""
    if dist.is_initialized():
        return dist.get_rank()
    given = (coordinator_address, num_processes, process_id)
    local_rank = local_world = None
    if all(v is None for v in given):
        env = os.environ
        if not all(k in env for k in _TORCHRUN_ENV):
            return 0  # no job environment: stay single-process
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", process_id))
        local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    elif any(v is None for v in given):
        raise ValueError("init_distributed: give coordinator_address, num_processes and "
                         "process_id together, or none of them")
    local_rank = process_id if local_rank is None else local_rank
    local_world = num_processes if local_world is None else local_world
    backend = default_backend(local_world) if backend is None else backend
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = {}
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timeout, **kw)
    return dist.get_rank()


class Axis:
    """One mesh axis as this rank sees it: the global ranks on this rank's
    line of the grid along the axis (`ranks`), this rank's index among
    them, the process group over them (None: one rank, no process group,
    collectives are the identity), and the collectives over that group.

    `traffic` counts what the collectives were handed: (collective, bytes
    per call) -> calls."""

    def __init__(self, name: str, ranks, group, index: int):
        self.name = name
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        self.traffic = collections.Counter()

    def _count(self, op, x):
        self.traffic[op, x.numel() * x.element_size()] += 1

    def bytes(self, op: str = "all_reduce") -> int:
        """The bytes handed to collective `op` since the last reset."""
        return sum(b * n for (o, b), n in self.traffic.items() if o == op)

    def calls(self, op: str = "all_reduce") -> int:
        return sum(n for (o, _), n in self.traffic.items() if o == op)

    def reset(self):
        self.traffic.clear()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the axis, on every rank of it (the JAX
        package's psum). Reduces x in place where x is contiguous: pass a
        tensor that nothing else reads."""
        self._count("all_reduce", x)
        if self.group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (equal shapes, at least one axis), concatenated
        along the leading axis in the axis's rank order, on every rank."""
        self._count("all_gather", x)
        if self.group is None:
            return x
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts)
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The axis's first rank's x, on every rank of the axis (x itself
        on the first rank)."""
        self._count("broadcast", x)
        if self.group is None:
            return x
        t = x.contiguous() if self.index == 0 else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        dist.broadcast(t, src=self.ranks[0], group=self.group)
        return t


class Mesh:
    """A grid of ranks with named axes (the JAX package's Mesh, over
    processes): `ranks` holds the global ranks, `shape` maps each axis
    name to its size, `coords` this rank's index on each axis (None for a
    rank outside the mesh), and `axis(name)` this rank's Axis."""

    def __init__(self, ranks: np.ndarray, axis_names, axes: dict):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self._axes = axes

    @property
    def coords(self):
        if not self._axes:
            return None
        return {name: self._axes[name].index for name in self.axis_names}

    def axis(self, name: str) -> Axis:
        if name not in self.shape:
            raise KeyError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        if not self._axes:
            raise ValueError("this rank is not in the mesh")
        return self._axes[name]


def _world():
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(grid: np.ndarray, axis_names, timeout) -> Mesh:
    """The Mesh over `grid`. Every rank creates every axis's groups, each
    line of the grid along each axis in the same order, groups it is not
    in included: new_group is collective over the whole job."""
    _, me = _world()
    axes = {}
    for k, name in enumerate(axis_names):
        for line in np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k]):
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks, timeout=timeout) if dist.is_initialized() else None
            if me in ranks:
                axes[name] = Axis(name, ranks, group, ranks.index(me))
    return Mesh(grid, axis_names, axes)


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """1-D mesh over the first n_devices ranks (all by default). Every
    rank of the job calls it; ranks past n_devices are outside the mesh."""
    world, _ = _world()
    n = world if n_devices is None else n_devices
    assert n <= world, f"mesh of {n} ranks, have {world}"
    return _mesh(np.arange(n), (axis_name,), timeout)


def make_mesh_2d(
    n_pairs: int,
    n_landmarks: int | None = None,
    axis_names: tuple[str, str] = ("pairs", "data"),
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """2-D mesh (pairs x landmarks): the outer axis shards independent
    problems or pairs (no collectives between them), the inner axis each
    problem's landmark table (all-reduced camera aggregates). Contiguous
    ranks form the inner axis, so that the per-step all-reduces stay
    between ranks on one host (the JAX package lays it over ICI). Every
    rank of the job calls it."""
    world, _ = _world()
    if n_landmarks is None:
        n_landmarks = world // n_pairs
    assert n_pairs * n_landmarks <= world, (
        f"mesh {n_pairs}x{n_landmarks} needs {n_pairs * n_landmarks} ranks, have {world}")
    grid = np.arange(n_pairs * n_landmarks).reshape(n_pairs, n_landmarks)
    return _mesh(grid, axis_names, timeout)


def shard_leading(mesh: Mesh, x: torch.Tensor, axis_name: str = "data") -> torch.Tensor:
    """This rank's contiguous block of x's leading axis, split evenly over
    the mesh axis: the counterpart of the JAX package's NamedSharding
    P(axis_name), which places the blocks on devices; under SPMD over
    processes each rank holds the whole x and keeps its own block."""
    axis = mesh.axis(axis_name)
    n = x.shape[0]
    if n % axis.size:
        raise ValueError(f"leading axis {n} does not divide by the {axis_name!r} axis "
                         f"of {axis.size} ranks")
    k = n // axis.size
    return x[axis.index * k:(axis.index + 1) * k]


def replicated(mesh: Mesh, x: torch.Tensor, axis_name: str = "data") -> torch.Tensor:
    """x as the mesh axis's first rank holds it, on every rank of the axis:
    the counterpart of the JAX package's replicated NamedSharding P(), which
    copies one array to every device; under SPMD over processes every rank
    passes its own x and this makes them one (a broadcast), so that
    replicated state starts bit-identical on every rank."""
    return mesh.axis(axis_name).broadcast(x)
