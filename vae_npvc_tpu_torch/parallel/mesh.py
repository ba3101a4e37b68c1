"""Meshes of named axes over processes, and multi-process start-up.

Counterpart of ``vae_npvc_tpu/parallel/mesh.py``. A JAX mesh names the
axes of an array of devices that one program drives; here one process
drives one device, and a :class:`Mesh` gives this process its coordinates
on each named axis and one ``torch.distributed`` process group per axis
(the ranks that differ from this one only along that axis). Ranks are laid
out row-major over the axes, so on a ``("data", "model")`` mesh rank
``r`` sits at ``(r // n_model, r % n_model)``.

:func:`data_mesh` is the other kind: a :class:`LocalMesh` of devices that
one process drives, one model replica each (the serving path).

Without an initialized process group a mesh has one rank and its
collectives return their input (``comm``).
"""

from __future__ import annotations

import math
import os

import torch

from ..utils.device import resolve_device


class Axis:
    """One named axis as this rank sees it: its size, this rank's index
    on it, the global ranks along it in index order, and the process
    group (None for a mesh of one process)."""

    def __init__(self, name, size, index, ranks, group, backend):
        self.name, self.size, self.index = name, int(size), int(index)
        self.ranks, self.group, self.backend = list(ranks), group, backend

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, index={self.index}, "
                f"backend={self.backend})")


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis names to sizes, in row-major order (the last axis
    varies fastest); their product must be the world size. Every rank
    builds the same mesh: the groups are created in one order on all of
    them, as ``torch.distributed.new_group`` requires.
    """

    def __init__(self, shape):
        import torch.distributed as dist

        self.shape = {str(k): int(v) for k, v in dict(shape).items()}
        self.axis_names = tuple(self.shape)
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        self.rank = dist.get_rank() if initialized else 0
        self.backend = dist.get_backend() if initialized else None
        if math.prod(self.shape.values()) != world:
            raise ValueError(
                "mesh " + "x".join(str(v) for v in self.shape.values())
                + f" != {world} devices")
        self.size = world
        sizes = list(self.shape.values())
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        coords = [(self.rank // s) % n for s, n in zip(strides, sizes)]
        self.coords = dict(zip(self.axis_names, coords))
        self.axes = {}
        for a, name in enumerate(self.axis_names):
            mine = None
            # every line along axis a, in the order of the other coordinates
            others = [i for i in range(len(sizes)) if i != a]
            for flat in range(world // sizes[a]):
                fixed, rest = {}, flat
                for i in reversed(others):
                    fixed[i] = rest % sizes[i]
                    rest //= sizes[i]
                ranks = [sum((k if i == a else fixed[i]) * strides[i]
                             for i in range(len(sizes)))
                         for k in range(sizes[a])]
                group = dist.new_group(ranks) if initialized else None
                if self.rank in ranks:
                    mine = (ranks, group)
            self.axes[name] = Axis(name, sizes[a], coords[a], mine[0],
                                   mine[1], self.backend)

    def axis(self, name):
        if name not in self.axes:
            raise ValueError(f"mesh has no axis {name!r}; axes: "
                             f"{self.axis_names}")
        return self.axes[name]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"


def make_mesh(n_data=None, n_model=1):
    """A ``("data", "model")`` mesh over the world's ranks, with the JAX
    package's errors on sizes that do not divide it."""
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if n_data is None:
        if world % n_model != 0:
            raise ValueError(
                f"{world} devices not divisible by n_model={n_model}"
                " — a silent truncation would idle the remainder")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    return Mesh({"data": n_data, "model": n_model})


class LocalMesh:
    """Devices driven by one process along one ``data`` axis: one model
    replica per device (``infer/convert.Converter(mesh=...)``). A device
    may appear more than once (two replicas on one card)."""

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"data": len(self.devices)}
        self.axis_names = ("data",)

    def __repr__(self):
        return f"LocalMesh({[str(d) for d in self.devices]})"


def data_mesh(devices=None):
    """1-axis mesh of local devices; all visible CUDA devices by default
    (raises without a GPU)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return LocalMesh(devices)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, backend="nccl"):
    """Join the default process group; returns ``(rank, world_size)``.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the rendezvous is ``tcp://`` at that address; without,
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) is read. ``backend`` is ``"nccl"`` for CUDA tensors or
    ``"gloo"`` for the CPU; it is used as given. A process already in a
    group returns its coordinates.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                f"initialize_multihost: no coordinator_address and {missing}"
                " not in the environment (launch with torchrun, or pass "
                "coordinator_address, num_processes and process_id)")
        dist.init_process_group(backend, init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    return dist.get_rank(), dist.get_world_size()


def local_cuda_device():
    """The card of this process: ``LOCAL_RANK`` modulo the visible cards."""
    resolve_device("cuda")
    return torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", 0))
        % torch.cuda.device_count())
